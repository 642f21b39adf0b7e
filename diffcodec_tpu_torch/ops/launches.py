"""The kernels' launch counts: each wrapper's `launches` attribute, which
it adds one to where it launches its kernel."""

from __future__ import annotations

from typing import Callable, Dict, Tuple


def kernel_wrappers() -> Dict[str, object]:
    """Each kernel's wrapper (the holder of its `launches`), by kernel."""
    from diffcodec_tpu_torch.ops import attention as att
    from diffcodec_tpu_torch.ops import conv
    from diffcodec_tpu_torch.ops.softsplat import splat_sum
    return {"attention": att.attention, "attention_bwd": att.attention_bwd,
            "splat_sum": splat_sum, "gn_silu_conv3x3": conv.gn_silu_conv3x3,
            "conv3x3_head": conv.projected_head,
            "silu_conv3x3": conv.silu_conv3x3,
            "upsample_conv3x3": conv.upsample_conv3x3,
            "downsample_conv3x3": conv.downsample_conv3x3}


def count_launches(fn: Callable) -> Tuple[object, Dict[str, int]]:
    """(fn(), the launches of each kernel during it): every count set to 0
    just before the call and read just after."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {k: w.launches for k, w in wrappers.items()}
