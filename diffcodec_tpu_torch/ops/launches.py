"""The kernels' launch counts: each wrapper's `launches` attribute, which
it adds one to where it launches its kernel; and, where asked, the shape
arguments that each C entry received."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from diffcodec_tpu_torch import _kernels


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


class _RecordedLibrary:
    """The loaded kernel library, each entry's integer arguments (its
    shape, and a mode where it takes one: the ints of its row in
    `_kernels._SIGNATURES`) recorded before it runs."""

    def __init__(self, real, calls: Dict[str, List[tuple]]):
        self._real, self._calls = real, calls

    def __getattr__(self, name):
        fn = getattr(self._real, name)
        ints = [i for i, t in enumerate(_kernels._SIGNATURES.get(name, ()))
                if t is _kernels._I]
        if not ints:
            return fn

        def call(*args):
            self._calls.setdefault(name, []).append(
                tuple(args[i] for i in ints))
            return fn(*args)
        return call


def recorded_launches(fn: Callable
                      ) -> Tuple[object, Dict[str, int], Dict[str, list]]:
    """(fn(), its launches as `count_launches` counts them, {C entry: [the
    integer arguments of each call]}): the library wrapped for the call's
    length (built first, where it is not yet)."""
    real = _kernels.lib()
    calls: Dict[str, List[tuple]] = {}
    _kernels.LIBRARY._lib = _RecordedLibrary(real, calls)
    try:
        out, launches = count_launches(fn)
    finally:
        _kernels.LIBRARY._lib = real
    return out, launches, calls
