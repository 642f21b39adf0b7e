"""Exact softmax attention: the CUDA kernel and its plain version.

Counterparts: `diffcodec_tpu/ops/attention.py::fused_attention` and
`diffcodec_tpu/models/layers.py::_flash_self_attention`, the two TPU kernels
that computed the model's attention.  Here one kernel
(`csrc/attention.cu`) serves every self- and cross-attention call of the
UNet and the ControlNet.

Layout at this boundary: q [BH, Lq, D], k and v [BH, Lk, D] (heads folded
into the batch), the form the kernel reads.
"""

from __future__ import annotations

import torch

from diffcodec_tpu_torch import _kernels

# head widths the kernel is built for: the UNet's (40, 80, 160) and the tiny
# configs' (16, 32)
KERNEL_HEAD_DIMS = (16, 32, 40, 80, 160)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain version: einsum logits in fp32, fp32 softmax, einsum with v.

    The probabilities are cast to v's dtype before the second product, as
    the JAX package does (bf16 operands, fp32 softmax)."""
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per batch*head.

    On a CPU tensor this is `attention_reference`.  On a CUDA tensor it
    launches `csrc/attention.cu` on q's device (bf16, contiguous, D in
    `KERNEL_HEAD_DIMS`) or raises; `attention.launches` counts the
    launches.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    for name, t, shape in (("q", q, (BH, Lq, D)), ("k", k, (BH, Lk, D)),
                           ("v", v, (BH, Lk, D))):
        if t.device != q.device:
            raise ValueError(f"attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention: {name} must be bfloat16, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"attention: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"attention: {name} must be contiguous and "
                             "16-byte aligned")
    if D not in KERNEL_HEAD_DIMS or Lk < 1:
        raise ValueError(f"attention: needs D in {KERNEL_HEAD_DIMS} and "
                         f"Lk >= 1, got D={D}, Lk={Lk}")
    out = torch.empty_like(q)
    lib = _kernels.lib()
    with torch.cuda.device(q.device):
        code = lib.dc_attention_fwd(q.data_ptr(), k.data_ptr(),
                                    v.data_ptr(), out.data_ptr(), BH, Lq, Lk,
                                    D, float(scale),
                                    _kernels.stream_ptr(q.device))
    _kernels.check(code, "dc_attention_fwd")
    attention.launches += 1
    return out


attention.launches = 0
