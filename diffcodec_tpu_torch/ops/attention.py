"""Exact softmax attention and its gradient: the CUDA kernels and their plain
version.

Counterparts: `diffcodec_tpu/ops/attention.py::fused_attention` and
`diffcodec_tpu/models/layers.py::_flash_self_attention`, the two TPU kernels
that computed the model's attention, and the stock Pallas flash backward
that training reaches through the latter
(`jax/experimental/pallas/ops/tpu/flash_attention.py`:
`_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`).  Here
`csrc/attention.cu` holds two kernels: the forward, which serves every
self- and cross-attention call of the UNet and the ControlNet and, when a
gradient is wanted, also writes each row's log-sum-exp; and the backward,
one kernel for dQ, dK and dV, which recomputes the probabilities from it
once per tile (launched between a pass that computes rowsum(dout * out)
and a pass that rounds dQ to bf16).

Layout at this boundary: q [BH, Lq, D], k and v [BH, Lk, D] (heads folded
into the batch), the form the kernels read.
"""

from __future__ import annotations

import torch

from diffcodec_tpu_torch import _kernels

# head widths the kernels are built for: the UNet's (40, 80, 160) and the
# tiny configs' (16, 32)
KERNEL_HEAD_DIMS = (16, 32, 40, 80, 160)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain version: einsum logits in fp32, fp32 softmax, einsum with v.

    The probabilities are cast to v's dtype before the second product, as
    the JAX package does (bf16 operands, fp32 softmax)."""
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", probs, v)


def _check(name: str, Lk: int, **tensors):
    """Raise unless every tensor lies on q's CUDA device, contiguous and
    16-byte aligned, with its dtype and shape: bf16 [BH, Lq, D] (q, out,
    dout) or [BH, Lk, D] (k, v), fp32 [BH, Lq] (lse).  Returns BH, Lq,
    D."""
    q = tensors["q"]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    BH, Lq, D = q.shape
    for label, t in tensors.items():
        if label == "lse":
            dtype, shape = torch.float32, (BH, Lq)
        else:
            dtype = torch.bfloat16
            shape = (BH, Lk, D) if label in ("k", "v") else (BH, Lq, D)
        if t.device != q.device:
            raise ValueError(f"{name}: {label} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and "
                             "16-byte aligned")
    if D not in KERNEL_HEAD_DIMS or Lk < 1:
        raise ValueError(f"{name}: needs D in {KERNEL_HEAD_DIMS} and "
                         f"Lk >= 1, got D={D}, Lk={Lk}")
    return BH, Lq, D


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, with_lse: bool = False):
    """(out, lse): one launch of the forward kernel (bf16, contiguous, D in
    `KERNEL_HEAD_DIMS`, scale > 0) on q's CUDA device, or raises; lse is
    the fp32 [BH, Lq] natural-log log-sum-exp of the scaled logits where
    asked for, else None.  `attention.launches` counts the launches."""
    BH, Lq, D = _check("attention", k.shape[1], q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = (torch.empty(BH, Lq, device=q.device, dtype=torch.float32)
           if with_lse else None)
    lib = _kernels.lib()
    with torch.cuda.device(q.device):
        code = lib.dc_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, Lq, k.shape[1], D,
            float(scale), _kernels.stream_ptr(q.device))
    _kernels.check(code, "dc_attention_fwd")
    attention.launches += 1
    return out, lse


def attention_bwd(q, k, v, out, dout, lse, scale: float):
    """(dq, dk, dv) of `out = attention_forward(q, k, v, scale)`, given its
    lse: one launch of the backward kernel on q's CUDA device, or raises.
    The same C call first computes delta = rowsum(dout * out) in fp32 and
    zeroes an fp32 dQ buffer, into which the kernel adds each block's dQ by
    bulk reductions (so dq's last bits vary from run to run; dk and dv do
    not), and then rounds that buffer to bf16.  `attention_bwd.launches`
    counts the launches."""
    BH, Lq, D = _check("attention_bwd", k.shape[1], q=q, k=k, v=v, out=out,
                       dout=dout, lse=lse)
    delta = torch.empty(BH, Lq, device=q.device, dtype=torch.float32)
    dq_acc = torch.empty(BH, Lq, D, device=q.device, dtype=torch.float32)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _kernels.lib()
    with torch.cuda.device(q.device):
        code = lib.dc_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, Lq, k.shape[1], D, float(scale),
            _kernels.stream_ptr(q.device))
    _kernels.check(code, "dc_attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


attention_bwd.launches = 0


def attention_backward(q, k, v, out, lse, dout, scale: float):
    """(dq, dk, dv) on the card, from what the forward saved and the
    incoming gradient (made contiguous): `attention_bwd`."""
    return attention_bwd(q, k, v, out, dout.contiguous(), lse, scale)


class _Attention(torch.autograd.Function):
    """The kernels on a CUDA tensor; on a CPU tensor the plain version,
    whose gradient the backward recomputes by autograd."""

    @staticmethod
    def forward(ctx, q, k, v, scale, with_grad):
        ctx.scale = scale
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return attention_reference(q, k, v, scale)
        out, lse = attention_forward(q, k, v, scale, with_lse=with_grad)
        if with_grad:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors  # unpacked once (activation checkpointing)
        if len(saved) == 3:
            q, k, v = (t.detach().requires_grad_() for t in saved)
            with torch.enable_grad():
                out = attention_reference(q, k, v, ctx.scale)
            grads = torch.autograd.grad(out, (q, k, v), dout)
        else:
            grads = attention_backward(*saved, dout, ctx.scale)
        return (*grads, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per batch*head, differentiable.

    On a CPU tensor this is `attention_reference`, and so is its gradient.
    On a CUDA tensor the forward kernel runs on q's device (bf16,
    contiguous, D in `KERNEL_HEAD_DIMS`) or raises, saving the row
    log-sum-exp where a gradient is wanted; the backward runs the backward
    kernel.  `attention.launches` counts the forward launches.
    """
    with_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return _Attention.apply(q, k, v, scale, with_grad)


attention.launches = 0
