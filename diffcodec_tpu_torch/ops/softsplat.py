"""Softmax splatting (forward warp) and the bilinear backward warp, NHWC.

Counterpart: `diffcodec_tpu/ops/softsplat.py`, with the semantics of the
reference CUDA `softsplat_out` kernel:

  for each source pixel (y, x):
      fx = x + flow[..., 0];  fy = y + flow[..., 1]
      non-finite fx / fy is sent to -10, so every corner falls outside
      bilinearly scatter-add ``value`` into the 4 integer neighbours of
      (fx, fy) with weights
        w(kx, ky) = (kx ? fx - floor(fx) : floor(fx) + 1 - fx)
                  * (ky ? fy - floor(fy) : floor(fy) + 1 - fy)
      corners outside the frame get weight 0.

The 'sum' core runs in `csrc/splat.cu` on the card (replacing the TPU's
`ops/softsplat_pallas.py::splat_sum_pallas`) and as four `index_add_`
corner passes on the CPU.  Every mode is built on that core in fp32.

Layout: vals [B, H, W, C], flow [B, H, W, 2] with flow[..., 0] = u
(x-displacement, pixels) and flow[..., 1] = v.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffcodec_tpu_torch import _kernels

_MODES = ("sum", "avg", "linear", "soft")
_EPS_SUFFIXES = ("", "addeps", "zeroeps", "clipeps")


def _corner_terms(flow: torch.Tensor):
    """Per-corner (flat destination index [B*H*W], weight [B, H, W]) pairs;
    corners outside the frame carry weight 0 and an in-range dummy index.
    `diffcodec_tpu/ops/softsplat.py::_corner_terms` in torch."""
    B, H, W, _ = flow.shape
    xg = torch.arange(W, dtype=torch.float32, device=flow.device)
    yg = torch.arange(H, dtype=torch.float32, device=flow.device)[:, None]
    fx = xg + flow[..., 0]
    fy = yg + flow[..., 1]
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    fx = torch.where(finite, fx, torch.full_like(fx, -10.0))
    fy = torch.where(finite, fy, torch.full_like(fy, -10.0))
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = fx - x0
    ay = fy - y0
    base = (torch.arange(B, device=flow.device) * (H * W))[:, None, None]
    terms = []
    for ky in (0, 1):
        wy = ay if ky else (1.0 - ay)
        for kx in (0, 1):
            wx = ax if kx else (1.0 - ax)
            Xf = x0 + kx
            Yf = y0 + ky
            valid = (Xf >= 0) & (Xf < W) & (Yf >= 0) & (Yf < H)
            w = torch.where(valid, wx * wy, torch.zeros_like(wx))
            Xd = Xf.clamp(0, W - 1).long()
            Yd = Yf.clamp(0, H - 1).long()
            terms.append(((base + Yd * W + Xd).reshape(-1), w))
    return terms


def splat_sum_reference(vals: torch.Tensor,
                        flow: torch.Tensor) -> torch.Tensor:
    """Plain version of the 'sum' splat: four `index_add_` corner passes,
    fp32."""
    B, H, W, C = vals.shape
    vals = vals.float()
    out = torch.zeros(B * H * W, C, dtype=torch.float32, device=vals.device)
    for idx, w in _corner_terms(flow.float()):
        out.index_add_(0, idx, (vals * w[..., None]).reshape(-1, C))
    return out.reshape(B, H, W, C)


def splat_sum(vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """'sum'-mode forward splat, fp32 in and out, differentiable in vals
    and flow.

    On a CPU tensor this is `splat_sum_reference`.  On a CUDA tensor it
    launches `csrc/splat.cu` on that tensor's device or raises, and
    returns a view where the kernel pads the rows (C = 3 into rows of 4);
    `splat_sum.launches` counts the launches.  The gradient is autograd's
    of `splat_sum_reference` on either device, as the JAX package's is the
    VJP of its XLA form (`ops/softsplat.py::_splat_sum_auto_bwd`).
    """
    return _kernels.PlainBackward.apply(_splat_sum_fast, splat_sum_reference,
                                       vals, flow)


def _splat_sum_fast(vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    if vals.device.type == "cpu":
        return splat_sum_reference(vals, flow)
    if vals.device.type != "cuda":
        raise ValueError(f"splat_sum: unsupported device {vals.device}")
    if vals.dim() != 4 or tuple(flow.shape) != tuple(vals.shape[:3]) + (2,):
        raise ValueError(f"splat_sum: vals {tuple(vals.shape)} and flow "
                         f"{tuple(flow.shape)} must be [B,H,W,C] and "
                         "[B,H,W,2]")
    for name, t in (("vals", vals), ("flow", flow)):
        if t.device != vals.device:
            raise ValueError(f"splat_sum: {name} on {t.device}, vals on "
                             f"{vals.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"splat_sum: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"splat_sum: {name} must be contiguous")
    B, H, W, C = vals.shape
    if vals.numel() == 0:
        return torch.zeros_like(vals)
    lib = _kernels.lib()
    # the kernel's rows may be wider than C (3 channels go out as 16-byte
    # v4 reductions onto rows of 4): the result is the view of C of them
    row = lib.dc_splat_row(C)
    out = torch.zeros(B, H, W, row, dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        code = lib.dc_splat_sum(vals.data_ptr(), flow.data_ptr(),
                                out.data_ptr(), B, H, W, C,
                                _kernels.stream_ptr(vals.device))
    _kernels.check(code, "dc_splat_sum")
    splat_sum.launches += 1
    return out if row == C else out[..., :C]


splat_sum.launches = 0


def softsplat(vals: torch.Tensor, flow: torch.Tensor,
              metric: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """Forward (softmax) splatting in an fp32 island.

    mode: 'sum' | 'avg' | 'linear[-{addeps,zeroeps,clipeps}]'
          | 'soft[-{addeps,zeroeps,clipeps}]'; metric [B, H, W, 1] is
    required for 'linear' and 'soft'.  Returns vals.dtype.
    """
    base = mode.split("-")[0]
    suffix = mode.split("-")[1] if "-" in mode else ""
    if base not in _MODES:
        raise ValueError(f"unknown softsplat mode {mode!r}")
    if suffix not in _EPS_SUFFIXES:
        raise ValueError(f"unknown softsplat eps-mode {mode!r}")
    if base in ("sum", "avg") and metric is not None:
        raise ValueError(f"mode {mode!r} takes no metric")
    if base in ("linear", "soft") and metric is None:
        raise ValueError(f"mode {mode!r} requires a metric")

    dtype = vals.dtype
    vals = vals.float()
    flow = flow.float().contiguous()
    if base == "sum":
        return splat_sum(vals.contiguous(), flow).to(dtype)
    if base == "avg":
        stacked = torch.cat([vals, torch.ones_like(vals[..., :1])], dim=-1)
    elif base == "linear":
        metric = metric.float()
        stacked = torch.cat([vals * metric, metric], dim=-1)
    else:  # soft
        m = torch.exp(metric.float())
        stacked = torch.cat([vals * m, m], dim=-1)

    out = splat_sum(stacked, flow)
    norm = out[..., -1:]
    if suffix in ("", "addeps"):
        norm = norm + 1e-7
    elif suffix == "zeroeps":
        norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    else:  # clipeps
        norm = norm.clamp_min(1e-7)
    return (out[..., :-1] / norm).to(dtype)


def backward_warp(vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear backward warp with zero padding: out(p) = in(p + flow(p)).

    `diffcodec_tpu/ops/softsplat.py::backward_warp`; fp32 out."""
    B, H, W, C = vals.shape
    vals = vals.float()
    flow = flow.float()
    xg = torch.arange(W, dtype=torch.float32, device=vals.device)
    yg = torch.arange(H, dtype=torch.float32, device=vals.device)[:, None]
    fx = xg + flow[..., 0]
    fy = yg + flow[..., 1]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = fx - x0
    ay = fy - y0
    flat = vals.reshape(B, H * W, C)
    out = torch.zeros(B, H, W, C, dtype=torch.float32, device=vals.device)
    for ky in (0, 1):
        wy = ay if ky else 1.0 - ay
        for kx in (0, 1):
            wx = ax if kx else 1.0 - ax
            Xs = x0 + kx
            Ys = y0 + ky
            valid = (Xs >= 0) & (Xs < W) & (Ys >= 0) & (Ys < H)
            # invalid (also non-finite) corners read pixel 0 and are
            # zeroed below
            Xi = torch.where(valid, Xs, torch.zeros_like(Xs)).long()
            Yi = torch.where(valid, Ys, torch.zeros_like(Ys)).long()
            idx = (Yi * W + Xi).reshape(B, H * W, 1).expand(B, H * W, C)
            gathered = torch.gather(flat, 1, idx).reshape(B, H, W, C)
            contrib = (wx[..., None] * wy[..., None]) * gathered
            out = out + torch.where(valid[..., None], contrib,
                                    torch.zeros_like(contrib))
    return out
