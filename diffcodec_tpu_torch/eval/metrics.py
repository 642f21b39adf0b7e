"""Image and video quality metrics: PSNR, SSIM, MS-SSIM, and the batch
summary the codec evaluation reports.

Counterpart: `diffcodec_tpu/eval/metrics.py` (`psnr` :23, `_blur` :42,
`ssim` :78, `ms_ssim` :86, `_avg_pool2` :121, `calculate_metrics_batch`
:130), the reference's `test_utils.py:23-82`: PSNR at a data range of 255
(inf for identical frames), MS-SSIM as pytorch_msssim computes it (an
11-tap Gaussian of sigma 1.5 applied separably in valid mode per channel,
K = (0.01, 0.03), the weights below, the coarse scales' cs and the finest
scale's SSIM averaged per channel and clamped at 0, multiplied per channel
and averaged over channels; 2 x 2 average pools between scales padding
`dim % 2` on both sides, the padded zeros counted in the divisor), pairs
with PSNR over 1000 left out of the mean PSNR.

Tensors on the caller's device, fp32; images NHWC.  LPIPS is
`train.lpips`, FID and FVD `eval.frechet`.
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_SSIM_SIZE = 11  # the Gaussian's taps


def require_fp32_on(model: torch.nn.Module, device) -> torch.device:
    """The metric networks' feature functions run the caller's module as
    it is: raise `ValueError` unless each of its floating tensors is fp32
    on `device` (move it first: `module.to(device, torch.float32)`)."""
    want = torch.device(device)
    if want.type == "cuda" and want.index is None \
            and torch.cuda.is_available():
        want = torch.device("cuda", torch.cuda.current_device())
    for name, t in itertools.chain(model.named_parameters(),
                                   model.named_buffers()):
        if t.device != want or (t.is_floating_point()
                                and t.dtype != torch.float32):
            raise ValueError(
                f"{type(model).__name__}.{name} is {t.dtype} on {t.device};"
                f" the metric runs in fp32 on {want}")
    return want


def psnr(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """PSNR over [..., H, W, C] (20 log10(255 / sqrt(mse))); inf where the
    frames are identical."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=(-3, -2, -1))
    finite = 20.0 * np.log10(data_range) - 10.0 * torch.log10(
        mse.clamp_min(1e-20))
    return torch.where(mse == 0.0, torch.full_like(mse, float("inf")),
                       finite)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (
        size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode filter per channel, NCHW: along W, then H."""
    C, k = x.shape[1], kernel.numel()
    x = F.conv2d(x, kernel.view(1, 1, 1, k).expand(C, 1, 1, k), groups=C)
    return F.conv2d(x, kernel.view(1, 1, k, 1).expand(C, 1, k, 1), groups=C)


def _ssim_components(a, b, data_range, size=_SSIM_SIZE, sigma=1.5, k1=0.01,
                     k2=0.03):
    """(SSIM map, cs map) of NCHW fp32 pairs."""
    kernel = _gaussian_kernel(size, sigma, a.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _blur(a, kernel)
    mu_b = _blur(b, kernel)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    sigma_aa = _blur(a * a, kernel) - mu_aa
    sigma_bb = _blur(b * b, kernel) - mu_bb
    sigma_ab = _blur(a * b, kernel) - mu_ab
    cs = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs
    return ssim_map, cs


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def ssim(a: torch.Tensor, b: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """Mean single-scale SSIM over [B, H, W, C] pairs -> [B]."""
    ssim_map, _ = _ssim_components(_nchw(a), _nchw(b), data_range)
    return ssim_map.mean(dim=(1, 2, 3))


def _avg_pool2(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """2 x 2 mean, stride 2, zero padding on both sides counted in the
    divisor (NCHW)."""
    return F.avg_pool2d(x, 2, padding=(pad_h, pad_w),
                        count_include_pad=True)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0,
            weights: Sequence[float] = _MSSSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM of [B, H, W, C] pairs -> [B] (H and W >= 161 for
    the 5 scales; NaN below, where a scale is smaller than the blur and
    JAX's valid-mode filter leaves an empty map, whose mean is NaN)."""
    a, b = _nchw(a), _nchw(b)
    levels = len(weights)
    values = []
    for i in range(levels):
        if min(a.shape[2], a.shape[3]) < _SSIM_SIZE:
            return torch.full(a.shape[:1], float("nan"), device=a.device)
        ssim_map, cs_map = _ssim_components(a, b, data_range)
        if i < levels - 1:
            values.append(cs_map.mean(dim=(2, 3)).clamp_min(0.0))
            pad_h, pad_w = a.shape[2] % 2, a.shape[3] % 2
            a = _avg_pool2(a, pad_h, pad_w)
            b = _avg_pool2(b, pad_h, pad_w)
        else:
            values.append(ssim_map.mean(dim=(2, 3)).clamp_min(0.0))
    w = torch.tensor(weights, dtype=torch.float32, device=a.device)
    stacked = torch.stack(values)  # [levels, B, C]
    return torch.prod(stacked ** w[:, None, None], dim=0).mean(dim=-1)


def calculate_metrics_batch(orig, pred, psnr_skip_threshold: float = 1000.0,
                            lpips_fn=None, fid_fn=None, fvd_fn=None,
                            device="cuda") -> Dict[str, float]:
    """Metric summary over [N, H, W, C] uint8 or float frames (numpy
    arrays or tensors), computed on `device`: the mean PSNR of the pairs
    under `psnr_skip_threshold`, the mean MS-SSIM; where given, the mean
    LPIPS (lpips_fn(pred, orig) on tensors in [-1, 1] -> [N]), the FID
    (fid_fn: uint8 frames -> features) and the FVD (fvd_fn: [1, N, H, W,
    C] clips in [0, 1] -> features; the frames stacked as one clip)."""
    orig = torch.as_tensor(orig).to(device).float()
    pred = torch.as_tensor(pred).to(device).float()
    p = psnr(orig, pred).cpu().numpy()
    valid = p < psnr_skip_threshold
    mean_psnr = float(p[valid].mean()) if valid.any() else float("inf")
    out = {"psnr": mean_psnr,
           "ms_ssim": float(ms_ssim(orig, pred).mean().item())}
    if lpips_fn is not None:
        half = torch.full((), 127.5, device=orig.device)
        out["lpips"] = float(torch.as_tensor(
            lpips_fn(pred / half - 1.0, orig / half - 1.0)).float()
            .mean().item())
    if fid_fn is not None:
        from diffcodec_tpu_torch.eval.frechet import fid_score
        out["fid"] = fid_score(orig.to(torch.uint8).cpu().numpy(),
                               pred.to(torch.uint8).cpu().numpy(), fid_fn)
    if fvd_fn is not None:
        from diffcodec_tpu_torch.eval.frechet import fvd_score
        out["fvd"] = fvd_score(orig.cpu().numpy()[None] / 255.0,
                               pred.cpu().numpy()[None] / 255.0, fvd_fn)
    return out
