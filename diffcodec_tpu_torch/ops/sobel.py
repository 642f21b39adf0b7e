"""Sobel gradient-magnitude edge op and edge loss, NHWC.

Counterpart: `diffcodec_tpu/ops/sobel.py` (the reference's
`controlnet/edge_loss.py:5-38` SobelEdgeLoss): per-channel 3x3 Sobel convs
with zero padding, gradient magnitude sqrt(gx^2 + gy^2 + eps), L1 between
the magnitudes of prediction and target, inputs rescaled from [-1, 1] to
[0, 1] first.  fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_KX = ((-1.0, 0.0, 1.0),
       (-2.0, 0.0, 2.0),
       (-1.0, 0.0, 1.0))


def sobel_magnitude(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-channel Sobel gradient magnitude of an NHWC tensor, fp32."""
    C = x.shape[-1]
    kx = torch.tensor(_KX, dtype=torch.float32, device=x.device)
    # [2C, 1, 3, 3]: channel c's x then y kernel, a depthwise conv
    k = torch.stack([kx, kx.T]).repeat(C, 1, 1)[:, None]
    g = F.conv2d(x.float().permute(0, 3, 1, 2), k, padding=1, groups=C)
    gx, gy = g[:, 0::2], g[:, 1::2]
    return torch.sqrt(gx * gx + gy * gy + eps).permute(0, 2, 3, 1)


def sobel_edge_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 of Sobel magnitudes; inputs in [-1, 1] rescaled to [0, 1]."""
    return torch.mean(torch.abs(sobel_magnitude((pred + 1.0) / 2.0)
                                - sobel_magnitude((target + 1.0) / 2.0)))
