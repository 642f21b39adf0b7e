"""Low/high frequency-band reconstruction-error analysis.

Counterpart: `diffcodec_tpu/eval/freq_analysis.py`, its Gaussian blur a
depthwise `F.conv2d` on the caller's device.  Parity target: the
frequency-error study in `improv_experiments.ipynb`
(cells 0-2): split original and prediction into low-frequency (Gaussian
blur, kernel 15, sigma 3) and high-frequency (residual) bands, report the
per-band MSE, and plot the per-video bar chart.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel(kernel_size: int = 15, sigma: float = 3.0) -> np.ndarray:
    x = np.arange(-(kernel_size // 2), kernel_size // 2 + 1.0)
    xg = np.tile(x, (kernel_size, 1))
    k = np.exp(-(xg ** 2 + xg.T ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, kernel_size: int = 15,
                  sigma: float = 3.0) -> torch.Tensor:
    """Depthwise Gaussian blur of NHWC images in fp32 (zero padding, the
    notebook's conv2d padding=k//2)."""
    C = x.shape[-1]
    k = torch.from_numpy(gaussian_kernel(kernel_size, sigma)).to(x.device)
    kern = k.expand(C, 1, kernel_size, kernel_size)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), kern,
                 padding=kernel_size // 2, groups=C)
    return y.permute(0, 2, 3, 1)


def frequency_errors(orig, pred, kernel_size: int = 15, sigma: float = 3.0,
                     device="cuda") -> Dict[str, float]:
    """Per-band MSE between images in [0, 1] (NHWC or HWC), on `device`."""
    orig = torch.as_tensor(orig, dtype=torch.float32).to(device)
    pred = torch.as_tensor(pred, dtype=torch.float32).to(device)
    if orig.ndim == 3:
        orig, pred = orig[None], pred[None]
    if orig.shape != pred.shape:
        raise ValueError(f"shape mismatch: {tuple(orig.shape)} vs "
                         f"{tuple(pred.shape)}")
    orig_low = gaussian_blur(orig, kernel_size, sigma)
    pred_low = gaussian_blur(pred, kernel_size, sigma)
    low_err = float(torch.mean((orig_low - pred_low) ** 2))
    high_err = float(torch.mean(((orig - orig_low) - (pred - pred_low))
                                ** 2))
    return {"low_error": low_err, "high_error": high_err}


def plot_frequency_errors(results: Mapping[str, Mapping[str, float]],
                          out_path: str, title: str =
                          "Low vs High Frequency Errors per Video") -> None:
    """Grouped bar chart of per-video band errors (notebook cell 2)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = list(results)
    x = np.arange(len(labels))
    width = 0.35
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.bar(x - width / 2, [results[v]["low_error"] for v in labels], width,
           label="Low-Freq Error")
    ax.bar(x + width / 2, [results[v]["high_error"] for v in labels], width,
           label="High-Freq Error")
    ax.set_ylabel("MSE Error")
    ax.set_title(title)
    ax.set_xticks(x)
    ax.set_xticklabels(labels)
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
