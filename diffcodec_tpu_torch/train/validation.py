"""In-training validation: sample inter frames and score them.

Counterpart: `diffcodec_tpu/train/validation.py` (the reference's
`log_validation`, `train_controlnet.py:84-255`): run the sampling pipeline
on held-out (anchors, flows, ground truth) triples, compute PSNR and
MS-SSIM, and write [I0 | I1 | Pred | GT] panels; the scalars go to the
`MetricsLogger`, the panels to PNG files (`utils/png_io.py`, no PIL) and
to the logger's `log_image`.  The initial latents are the caller's, drawn
from a `torch.Generator` where JAX draws them from its key.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from diffcodec_tpu_torch.eval.metrics import ms_ssim, psnr
from diffcodec_tpu_torch.utils.logging import MetricsLogger
from diffcodec_tpu_torch.utils.png_io import write_png

# MS-SSIM's 5 scales of 11-tap blurs need frames this tall
MS_SSIM_MIN_SIZE = 176


def make_panel(i0: np.ndarray, i1: np.ndarray, pred: np.ndarray,
               gt: np.ndarray) -> np.ndarray:
    """[I0 | I1 | Pred | GT] side-by-side uint8 panel
    (train_controlnet.py:222-248 layout)."""
    return np.concatenate([i0, i1, pred, gt], axis=1)


def to_uint8(images: np.ndarray) -> np.ndarray:
    """Images in [-1, 1] -> uint8, as the JAX package rounds them."""
    return np.clip((np.asarray(images, np.float32) + 1) * 127.5, 0,
                   255).astype(np.uint8)


def run_validation(pipeline, batch: Dict[str, np.ndarray], text_embeds,
                   uncond_embeds, latents, out_dir: Optional[str] = None,
                   logger: Optional[MetricsLogger] = None,
                   step: int = 0) -> Dict[str, float]:
    """Sample predictions for a validation batch and score them against
    the ground truth.

    batch: {'cond' [B, H, W, 6] in [0, 1], 'flow' [B, H, W, 4], 'image'
    [B, H, W, 3] in [-1, 1]} as numpy arrays; text_embeds / uncond_embeds
    [B, L, D] and latents [B, H/8, W/8, 4] tensors on the pipeline's
    device.  Returns {'val_psnr', 'val_ms_ssim'}: the mean PSNR over the
    finite values (inf where none is), and the mean MS-SSIM (NaN below
    176 px)."""
    device = latents.device
    images = pipeline.sample(
        latents, text_embeds, uncond_embeds,
        torch.from_numpy(np.asarray(batch["cond"], np.float32)).to(device),
        torch.from_numpy(np.asarray(batch["flow"], np.float32)).to(device))
    pred_u8 = to_uint8(images.float().cpu().numpy())
    gt_u8 = to_uint8(batch["image"])
    pred_t = torch.from_numpy(pred_u8).to(device).float()
    gt_t = torch.from_numpy(gt_u8).to(device).float()
    p = psnr(pred_t, gt_t).cpu().numpy()
    p = p[np.isfinite(p)]
    m = (ms_ssim(pred_t, gt_t).cpu().numpy()
         if pred_u8.shape[1] >= MS_SSIM_MIN_SIZE else np.asarray([np.nan]))
    metrics = {"val_psnr": float(p.mean()) if p.size else float("inf"),
               "val_ms_ssim": float(np.nanmean(m))}
    if logger is not None:
        logger.log(metrics, step)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        cond_u8 = np.clip(np.asarray(batch["cond"]) * 255, 0,
                          255).astype(np.uint8)
        for b in range(pred_u8.shape[0]):
            panel = make_panel(cond_u8[b, ..., :3], cond_u8[b, ..., 3:],
                               pred_u8[b], gt_u8[b])
            write_png(os.path.join(out_dir, f"val_{step:07d}_{b}.png"),
                      panel)
            if logger is not None:
                logger.log_image(f"validation/panel_{b}", panel, step)
    return metrics
