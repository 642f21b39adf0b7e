"""Training losses of the ControlNets.

Counterpart: `diffcodec_tpu/train/losses.py` (the reference's
`train_controlnet.py:1124-1157`):
  loss = MSE(model_pred, target)
       + perceptual_weight * LPIPS(x0_decoded, img_gt)
       + edge_weight * SobelEdgeLoss(x0_decoded, img_gt)
with target = noise (epsilon) or velocity (v-prediction).  The decode of
x0 is differentiable, as in the JAX package (the reference decodes under
`torch.no_grad()`, which makes the pixel terms constants; set
`stop_decode_gradient=True` for that), and recomputed in the backward
(`torch.utils.checkpoint`, where JAX uses `jax.checkpoint`).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from diffcodec_tpu_torch.ops.sobel import sobel_edge_loss
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule


def diffusion_loss(schedule: NoiseSchedule, model_pred: torch.Tensor,
                   noise: torch.Tensor, latents: torch.Tensor,
                   timesteps) -> torch.Tensor:
    """MSE against the scheduler's target, fp32."""
    if schedule.cfg.prediction_type == "epsilon":
        target = noise
    elif schedule.cfg.prediction_type == "v_prediction":
        target = schedule.velocity(latents, noise, timesteps)
    else:
        raise ValueError(schedule.cfg.prediction_type)
    return torch.mean((model_pred.float() - target.float()) ** 2)


def pixel_losses(schedule: NoiseSchedule, vae, noisy_latents: torch.Tensor,
                 model_pred: torch.Tensor, timesteps, img_gt: torch.Tensor,
                 lpips_model=None, stop_decode_gradient: bool = False):
    """Decode x0 and compute the (lpips, edge) losses against the ground
    truth pixels; `lpips_model(pred, target)` gives per-sample distances
    and is called only where one is given (else lpips is 0)."""
    x0 = schedule.pred_original_sample(noisy_latents, model_pred, timesteps)
    dtype = vae.post_quant_conv.weight.dtype

    def decode(z):
        return vae.decode((z / vae.cfg.scaling_factor).to(dtype))

    img_hat = checkpoint(decode, x0, use_reentrant=False).float()
    img_hat = img_hat.clamp(-1.0, 1.0)
    if stop_decode_gradient:
        img_hat = img_hat.detach()
    img_gt = img_gt.float()
    edge = sobel_edge_loss(img_hat, img_gt)
    lp = torch.zeros((), device=img_hat.device)
    if lpips_model is not None:
        lp = torch.mean(lpips_model(img_hat, img_gt))
    return lp, edge
