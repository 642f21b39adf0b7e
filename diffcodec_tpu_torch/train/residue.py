"""The residual path's data transform, and the residual pixel DDPM's
training step.

Counterparts: `diffcodec_tpu/train/residue.py` (`warp_and_fuse`,
`make_residue_batch`, :29-75), which follow the reference's ResidueDataset
and WarpingDatasetWrapper: both anchors forward-warped to the target by
softmax splatting, occlusion-fused into one warped prediction, residual =
ground truth - prediction; and `scripts/train_residual.py` (:57-73), the
standalone DDPM's step.

The JAX package's two deliberate fixes over the reference are kept: image2
is warped by flow2 (the reference warps image1 for both directions), and
the fusion weighs each warp by its validity (1 - occlusion), falling back
to the plain average where both are occluded.  The warp and fusion run in
an fp32 island; on the card each of the four splats (two warps, two
occlusion checks) is one launch of the splat kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from diffcodec_tpu_torch.config import SchedulerConfig, TrainConfig
from diffcodec_tpu_torch.ops.flow import compute_occlusion_mask
from diffcodec_tpu_torch.ops.softsplat import softsplat
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from diffcodec_tpu_torch.train.trainer import Optimizer


def warp_and_fuse(img1: torch.Tensor, img2: torch.Tensor,
                  flow1: torch.Tensor, flow2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward-warp both anchors to the target and occlusion-fuse.

    img* [B, H, W, 3] (any range), flow* [B, H, W, 2] in pixels (flow1:
    img1 -> target, flow2: img2 -> target).  Returns (fused, occ1, occ2),
    fp32."""
    ones = torch.ones(flow1.shape[:3] + (1,), dtype=torch.float32,
                      device=flow1.device)
    warped1 = softsplat(img1.float(), flow1.float(), ones, "soft")
    warped2 = softsplat(img2.float(), flow2.float(), ones, "soft")
    occ1 = compute_occlusion_mask(flow2, flow1)
    occ2 = compute_occlusion_mask(flow1, flow2)
    w1 = 1.0 - occ1
    w2 = 1.0 - occ2
    denom = w1 + w2
    uniform = 0.5 * (warped1 + warped2)
    fused = torch.where(denom > 1e-6,
                        (w1 * warped1 + w2 * warped2) / denom.clamp_min(1e-6),
                        uniform)
    return fused, occ1, occ2


def make_residue_batch(batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A ControlNet batch -> a residual-training batch.

    In: 'image' [B, H, W, 3] in [-1, 1], 'cond' [B, H, W, 6] in [0, 1],
    'flow' [B, H, W, 4].  Out: the same with 'warped' (the fused
    prediction, clipped to [-1, 1], fp32) and 'residual' (image - warped),
    which the trainer encodes as its target while the ControlNet receives
    'warped'."""
    img1 = batch["cond"][..., :3] * 2.0 - 1.0
    img2 = batch["cond"][..., 3:] * 2.0 - 1.0
    flow1 = batch["flow"][..., :2]
    flow2 = batch["flow"][..., 2:]
    fused, _, _ = warp_and_fuse(img1, img2, flow1, flow2)
    fused = fused.clamp(-1.0, 1.0)
    out = dict(batch)
    out["warped"] = fused
    out["residual"] = batch["image"] - fused
    return out


def ddpm_schedule() -> NoiseSchedule:
    """The residual DDPM's noise schedule: squaredcos_cap_v2 over 500
    steps (`train_residual.py`'s defaults)."""
    return NoiseSchedule.create(SchedulerConfig(
        num_train_timesteps=500, beta_schedule="squaredcos_cap_v2",
        beta_start=0.0001, beta_end=0.02))


def ddpm_optimizer() -> Optimizer:
    """`train_residual.py`'s optax.adamw(4e-4) with optax's defaults (b1
    0.9, b2 0.999, eps 1e-8, weight decay 1e-4), unclipped."""
    return Optimizer(TrainConfig(learning_rate=4e-4, adam_weight_decay=1e-4,
                                 max_grad_norm=float("inf")))


def ddpm_train_step(unet: torch.nn.Module, schedule: NoiseSchedule,
                    tx: Optimizer, opt_state, residual: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    timesteps: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """One step of the residual DDPM (`scripts/train_residual.py`'s
    `train_step`): the noise and a timestep per sample in
    [0, num_train_timesteps) drawn from `generator` in that order where
    not given, the eps-prediction MSE on the residual noised at those
    timesteps, its gradient, one update of `unet`'s parameters in place
    (`opt_state` from `tx.init` of them).  Returns the loss (detached)."""
    dev = residual.device
    if noise is None:
        noise = torch.randn(residual.shape, generator=generator, device=dev)
    if timesteps is None:
        timesteps = torch.randint(0, schedule.cfg.num_train_timesteps,
                                  (residual.shape[0],), generator=generator,
                                  device=dev)
    params = dict(unet.named_parameters())
    pred = unet(schedule.add_noise(residual, noise, timesteps), timesteps)
    loss = torch.mean((pred.float() - noise.float()) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    tx.update(params, dict(zip(params, grads)), opt_state)
    return loss.detach()
