"""K-step consistency decode for a distilled student.

Counterpart: `diffcodec_tpu/sampling/distilled.py` (`DistilledPipeline`
:33-106).  Multistep consistency sampling (Song et al. 2023, alg. 1): from
noise at the schedule's top timestep, map to x0 with the consistency
function, then for each remaining step re-noise x0 to the next (lower)
timestep and map again: K denoiser evaluations, and no CFG batch doubling
(the student absorbed the guidance), so no uncond embeddings.

It reuses `DualFlowPipeline`'s models, with the conditioning pyramid
computed once per decode (`extract_pyramid`) and the ControlNet trunk run
per step (`backbone`).  JAX draws the K - 1 re-noises inside the loop from
its own RNG; here they come in as `noises`, or are drawn from an explicit
`torch.Generator` on the latents' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from diffcodec_tpu_torch.config import DistillConfig
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL, decode_from_latents
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from diffcodec_tpu_torch.train.distill import boundary_scalings, ddim_grid


def _linspace_f32(stop: int, num: int) -> np.ndarray:
    """`jnp.linspace(0, stop, num)` as XLA computes it: in float32, point i
    is float32(i) * step with step = float32(stop) * float32(1 / (num - 1))
    (XLA folds jnp's stop * (i / (num - 1)) into one constant), and the
    last point is exactly stop."""
    if num == 1:
        return np.zeros(1, np.float32)
    step = np.float32(stop) * (np.float32(1) / np.float32(num - 1))
    return np.append(np.arange(num - 1, dtype=np.float32) * step,
                     np.float32(stop))


@dataclasses.dataclass(eq=False)
class DistilledPipeline:
    """A frozen student (UNet, ControlNet, VAE) -> K-step decoder."""
    unet: UNet2DConditionModel
    controlnet: DualFlowControlNet
    vae: AutoencoderKL
    schedule: NoiseSchedule
    config: DistillConfig = DistillConfig()
    # no CFG batch, so sample() takes no uncond embeddings;
    # `sampling.tiled.sample_tiled` drops that operand
    takes_uncond = False

    @classmethod
    def create(cls, *args, config: DistillConfig = DistillConfig(),
               **kwargs) -> "DistilledPipeline":
        """Build the models as `DualFlowPipeline.create(*args, **kwargs)`
        does (configs, dtype, device, fused_conv)."""
        return cls.from_pipeline(DualFlowPipeline.create(*args, **kwargs),
                                 config)

    @classmethod
    def from_pipeline(cls, pipe: DualFlowPipeline,
                      config: DistillConfig = DistillConfig()
                      ) -> "DistilledPipeline":
        """The K-step decoder over the models of `pipe` (shared, not
        copied)."""
        return cls(unet=pipe.unet, controlnet=pipe.controlnet, vae=pipe.vae,
                   schedule=pipe.schedule, config=config)

    def _f(self, pyramid, x, t: int, text_embeds) -> torch.Tensor:
        """The consistency function at timestep t, fp32."""
        c = self.config
        down, mid = self.controlnet.backbone(x, t, text_embeds, pyramid,
                                             c.controlnet_conditioning_scale)
        freeu = ((c.freeu_s1, c.freeu_s2, c.freeu_b1, c.freeu_b2)
                 if c.freeu else None)
        eps = self.unet(x, t, text_embeds,
                        down_block_additional_residuals=down,
                        mid_block_additional_residual=mid, freeu=freeu)
        x0 = self.schedule.pred_original_sample(x, eps, t)
        c_skip, c_out = boundary_scalings(t, c.sigma_data,
                                          c.timestep_scaling)
        return float(c_skip) * x.float() + float(c_out) * x0

    def step_schedule(self) -> np.ndarray:
        """K timesteps, descending, subsampled evenly from the teacher's
        DDIM grid (the first is the top of the schedule).  The indices are
        `jnp.linspace(0, n - 1, K).round()` as the JAX package computes
        them, in float32 (`_linspace_f32`), rounded half to even.  numpy's
        float64 linspace lands exactly on x.5 where float32 lands above it
        (K = 15, 29, 31, 35, 43 at n = 50), and so picks another
        timestep."""
        grid = ddim_grid(self.schedule, self.config.num_teacher_steps)
        K = self.config.num_student_steps
        return grid[_linspace_f32(grid.shape[0] - 1, K).round()
                    .astype(np.int64)]

    @torch.no_grad()
    def denoise(self, latents, text_embeds, controlnet_cond, flow_cond,
                noises: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """latents [B, h, w, 4] noise at the top timestep; text_embeds
        [B, L, D]; controlnet_cond [B, H, W, 6]; flow_cond [B, H, W, 4];
        noises: the K - 1 re-noises, each like latents, or None to draw
        them from `generator` (by default one seeded with 0 on the
        latents' device).  Returns the final x0 [B, h, w, 4], fp32."""
        ts = self.step_schedule()
        if noises is not None and len(noises) != len(ts) - 1:
            raise ValueError(f"{len(ts)} steps take {len(ts) - 1} noises, "
                             f"got {len(noises)}")
        if noises is None and generator is None:
            generator = torch.Generator(device=latents.device).manual_seed(0)
        pyramid = self.controlnet.extract_pyramid(controlnet_cond, flow_cond)
        x0 = self._f(pyramid, latents, int(ts[0]), text_embeds)
        for k in range(1, len(ts)):
            noise = (noises[k - 1] if noises is not None else
                     torch.randn(x0.shape, generator=generator,
                                 device=x0.device))
            x_k = self.schedule.add_noise(x0, noise, int(ts[k]))
            x0 = self._f(pyramid, x_k.to(latents.dtype), int(ts[k]),
                         text_embeds)
        return x0

    @torch.no_grad()
    def sample(self, latents, text_embeds, controlnet_cond, flow_cond,
               noises: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None):
        """Full decode: noise -> K consistency steps -> images [B, H, W, 3]
        in [-1, 1]."""
        final = self.denoise(latents, text_embeds, controlnet_cond,
                             flow_cond, noises, generator)
        return decode_from_latents(self.vae, final).clamp(-1.0, 1.0)
