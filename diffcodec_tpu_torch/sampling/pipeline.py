"""The inter-frame decoder: ControlNet-conditioned UniPC denoise loop and VAE
decode.

Counterpart: `diffcodec_tpu/sampling/pipeline.py` (`DualFlowPipeline`
:35-217).  Kept: CFG as a doubled batch through the ControlNet and the
UNet, guess mode (zero residuals for the unconditional half), the
ControlNet keep schedule, the ControlNet and UNet-encoder interval caches,
the conditioning pyramid computed once per decode, and the final clip to
[-1, 1].  The loop is a Python loop (PyTorch runs eagerly); noise always
comes in as `latents`.
"""

from __future__ import annotations

import dataclasses

import torch

from diffcodec_tpu_torch.config import (ControlNetConfig, SamplerConfig,
                                        SchedulerConfig, UNetConfig,
                                        VAEConfig)
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL, decode_from_latents
from diffcodec_tpu_torch.sampling.schedulers import (NoiseSchedule, UniPC,
                                                     cfg_combine,
                                                     controlnet_keep_schedule)


@dataclasses.dataclass(eq=False)
class DualFlowPipeline:
    """The frozen SD stack and the DualFlowControlNet, on one device."""
    unet: UNet2DConditionModel
    controlnet: DualFlowControlNet
    vae: AutoencoderKL
    schedule: NoiseSchedule
    sampler: SamplerConfig = SamplerConfig()

    @classmethod
    def create(cls, unet_cfg: UNetConfig = UNetConfig(),
               controlnet_cfg: ControlNetConfig = None,
               vae_cfg: VAEConfig = VAEConfig(),
               sampler: SamplerConfig = SamplerConfig(),
               scheduler_cfg: SchedulerConfig = SchedulerConfig(),
               dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> "DualFlowPipeline":
        """Build the three models on `device` with their weights in
        `dtype` (initialised by PyTorch; load real ones with
        `weights.load_pipeline_params`)."""
        if controlnet_cfg is None:
            controlnet_cfg = ControlNetConfig(unet=unet_cfg)
        with torch.device(device):
            models = [UNet2DConditionModel(unet_cfg),
                      DualFlowControlNet(controlnet_cfg),
                      AutoencoderKL(vae_cfg)]
        unet, controlnet, vae = (m.to(dtype).eval().requires_grad_(False)
                                 for m in models)
        return cls(unet=unet, controlnet=controlnet, vae=vae,
                   schedule=NoiseSchedule.create(scheduler_cfg),
                   sampler=sampler)

    @torch.no_grad()
    def denoise(self, latents, text_embeds, uncond_embeds, controlnet_cond,
                flow_cond):
        """The full denoise loop.

        latents [B, h, w, 4] initial noise; text_embeds / uncond_embeds
        [B, L, D]; controlnet_cond [B, H, W, 6]; flow_cond [B, H, W, 4].
        Returns the final latents [B, h, w, 4], fp32.
        """
        cfg = self.sampler
        do_cfg = cfg.guidance_scale > 1.0
        n_steps = cfg.num_inference_steps
        unipc = UniPC(self.schedule, n_steps)
        tables = unipc.tables()
        keep = controlnet_keep_schedule(n_steps, cfg.control_guidance_start,
                                        cfg.control_guidance_end)

        pyramid = self.controlnet.extract_pyramid(controlnet_cond, flow_cond)
        if do_cfg and not cfg.guess_mode:
            pyramid = [torch.cat([p, p], dim=0) for p in pyramid]
            ctx_cn = torch.cat([uncond_embeds, text_embeds], dim=0)
        else:
            ctx_cn = text_embeds
        ctx_unet = (torch.cat([uncond_embeds, text_embeds], dim=0)
                    if do_cfg else text_embeds)
        freeu = ((cfg.freeu_s1, cfg.freeu_s2, cfg.freeu_b1, cfg.freeu_b2)
                 if cfg.freeu else None)
        interval = max(int(cfg.controlnet_interval), 1)
        enc_interval = max(int(cfg.unet_encoder_interval), 1)

        def run_controlnet(x, lat_in, t, cond_scale):
            if cfg.guess_mode and do_cfg:
                down, mid = self.controlnet.backbone(
                    x, t, text_embeds, pyramid, cond_scale)
                down = tuple(torch.cat([torch.zeros_like(d), d], dim=0)
                             for d in down)
                mid = torch.cat([torch.zeros_like(mid), mid], dim=0)
                return down, mid
            return self.controlnet.backbone(lat_in, t, ctx_cn, pyramid,
                                            cond_scale)

        state = unipc.init_state(latents)
        cached = cached_enc = None
        for i in range(n_steps):
            t = int(tables.timesteps[i])
            x = state.sample.to(latents.dtype)
            lat_in = torch.cat([x, x], dim=0) if do_cfg else x
            cond_scale = float(cfg.controlnet_conditioning_scale
                               * keep[i])
            if i % interval == 0:
                cached = run_controlnet(x, lat_in, t, cond_scale)
            down, mid = cached
            if i % enc_interval == 0:
                cached_enc = self.unet.encode(lat_in, t, ctx_unet)
            hidden, res_stack = cached_enc
            eps = self.unet.decode(hidden, res_stack, t, ctx_unet,
                                   down_block_additional_residuals=down,
                                   mid_block_additional_residual=mid,
                                   freeu=freeu)
            if do_cfg:
                eps_u, eps_t = eps.chunk(2, dim=0)
                eps = cfg_combine(eps_u, eps_t, cfg.guidance_scale)
            state = unipc.step(tables, state, eps, i)
        return state.sample

    @torch.no_grad()
    def sample(self, latents, text_embeds, uncond_embeds, controlnet_cond,
               flow_cond):
        """Full decode: noise latents -> images [B, H, W, 3] in [-1, 1]."""
        final = self.denoise(latents, text_embeds, uncond_embeds,
                             controlnet_cond, flow_cond)
        images = decode_from_latents(self.vae, final)
        return images.clamp(-1.0, 1.0)
