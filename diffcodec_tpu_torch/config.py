"""Typed configuration of the port: the model and sampler configs of
`diffcodec_tpu/config.py` (:16-120), copied so the port imports nothing of
the JAX package.  Frozen dataclasses, hashable, with the same defaults
(SD-1.5 widths) and the same `tiny()` test sizes."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """SD-1.5 AutoencoderKL architecture."""
    in_channels: int = 3
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls):
        return cls(base_channels=8, channel_mults=(1, 2), layers_per_block=1)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-1.5 UNet2DConditionModel architecture."""
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    # which down blocks carry cross-attention transformers (SD-1.5: all but
    # the last)
    cross_attention_blocks: Tuple[bool, ...] = (True, True, True, False)
    transformer_depth: int = 1

    @classmethod
    def tiny(cls):
        # 3 blocks with a repeated final width so the ControlNet's shared
        # deepest FDN is exercised
        return cls(block_out_channels=(32, 64, 64), layers_per_block=1,
                   cross_attention_dim=32, attention_heads=2,
                   cross_attention_blocks=(True, False, False))


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """DualFlowControlNet architecture."""
    unet: UNetConfig = UNetConfig()
    # FDN injection widths at 64/32/16/8 resolution
    inject_channels: Tuple[int, ...] = (320, 320, 640, 1280)
    conditioning_channels: int = 6  # two RGB anchors
    flow_channels: int = 4          # fwd + bwd flow

    @classmethod
    def tiny(cls):
        return cls(unet=UNetConfig.tiny(), inject_channels=(32, 64, 64))


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """DDPM/UniPC noise schedule (SD-1.5: scaled_linear 0.00085..0.012)."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # or "linear", "squaredcos_cap_v2"
    prediction_type: str = "epsilon"      # or "v_prediction"


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Inference-time sampling configuration."""
    num_inference_steps: int = 30
    guidance_scale: float = 3.5
    controlnet_conditioning_scale: float = 1.35
    control_guidance_start: float = 0.0
    control_guidance_end: float = 1.0
    guess_mode: bool = False
    # recompute the ControlNet residuals every k-th step and reuse them in
    # between; 1 = exact (recompute every step)
    controlnet_interval: int = 1
    # recompute the UNet down path every k-th step and reuse its hidden and
    # skip stack in between; 1 = exact
    unet_encoder_interval: int = 1
    freeu: bool = True
    freeu_s1: float = 0.9
    freeu_s2: float = 0.2
    freeu_b1: float = 1.2
    freeu_b2: float = 1.4
