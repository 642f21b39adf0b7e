"""Typed configuration of the port: the model and sampler configs of
`diffcodec_tpu/config.py` (:16-120, `CLIPTextConfig` :68-83), its
`TrainConfig` (:122-161), its `DistillConfig` (:164-190), its
`CodecConfig` (:194-202) and its `MeshConfig` (:205-213), copied so the
port imports nothing of the JAX package.  Frozen dataclasses, hashable,
with the same defaults (SD-1.5 widths) and the same `tiny()` test
sizes."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
class CLIPTextConfig:
    """CLIP ViT-L/14 text encoder."""
    vocab_size: int = 49408
    hidden_dim: int = 768
    layers: int = 12
    heads: int = 12
    max_length: int = 77

    @classmethod
    def tiny(cls):
        # keep the REAL vocab: the production BPE tokenizer emits ids up
        # to 49407, and an embedding lookup past the table's end fails (in
        # the JAX package it fills NaN) -- a tiny vocab breaks any pipeline
        # that pairs this config with the real tokenizer
        return cls(vocab_size=49408, hidden_dim=32, layers=2, heads=2,
                   max_length=16)


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """ControlNet training (`train/trainer.py`): AdamW with clipping by
    global norm and optional gradient accumulation, the reference's
    defaults (`train_controlnet.py`)."""
    learning_rate: float = 1e-5
    lr_scheduler: str = "constant"  # | constant_with_warmup | linear | cosine
    lr_warmup_steps: int = 500
    max_train_steps: int = 100000
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    lpips_weight: float = 0.0
    edge_weight: float = 0.0
    text_dropout_prob: float = 0.3
    mixed_precision: str = "bf16"
    checkpointing_steps: int = 500
    checkpoints_total_limit: Optional[int] = None
    seed: int = 0
    # recompute the ControlNet and UNet forwards in the backward
    # (activation checkpointing, the reference's --gradient_checkpointing)
    remat: bool = False
    # store the Adam moments in bfloat16 (fp32 math; the reference's
    # --use_8bit_adam analogue): 4 instead of 8 bytes a parameter
    lowp_adam_moments: bool = False
    # the JAX package serialises its fused update over this many groups of
    # tensors to bound XLA's fp32 transients; the port's eager update already
    # runs tensor by tensor, so it has no effect here
    adam_update_chunks: int = 0


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Consistency (step) distillation of the decoder and the K-step decode
    of its student (`sampling/distilled.py`).  The guidance and
    conditioning scales pin the one operating point the student absorbs:
    the codec's decode settings (SamplerConfig defaults)."""
    num_teacher_steps: int = 50
    guidance_scale: float = 3.5
    controlnet_conditioning_scale: float = 1.35
    # consistency boundary parameterization (c_skip(0)=1 / c_out(0)=0)
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0
    ema_decay: float = 0.995
    loss: str = "huber"  # 'huber' | 'l2'
    huber_c: float = 0.001
    # K-step decode schedule length used by sampling/distilled.py
    num_student_steps: int = 4
    # FreeU, matching SamplerConfig's decode settings (the student trains
    # and decodes with the teacher's UNet scaling)
    freeu: bool = True
    freeu_s1: float = 0.9
    freeu_s2: float = 0.2
    freeu_b1: float = 1.2
    freeu_b2: float = 1.4


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """GOP and flow-rate configuration of the codec (`codec/runner.py`):
    every `gop_size`-th frame is an anchor; inter frames carry no flow
    ('none'), CMP-decodable point lists ('sparse') or dense fields
    ('dense'); 1080p frames decode as overlapping tiles."""
    gop_size: int = 8
    flow_rate_mode: str = "sparse"  # 'none' | 'sparse' | 'dense'
    tile_size: Tuple[int, int] = (512, 512)
    tile_overlap: int = 64
    frame_height: int = 1080
    frame_width: int = 1920


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes: data (DP over GOP frames / tiles / the train
    batch) x fsdp (parameter and optimizer-state sharding, the ZeRO
    analogue of controlnet/deepspeed_config.json)."""
    data_axis: str = "data"
    fsdp_axis: str = "fsdp"
    data_size: int = -1  # -1: infer from device count / fsdp_size
    fsdp_size: int = 1
