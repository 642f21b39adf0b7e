#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printed as one JSON line with the elapsed seconds `t`:
  device     the card, torch and CUDA versions (exits non-zero without CUDA)
  build      nvcc builds the kernels of `diffcodec_tpu_torch/csrc/`
  kernel     each kernel against its plain PyTorch version at every shape
             the decodes give it: max abs error and tolerance, the kernel's,
             the plain version's and, where one PyTorch call computes the
             same function (or, for the convs, its conv part), that call's
             time (CUDA events, median of per-call times), and the bound;
             the splat under two flows at each shape, i.i.d. noise (`wide`)
             and a smooth field (`smooth`, as RAFT's), and beside its bound
             `l2_bound_ms`, the time of one L2 reduction for each corner in
             the frame at the rate of adds measured at C = 161 (a model of
             the first small-channel kernel's traffic, not a bound: a
             kernel that sums corners before it reduces goes below it)
  decode     the port's main path: `DualFlowPipeline.sample` at SD-1.5
             full width, 7 frames (one GOP-8) at 512 x 512, 30 UniPC steps
             with CFG 3.5, ControlNet scale 1.35 and FreeU, bf16, seeded
             random weights; launch counts are zeroed just before and read
             just after; a second decode of the same inputs (and a second
             denoise loop) against the first: images and final latents
             within the splat's atomics' spread (`DECODE_REPEAT_TOL`)
  decode_fusedconv
             the same decode with `fused_conv=True` (the JAX package's
             `exact_fusedconv` point): every conv3x3 of the VAE decoder
             through the conv kernels (29 GN+SiLU+conv launches, one of them
             the 128 -> 3 out-head on the project-then-stencil kernel, and 3
             upsample+conv launches); its VAE against the cuDNN one on the
             same latents
  decode_distilled
             `DistilledPipeline` with K = 4 consistency steps over the same
             models, fused mode, no CFG (the JAX package's bench.py
             distilled point)
  kernel     (the 1080p tiled shapes) every kernel again where a chunk of
             15 tiles through the distilled pipeline puts it: attention at
             BH = 120, splats at B = 30, the VAE's convs at B = 15
  cmp        the CMP densifier at full width (resnet50 + skip, 198 bins,
             seeded random weights and running statistics, fp32) at 1080 x
             1920: ms a call, peak memory; then the card against the CPU
             at 64 x 96 on the same weights
  tiled_exact
             one 1080p frame through `sample_tiled` with the exact
             fused-conv pipeline (bench.py's 1080p point: 15 tiles of 512
             overlapping by 64, 7 a call, uint8 conditioning): s/frame of
             the first and second call, the host's crop and merge timed
             apart, peak memory, launches (3 chunks' fused VAE asserted)
  codec      a synthetic 1080p GOP-8 (9 frames, known flows) through the
             codec: the sparse flow bitstreams (watershed + grid sampler),
             14 CMP calls on the card, then `decode_inter_frames` with
             `sample_tiled` over the distilled K = 4 fused pipeline, 15
             tiles a call; seconds and inter frames/s of the second call,
             stage seconds, peak memory, launches; uint8 [9, 1080, 1920, 3]
             with the anchors unchanged asserted
  checkpoint the weights-readiness path: the full-width UNet,
             DualFlowControlNet, VAE and a seeded CLIP text tower (bf16)
             written as a diffusers root by `models.weights.
             synthesize_sd_checkpoint_dir` into a temporary directory and
             loaded by `load_sd_checkpoint_dir` into fresh modules on the
             card: bytes, seconds and GB/s each way, every tensor
             bit-identical; the distilled K = 4 512 px decode with the
             loaded weights (launches asserted) against the same decode
             from the originals; then LPIPS, I3D, the FID-64 prefix and
             the CMP through `synthesize_aux_checkpoints` /
             `load_aux_checkpoints`: bit-identical tensors, the forwards'
             difference reported
  eval       the codec phase's decoded 1080p GOP scored against its
             synthetic originals on the card: PSNR, MS-SSIM, LPIPS, the
             FID-64 features and the I3D features, seconds of each; held
             against the port's CPU path (PSNR and MS-SSIM on the full
             frames, the networks on a 256 x 256 crop), each within a
             limit that the same metric computed in bf16 (reported beside
             it) exceeds; BD-rates of the published UVG curves
             (`eval.anchors_data`) on the host
  reference  the same pipeline at a tiny config on the card (bf16, kernels)
             against the CPU (fp32, plain versions) on the same weights,
             with the VAE unfused and fused
  tiled_reference
             the tiny pipeline tiled over a 112 x 168 frame (12 tiles of
             64, overlap 16), exact and distilled, fused VAE: the card
             against the CPU on the same weights and noise
  fullwidth  SD-1.5's widths at one layer a block (the UNet's and the
             ControlNet's 320/640/1280/1280, 8 heads, 77 x 768 text,
             inject widths (320, 320, 640, 1280); the whole VAE
             decoder), 64 px frames, batch 1, seeded random weights: the
             `DualFlowControlNet` call (the pyramid's four features, 8
             down residuals, mid residual at scale 1.35), the UNet call
             with the CPU's fp32 residuals and FreeU, the VAE decoder
             unfused and fused; on the card in bf16 with its kernels, on
             the host's CPU in bf16 and in fp32 with the plain versions.
             With relL2(a, b) = ||a - b|| / ||b||, e_ref = relL2(cpu_bf16,
             cpu_fp32), e_card = relL2(card_bf16, cpu_fp32) and d =
             relL2(card_bf16, cpu_bf16), every output holds e_card <=
             1.5 e_ref + 1e-3 and d <= 2.5 e_ref + 1e-3
             (`tests/test_torch_port_fullwidth.py`'s rule, the host's bf16
             in JAX's place).  Launches asserted, count and shape (BH, Lq,
             Lk, D) / (B, H, W, C) / (B, H, W, C, O), as the C entries
             received them: attention at head dims 40/80/160 over 64, 16,
             4 and 1 positions and 77 text tokens, the splats at the
             inject widths' halves plus the metric (161/161/321/641) and
             3, the fused decoder's 29 GN+SiLU+conv (the head's among
             them) and 3 upsample launches
  fulldepth  SD-1.5 whole (2 layers a block: 12 down residuals) at the
             decode's operating point: 512 px (64 x 64 latents), one frame
             with CFG (batch 2), the pyramid, then one step's ControlNet
             call and UNet call (the CPU's fp32 residuals, FreeU) at
             timestep 500, seeded random weights; the card's bf16 against
             the CPU's bf16 and fp32 by `fullwidth`'s rule, output by
             output (12 down residuals, mid, eps); 46 attention launches
             (7 each at 4096, 1024 and 256 positions, 2 at 64, self and
             cross) and 8 splats, counted and recorded by shape
  kernel     (training shapes) the attention forward with its log-sum-exp
             and the backward kernel (dQ, dK and dV in one launch, with its
             delta and dQ-cast passes) against autograd of the plain
             version at every shape of a batch-8 training step (the
             wrapper `attention_bwd`, the whole `attention_backward` and
             SDPA's backward timed beside them);
             the stride-2 conv against its
             plain version and cuDNN at the encoder's three shapes and both
             paddings; the GN+SiLU+conv at the encoder's shapes and the
             splat at the extractor's batch-8 shapes
  train      the training path: `ControlNetTrainer.train_step` at SD-1.5
             full width, batch 8 at 512 x 512, 77 text tokens, the fused VAE
             encoder on the fly, MSE, AdamW lr 1e-5 with clipping at 1.0,
             bf16 compute over fp32 ControlNet masters, seeded random
             weights; TRAIN_STEPS steps (the first includes set-up):
             samples/s from the median step, stage seconds of one step
             synchronised stage by stage, peak memory, launches per step
             (backward attention launches asserted equal to the forward
             launches that need a gradient, 20 GN+SiLU+conv and 3 stride-2
             launches), finite losses, ControlNet masters moved, frozen
             models unmoved, non-zero gradients upstream of the splats
  train_reference
             one step at a tiny config on the card (bf16, kernels) against
             the CPU (fp32, plain versions) on the same weights, batch and
             draws: loss, global gradient norm and the cosine of the
             ControlNet's gradients; again with the LPIPS term (the
             full-width AlexNet LPIPS) and the edge term, the term beside
             its value with the LPIPS network in bf16
  kernel     (residual shapes) the splat's small-channel kernel at the
             residue transform's full-frame shapes: [16, 512, 512, 4] (both
             anchors' RGB and its metric, one launch) and [16, 512, 512, 3]
             (both occlusion checks: a flow and its metric), at B = 8 (one
             direction) too, and at the residual DDPM's [32, 256, 256, c]
             and [16, 256, 256, c]
  train_residual
             the residual second stage's training path: eight captions
             through `HashTokenizer` and the full-width CLIP text encoder
             (bf16), `make_residue_batch` on the card (both anchors warped
             in one splat and both occlusion checks in another, then
             fused: 2 splats at 512 px), then
             `ControlNetTrainer.train_step` with `ResControlNet` at SD-1.5
             width (the encode target the residual, the warped prediction
             to the ControlNet), batch 8 at 512 px, the fused VAE encoder,
             AdamW lr 1e-5 clipped at 1.0, bf16 over fp32 masters;
             TRAIN_STEPS iterations (text, residue batch, step), one
             counted: samples/s from the median iteration, stage seconds
             of one iteration synchronised in turn (text encode, residue
             batch, encode, forward, backward, update), peak memory,
             launches (the train step's as in `train`, 8 splats; the
             residue batch's 2 splats and nothing else; none in the text
             encoder), finite losses, masters moved, frozen UNet, VAE and
             text encoder unmoved, non-zero gradients in the warp extractor
             and upstream of the residue extractor's splats
  residual_reference
             one residual step at a tiny config on the card (bf16, kernels,
             its residue batch made on the card) against the CPU (fp32,
             plain versions): the warped prediction, loss, gradient norm
             and cosine
  residual_ddpm
             the residual pixel DDPM (`UNet2DModel()`, fp32) at
             `train_residual.py`'s defaults: 256 px, batch 16, the residue
             batch made each step, eps-MSE at a timestep per sample in
             [0, 500), AdamW 4e-4; DDPM_STEPS steps: samples/s from the
             median step, peak memory, finite losses, launches (2 splats a
             step); one `ddpm_step` from the UNet's output on the card
             against the same step on the CPU
  kernel     (distillation shapes) attention at BH = 32 (the CFG teacher
             at batch 4, no lse) and BH = 16 (the student, with lse, and
             the backward), the splat at B = 8 and 4 (the teacher's and
             the student's pyramids), the encoder's GN+SiLU+conv and
             stride-2 convs at B = 2
  distill    `ConsistencyDistiller.train_step` at SD-1.5 width at
             `train_distill.py`'s defaults: batch 2 at 512 x 512, 77
             tokens, text and zero uncond embeddings, 50 teacher steps,
             CFG 3.5, ControlNet scale 1.35, Huber (c = 0.001), FreeU, EMA
             0.995, AdamW lr 1e-6 clipped at 1.0, no weight decay, bf16
             working copies of the teacher, the student and the EMA target
             over fp32 masters, seeded random weights, the student warm-
             started from the teacher; TRAIN_STEPS steps on a synthetic
             batch, one counted, then one synchronised stage by stage
             (encode, teacher, student forward, target, backward, update,
             EMA, copy-back): samples/s from the median step, peak
             memory, launches asserted (DISTILL_LAUNCHES), finite losses,
             masters moved, teacher and VAE unmoved bit for bit, one EMA
             tensor against 0.005 new + 0.995 old in fp64, non-zero
             gradients in the student UNet, its ControlNet and upstream of
             the splats
  distill_decode
             the `distill` phase's EMA masters put into a fresh fused-conv
             pipeline by `train.distill.load_student`, then the K = 4
             512 px decode of 7 frames (launches as `decode_distilled`)
  distill_reference
             one distillation step at a tiny config on the card (bf16,
             kernels) against the CPU (fp32, plain versions) on the same
             weights, batch and draws: loss, gradient norm, the gradient
             cosine per network (held to the same step in bf16 on the CPU,
             run beside it), the EMA's move against the rule and against
             the CPU's; then `cli.train_distill`'s loop on the card from a
             tiny diffusers root on a synthetic batch (2 steps at lr 1e-3,
             a checkpoint each), and `run_codec`'s decode options with
             `--distilled_checkpoint`: the restored UNet and ControlNet
             are the bf16 EMA of checkpoint-2 (not the masters, not the
             teacher), and their K = 2 decode matches `DistilledPipeline`
             on the in-memory EMA while the masters' does not
  kernel     (validation shapes) attention at BH = 2 x 8 x 8 (the
             ControlNet trainer's validation: CFG at batch 8, no lse) and
             the fused VAE decoder's GN+SiLU+conv, head and upsample
             entries at B = 8
  train_cli  `cli.train_controlnet`'s `build_trainer` and `train` at SD-1.5
             width on synthetic batches (no PIL here): batch 8 at 512 px,
             AdamW 1e-5, bf16 over fp32 masters, checkpoints and
             validation every 2 steps, 3 steps: samples/s of the median
             step beside the `train` phase's, each step's launches (as
             `train`), the validation's seconds and launches (20 CFG steps
             and the fused decoder), 8 PNG panels decoded here (zlib)
             against the pipeline's uint8 images, the checkpoints' GB/s
             written, peak memory; then `--resume_from_checkpoint latest`
             in a second trainer: the restored state bit-identical to the
             saved one, its step 4 against the first trainer's step 4 on
             the same draws; then `--latent_cache_dir` over 16 samples:
             the cached moments against the fused encoder's, and one step
             from the cache with no encoder launch
  export     `cli.export_checkpoint` on train_cli's checkpoint-2 (1.7 GB),
             loaded by `models.weights.load_sd_checkpoint_dir` into a
             fresh full-width DualFlowControlNet: every tensor the step-2
             fp32 masters bit for bit, seconds and GB/s each way; then
             `--distilled` on distill_cli's checkpoint-2: both files the
             EMA's tensors bit for bit
  approx_drift
             `cli.approx_drift` at its defaults (512 px, 30 steps, batch 7,
             CFG 3.5, FreeU, bf16, SD-1.5 width, weights ~ N(0, 0.02^2)):
             seconds, frames/s and launches of each of the seven modes,
             latent rel-RMS and PSNR against exact; the ControlNet and
             UNet-encoder calls and the attention launches asserted from
             the intervals and the 30 steps
  cmp_train  the CMP trainer (`train.cmp_train`, `train.cmp_config`) at
             the reference's shipped config (resnet50 + skip, 198 logits,
             batch 8 at 384 px, SGD 0.1 / 0.9 / 1e-4, seeded weights,
             synthetic batches sampled as `cli.train_cmp` samples them):
             samples/s of the median of 5 steps, peak memory, launches (0:
             cuDNN runs it, as XLA ran it); one timed step each of
             alexnet_fcn_32x + plain (1,) at batch 12, resnet50 + plain
             (1, 2, 4) and resnet50 + flownet; `quantize_flow`'s bins on
             the card against the CPU's over a sweep with every bin edge;
             one step at 128 px on the card (TF32 off, then on) against
             the CPU; `cli.train_cmp` from the config as JSON (saved,
             resumed bit-identically, its counter continued)
  mesh       this script again under torchrun as a one-rank NCCL group
             (`--mesh-worker`): `parallel.mesh.make_mesh` (1 x 1),
             `ControlNetTrainer.shard_state` and one full-width step (batch
             8, 512 px) against the unsharded step on the same draws (to
             5% of the step's move), `train_controlnet --fsdp 1` through
             the mesh path on synthetic batches, and the dry run's five
             paths (`parallel.dryrun`, tiny models, bf16); each path's
             launches
Then a {"kernels": [...]} line, the `nvidia-smi` name and power limit, and
last {"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import shutil
import tempfile
import time
import types
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from diffcodec_tpu_torch import _kernels
from diffcodec_tpu_torch.codec.gop import gop_schedule
from diffcodec_tpu_torch.codec.runner import (EncodedVideo,
                                              decode_inter_frames,
                                              encode_flows,
                                              make_cmp_densifier)
from diffcodec_tpu_torch.eval import metrics as eval_metrics
from diffcodec_tpu_torch.eval.anchors_data import uvg_rd_curves
from diffcodec_tpu_torch.eval.frechet import make_i3d_feature_fn
from diffcodec_tpu_torch.eval.inception import (InceptionFID64,
                                                make_fid64_feature_fn)
from diffcodec_tpu_torch.eval.plots import bd_rate_table
from diffcodec_tpu_torch.config import (CLIPTextConfig, ControlNetConfig,
                                        DistillConfig, SamplerConfig,
                                        SchedulerConfig, TrainConfig,
                                        UNetConfig, VAEConfig)
from diffcodec_tpu_torch.ops import conv
from diffcodec_tpu_torch.ops.attention import (attention, attention_backward,
                                               attention_bwd,
                                               attention_forward,
                                               attention_reference)
from diffcodec_tpu_torch.ops.launches import (count_launches,
                                              recorded_launches)
from diffcodec_tpu_torch.ops.softsplat import splat_sum, splat_sum_reference
from diffcodec_tpu_torch.ops.tiling import merge_tiles
from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
from diffcodec_tpu_torch.models.cmp import CMP
from diffcodec_tpu_torch.models.controlnet import (DualFlowControlNet,
                                                   ResControlNet)
from diffcodec_tpu_torch.models import weights as checkpoints
from diffcodec_tpu_torch.models.extractors import BiDirResidueExtractor
from diffcodec_tpu_torch.models.i3d import InceptionI3D
from diffcodec_tpu_torch.models.unet2d import UNet2DModel
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL, decode_from_latents
from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule, ddpm_step
from diffcodec_tpu_torch.sampling.tiled import (_crop_batch, sample_tiled,
                                                tile_grid, unit_from_uint8)
from diffcodec_tpu_torch.cli import train_cmp
from diffcodec_tpu_torch.codec.sparse_flow import flow_sampler
from diffcodec_tpu_torch.train import cmp_config
from diffcodec_tpu_torch.train import cmp_train as cmp_train_mod
from diffcodec_tpu_torch.train.checkpoint import (list_checkpoints,
                                                  restore_checkpoint)
from diffcodec_tpu_torch.train.distill import (ConsistencyDistiller,
                                               denoiser, load_student)
from diffcodec_tpu_torch.train.lpips import LPIPS, make_lpips_fn
from diffcodec_tpu_torch.train.residue import (ddpm_optimizer,
                                               ddpm_schedule,
                                               ddpm_train_step,
                                               make_residue_batch)
from diffcodec_tpu_torch.train.trainer import (ControlNetTrainer, Optimizer,
                                               TrainState)
from diffcodec_tpu_torch.utils.tokenizer import HashTokenizer

T0 = time.perf_counter()
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the rate at which L2 added the fp32 floats of the splat's C = 161 kernel,
# measured on the H100 by scripts/splat_kernel_ab.py (PERF.md): the rate
# of splat_bounds' l2_bound_ms
L2_ADD_BYTES_PER_S = 2.2e12

# ~0.1 s of spinning at the H100's ~1.7-2 GHz SM clock (see time_ms)
SPIN_CYCLES = 200_000_000
FRAMES, RES, STEPS = 7, 512, 30   # one GOP-8 of inter frames, bench.py's
BATCH = 2 * FRAMES                # CFG doubles the UNet/ControlNet batch
HEADS = 8
# (Lq, D) of the UNet/ControlNet self-attention at 64/32/16/8 latents, and
# the 77-token text context of the cross-attention
ATTN_SHAPES = [(L, L, D) for L, D in ((4096, 40), (1024, 80), (256, 160),
                                      (64, 160))]
ATTN_SHAPES += [(L, 77, D) for L, _, D in ATTN_SHAPES]
# splats at B = 14 (7 frames x 2 flow directions): features + metric
# channel (161/161/321/641) and the 3-channel occlusion splats
SPLAT_SHAPES = [(64, 161), (32, 161), (16, 321), (8, 641),
                (64, 3), (32, 3), (16, 3), (8, 3)]
# |kernel - plain| <= atol + rtol * |plain|, elementwise.
# Attention: the output is bf16 (8 significant bits), so one ulp of x is at
# most 2^-7 |x|.  The kernel and the plain version round P to bf16 at
# different points (before and after the row sum) and each rounds its
# output once, so an element may differ by about an ulp of itself and,
# where it is small, by an ulp of the largest output: rtol = 2^-7 and
# atol = 2^-7 * max|plain|, set per shape.  The outputs' scale differs
# between shapes (a softmax-weighted mean of 4096 random rows is far
# smaller than one of 64), so one fixed atol would be loose at one end and
# tight at the other.  Over the whole output
# ||kernel - plain|| <= 1e-2 ||plain|| besides: a systematic fault that
# moves every element a little (a wrong scale, a dropped key chunk) shows
# there where no single element crosses its limit.
ATTN_ULP = 2.0 ** -7
ATTN_REL_NORM = 1e-2
# Splat: fp32 atomics add in a varying order.
SPLAT_TOL = dict(atol=1e-5, rtol=1e-5)
# The 3x3 convs, in the attention check's form: bf16 outputs, so one ulp of
# x is at most 2^-7 |x|.  The kernel rounds once (conv + bias + residual
# in fp32); the plain version rounds the conv, then its sum with the
# residual, and sums the taps in another order (the upsample kernel's
# collapsed taps are also rounded to bf16 once more), so an element may
# differ by an ulp of itself and one of the largest output: rtol = 2^-7,
# atol = 2^-7 * max|plain|, with ||kernel - plain|| <= 1e-2 ||plain||.
CONV_ULP = 2.0 ** -7
CONV_REL_NORM = 1e-2
# (B, H, W, C, O, residual) of every GN+SiLU+conv launch of the fused
# decoder, heaviest first, then a UNet resnet's shape for the record (the
# UNet is not routed to the kernel)
GN_SHAPES = [
    (7, 512, 512, 256, 128, False),  # up_3 resnet 0, conv1
    (7, 512, 512, 128, 128, True),   # up_3 conv2 (+ shortcut)
    (7, 512, 512, 128, 128, False),  # up_3 resnets 1-2, conv1
    (7, 256, 256, 512, 256, False),  # up_2 resnet 0, conv1
    (7, 128, 128, 512, 512, True),   # up_1 conv2
    (7, 128, 128, 512, 512, False),  # up_1 conv1
    (7, 256, 256, 256, 256, True),   # up_2 conv2
    (7, 256, 256, 256, 256, False),  # up_2 resnets 1-2, conv1
    (7, 64, 64, 512, 512, True),     # mid and up_0 conv2
    (7, 64, 64, 512, 512, False),    # mid and up_0 conv1
    (7, 512, 512, 128, 3, False),    # the out head
    (14, 64, 64, 320, 320, True),    # a UNet resnet, for the record
]
# (B, H, W, C, O) of the decoder's three upsamplers (input resolution)
UP_SHAPES = [(7, 256, 256, 256, 256), (7, 128, 128, 512, 512),
             (7, 64, 64, 512, 512)]
# row 4's entry (SiLU + conv, the affine compiled out) at the widest
# decoder shape; no decode launches it (see PERF.md)
SILU_SHAPES = [(7, 512, 512, 128, 128)]
# the launch counts of the fused decoder, asserted per decode: 29
# GN+SiLU+conv calls, one of them the out-head (O = 3) on the
# project-then-stencil kernel, and 3 upsample+conv calls
FUSED_VAE_LAUNCHES = {"gn_silu_conv3x3": 29, "conv3x3_head": 1,
                      "upsample_conv3x3": 3}
DISTILL_STEPS = 4
# training: scripts/bench_train.py's point, batch 8 at 512 x 512
TRAIN_BATCH, TRAIN_STEPS = 8, 6
TRAIN_BH = TRAIN_BATCH * HEADS
# the fused encoder's launches in a step: 10 resnets of 2 GN+SiLU+conv, 3
# stride-2 downsamplers
ENCODER_LAUNCHES = {"gn_silu_conv3x3": 20, "downsample_conv3x3": 3}
# (B, H, W, C, O, residual) of the encoder's GN+SiLU+conv launches
ENCODER_GN_SHAPES = [
    (8, 512, 512, 128, 128, False), (8, 512, 512, 128, 128, True),
    (8, 256, 256, 128, 256, False), (8, 256, 256, 256, 256, True),
    (8, 256, 256, 256, 256, False), (8, 128, 128, 256, 512, False),
    (8, 128, 128, 512, 512, True), (8, 128, 128, 512, 512, False),
    (8, 64, 64, 512, 512, True), (8, 64, 64, 512, 512, False)]
# (B, H, W, C, O) of the encoder's stride-2 convs (input resolution)
DOWN_SHAPES = [(8, 512, 512, 128, 128), (8, 256, 256, 256, 256),
               (8, 128, 128, 512, 512)]
# Attention gradients, against autograd of the plain version: the kernels
# round P and dS to bf16 before their products, the plain version P and
# dP, and each rounds its output, so an element differs by a sum of many
# bf16 roundings.  ||kernel - plain|| <= 1e-2 ||plain|| (the forward's
# form) and, elementwise, 2^-5 of itself and of the largest gradient.
GRAD_ULP = 2.0 ** -5
# train_reference: bf16 through the tiny ControlNet, UNet and encoder,
# forward and backward, against fp32 on the CPU.  The loss is a mean over
# all latents (bf16 error averages out); the gradients carry bf16's 2^-8
# relative rounding through a dozen layers.  The LPIPS term: the network
# runs in fp32 (TF32 convs) on the bf16 decode, 4.2e-4 off the CPU's on
# the H100; the same term with the LPIPS network under bf16 autocast (the
# line's `loss_lpips_bf16`) must not pass its limit
TRAIN_REF_TOL = dict(loss_rel=0.02, grad_norm_rel=0.05, grad_cosine=0.98,
                     lpips_rel=1.5e-3)
# the 1080p tiled decode (UVG's and HEVC class B's frame size): 512 px
# tiles overlapping by 64 and feathered over 64, 3 x 5 = 15 tiles a frame
FRAME_H, FRAME_W = 1080, 1920
TILE, OVERLAP, FEATHER = 512, 64, 64
N_TILES = 15
# bench.py's 1080p point (exact, tile_batch 7: chunks of 7, 7 and 1 tiles)
TILED_EXACT_BATCH = 7
# the codec's distilled decode: one GOP-8 (anchors 0 and 8, 7 inter
# frames, one sampler call), a frame's 15 tiles a pipeline call, no CFG;
# so attention at BH = 15 x 8 = 120, splats at B = 30 (two directions)
# and the VAE's convs at B = 15: the kernels' new shapes
CODEC_FRAMES, CODEC_GOP, CODEC_TILE_BATCH = 9, 8, 15
CODEC_INTER = CODEC_FRAMES - 2
# CMP at full width (resnet50 + skip, 198 bins), fp32; card against CPU
# at a small size.  cuDNN's fp32 convs use TF32 by default (operands
# rounded to 10-bit mantissas, 2^-11 relative, fp32 sums): through ~20
# layers in sequence the logits move by ~1e-3 of their norm, which the
# softmax expectation over centres up to 50 px turns into hundredths of a
# pixel, tenths at a few sharp pixels
CMP_SMALL = (64, 96)
CMP_TOL = dict(logit_rel_norm=2e-2, flow_max_abs=0.5, flow_mean_abs=0.05)
# the residual path: the residue transform's splats at 512 px (RGB + its
# metric, a flow + its metric; splat_tile_kernel) at B = 8, and as
# make_residue_batch launches them, both directions in one (B = 16)
# checkpoint: the distilled decode from reloaded weights against the same
# decode from the modules that wrote them, on images in [-1, 1].  Equal
# weights give equal networks (the tensors are compared bit for bit); what
# differs is the order of the splat's fp32 atomics, ~1e-7 relative in the
# pyramid, which 4 bf16 steps of random-weight networks carry to ~0.04 max
# and ~0.004 mean: two decodes of the original differ as much (the line's
# `repeat_*`), so no decode is bit-reproducible.  The bf16 reference
# phase's limits hold it.
CKPT_DECODE_TOL = dict(max_abs=0.25, mean_abs=0.02)
# eval: the card's metrics against the CPU's on the same frames: fp32 sums
# in another order for PSNR (dB) and MS-SSIM, 3.8e-6 dB and 4.0e-7 on the
# H100; the metric networks' convs are TF32 on the card (cuDNN's default,
# 10-bit mantissa) against fp32 on the CPU, as in the CMP check: relative
# norm of the difference, 6e-6 (LPIPS), 1.7e-4 (FID-64), 3.1e-4 (I3D).
# Each limit lies between that reading and what the same metric computed
# in bf16 reads (the line's `bf16_*`: PSNR with its mean squared error in
# bf16, MS-SSIM and the networks under bf16 autocast), so a metric that
# lost its fp32 fails here
EVAL_TOL = dict(psnr_abs=1e-4, ms_ssim_abs=1e-5, lpips_rel_norm=1e-4,
                inception_rel_norm=5e-4, i3d_rel_norm=1e-3)
EVAL_CROP = 256
RESIDUE_SPLAT_SHAPES = [(512, 4), (512, 3)]
# make_residue_batch: both warps in one splat and both occlusion checks in
# another, nothing else
RESIDUE_BATCH_LAUNCHES = {"splat_sum": 2, "attention": 0, "attention_bwd": 0,
                          "gn_silu_conv3x3": 0, "conv3x3_head": 0,
                          "silu_conv3x3": 0, "upsample_conv3x3": 0,
                          "downsample_conv3x3": 0}
# the residue extractor: an occlusion splat and a feature splat at each of
# the 4 scales, both directions batched
RESIDUE_EXTRACTOR_SPLATS = 8
CAPTIONS = ["a man riding a horse along the beach at sunset",
            "two children playing football in a park",
            "a red car driving through a busy city street at night",
            "close-up of a cat's face, shallow depth of field",
            "waves crashing against rocks under a cloudy sky",
            "a crowded market with fruit stalls",
            "an aerial view of a river winding through a forest",
            ""]
# the residual DDPM at train_residual.py's defaults: 256 px, batch 16,
# 500 squaredcos steps, AdamW 4e-4 (fp32)
DDPM_RES, DDPM_BATCH, DDPM_STEPS = 256, 16, 5
# residual_reference: the card's residue batch (fp32 splats, atomics in a
# varying order) against the CPU's: a few ulps of values in [-1, 1]
RESIDUE_TOL = 1e-4
# one ddpm_step on the card against the CPU on the same fp32 inputs: a
# few fp32 ulps of values of order 1
DDPM_STEP_TOL = dict(atol=1e-5, rtol=1e-5)
# consistency distillation at train_distill.py's defaults: batch 2 at 512
# px, AdamW lr 1e-6 with no weight decay, clipped at 1.0; the CFG teacher
# runs at 2B, the student and the EMA target at B
DISTILL_BATCH = 2
DISTILL_TRAIN = TrainConfig(learning_rate=1e-6, adam_weight_decay=0.0,
                            max_grad_norm=1.0)
# a step's launches: 46 attention calls a network (the UNet's 32, the
# ControlNet's 14) in the teacher, the student and the target, a backward
# for each of the student's (its UNet trains too); 8 splats a pyramid
# (occlusion and features at 4 scales), one pyramid a network; the fused
# encoder's convs
DISTILL_LAUNCHES = {"attention": 3 * 46, "attention_bwd": 46,
                    "splat_sum": 3 * 8, **ENCODER_LAUNCHES,
                    "upsample_conv3x3": 0, "conv3x3_head": 0,
                    "silu_conv3x3": 0}
# distill_reference: lr 1e-3, so that the EMA's move (0.005 of the
# masters', ~5e-6) stands ~1000x above the fp32 rounding of the weights
# it moves (at lr 1e-4 the rounding read 6e-3 of it on the CPU).
# bf16 through the tiny teacher (CFG), student and target against fp32 on
# the CPU: the loss chains the teacher's eps, its DDIM step and two x0
# predictions that divide by sqrt(abar_t), so it carries bf16's rounding
# further than the ControlNet step's loss (TRAIN_REF_TOL).  The gradient
# cosine per network against the fp32 CPU's is held to the same step in
# bf16 on the CPU through the plain versions, run beside it: the kernels
# (fp32 accumulators) must round no worse than the plain bf16 path, less
# a margin for two independent roundings.  The UNet's gradients carry more
# bf16 rounding than the ControlNet's: the card read 0.976 and 0.989 on
# the H100, the plain bf16 step 0.952 and 0.971.  The EMA's move on the card against
# 0.005 x the masters' move (fp32 on the card: rounding only), and its
# direction against the CPU's: Adam's first step is ~lr sign(g), so the
# moves agree where the two gradients' signs do
# distill_cli: the decode from the CLI's restored EMA against the same
# weights filled in memory, the same draws: only the splat's fp32 atomics
# can part them (the card read 0.0 at lr 1e-6).  The masters' decode,
# logged beside it, must lie outside
DISTILL_CLI_DECODE_TOL = dict(max_abs=1e-2, mean_abs=1e-4)
DISTILL_REF_TRAIN = TrainConfig(learning_rate=1e-3, adam_weight_decay=0.0,
                                max_grad_norm=1.0)
DISTILL_REF_TOL = dict(loss_rel=0.05, grad_norm_rel=0.05,
                       grad_cosine_below_bf16=0.01, ema_rule_rel=1e-2,
                       ema_cosine=0.5)
# cli.train_controlnet's in-training validation: 20 UniPC steps with CFG
# over a batch of 8 (attention at BH = 2 x 8 x 8, the fused decoder's convs
# at B = 8); the CLI run: 3 steps, then resumed to 4
VAL_BATCH, VAL_STEPS = TRAIN_BATCH, 20
TRAIN_CLI_STEPS = 3
# train_cli's resume: the state restored from checkpoint-3 is held to the
# saved one bit for bit.  Its step 4 against the uninterrupted trainer's
# step 4 (the same state and draws) cannot be: the splat's and the
# attention backward's fp32 atomics add in a varying order, so two runs of
# one step differ (||resumed - uninterrupted|| read 0.0063 of the step's
# move on the H100, a CPU run 0).  A resume fault moves it by far more:
# other draws or lost moments by ~100% (Adam's count, whose slip would
# move it by ~6%, is held exactly: 3 restored, 4 after).  Limit: 5%
TRAIN_CLI_RESUME_REL = 0.05
# the latent cache against the fused encoder on the fly, the same batches
# of 8 in bf16: the cache stores the bf16 moments widened to fp32 (exact),
# so anything past one bf16 ulp (2^-8 of the value and of the largest)
# would be another computation
LATENT_CACHE_ULP = 2.0 ** -8
# the CMP trainer at the reference's shipped config
# (cmp/experiments/semiauto_annot/resnet50_vip+mpii_liteflow/config.yaml):
# resnet50 + skip, 198 logits, batch 8 at 384 px, SGD 0.1, momentum 0.9,
# weight decay 1e-4; the first of CMP_TRAIN_STEPS steps is the warm-up
CMP_SHIPPED = {
    "model": {"arch": "CMP", "total_iter": 42000,
              "lr_steps": [24000, 36000], "lr_mults": [0.1, 0.1], "lr": 0.1,
              "optim": "SGD", "warmup_lr": [], "warmup_steps": [],
              "module": {"arch": "CMP", "image_encoder": "resnet50",
                         "sparse_encoder": "shallownet8x",
                         "flow_decoder": "MotionDecoderSkipLayer",
                         "skip_layer": True, "img_enc_dim": 256,
                         "sparse_enc_dim": 16, "output_dim": 198,
                         "decoder_combo": [1, 2, 4],
                         "pretrained_image_encoder": False,
                         "flow_criterion": "DiscreteLoss", "nbins": 99,
                         "fmax": 50}},
    "data": {"workers": 2, "batch_size": 8, "short_size": 416,
             "crop_size": [384, 384],
             "sample_strategy": ["grid", "watershed"],
             "sample_bg_ratio": 5.74e-5, "nms_ks": 41, "max_num_guide": -1},
    "trainer": {"initial_val": True, "print_freq": 100, "val_freq": 5000,
                "save_freq": 5000, "loss_record": ["loss_flow"],
                "tensorboard": True}}
CMP_TRAIN_STEPS = 6
# the other variants, one timed step each at full width: (module keys,
# batch); the rep_learning AlexNet config trains batches of 12
CMP_VARIANTS = {
    "alexnet_fcn_32x_plain": ({"image_encoder": "alexnet_fcn_32x",
                               "sparse_encoder": "shallownet32x",
                               "flow_decoder": "MotionDecoderPlain",
                               "skip_layer": False,
                               "decoder_combo": [1]}, 12),
    "resnet50_plain": ({"flow_decoder": "MotionDecoderPlain",
                        "skip_layer": False}, 8),
    "resnet50_flownet": ({"flow_decoder": "MotionDecoderFlowNet"}, 8)}
# the card's step against the CPU's at 128 px (batch 8): the loss, and
# the running statistics' and the parameters' distance from the CPU's
# relative to the CPU step's move of them.  fp32 training gradients of a
# random CMP are ill-conditioned: each package's sits 3-8% from the
# float64 gradient on the CPU (tests/test_torch_port_cmp_train.py).  Read
# on an H100 80GB HBM3 at 700 W with cuDNN's TF32 off: 1.0e-7, 2.1e-6 and
# 0.031; with it on (how the card runs): 2.8e-4, 1.0e-3 and 0.84.  Each
# limit sits between the two; the TF32-off step is held to them
CMP_REF_CROP = 128
CMP_TRAIN_TOL = dict(loss_rel=1e-5, stats_rel_move=1e-4, params_rel_move=0.2)
# the mesh: a one-rank NCCL group's sharded step against the unsharded
# one from the same state, both on the card (the splat's and dQ's fp32
# atomics), as train_cli holds resume.  At the first step from fresh
# moments the two read 0.057 apart (every element moves by +-lr there, so
# a gradient's sign flipped near 0 counts fully); hence step 2
MESH_STEP_REL = 0.05
MESH_TIMEOUT_S = 900


def compare(label: str, got, want, atol: float, rtol: float) -> float:
    """Max abs error; raises where |got - want| > atol + rtol * |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    limit = atol + rtol * want.abs()
    if not bool((diff <= limit).all()):
        worst = (diff - limit).argmax()
        raise AssertionError(
            f"{label}: max abs error {diff.max().item()}; at the worst "
            f"element {diff.flatten()[worst].item()} > "
            f"{limit.flatten()[worst].item()}")
    return diff.max().item()


def log(phase: str, **fields):
    print(json.dumps({"phase": phase,
                      "t": round(time.perf_counter() - T0, 3), **fields}),
          flush=True)


def time_ms(fn, reps: int) -> float:
    """Median ms of `reps` calls after one warm-up, each call between its
    own pair of CUDA events, so that one host stall moves one sample and
    not the result.  The card first spins for ~0.1 s (`torch.cuda._sleep`)
    while the host queues every call, so the calls then run back to back
    and each pair of events brackets device time, not the host's time to
    launch the call."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SPIN_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(flops: float, nbytes: float, peak_flops: float):
    """Least time the card could take: (ms, 'operations' | 'bytes'), each
    input read once and each output written once."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _attention_close(label, got, want, ulp) -> tuple:
    """(max abs error, ||error|| / ||plain||), raising past the limits:
    elementwise `ulp` of each element and of the largest, and the norm
    limit ATTN_REL_NORM."""
    err = compare(label, got, want, ulp * want.float().abs().max().item(),
                  ulp)
    rel = ((got.float() - want.float()).norm()
           / want.float().norm()).item()
    if not rel <= ATTN_REL_NORM:
        raise AssertionError(f"{label}: ||error|| / ||plain|| = {rel} > "
                             f"{ATTN_REL_NORM}")
    return err, rel


def check_attention(gen, BH: int = BATCH * HEADS) -> list:
    rows = []
    for Lq, Lk, D in ATTN_SHAPES:
        q, k, v = (torch.randn(BH, L, D, device="cuda", generator=gen)
                   .bfloat16() for L in (Lq, Lk, Lk))
        scale = D ** -0.5
        got = attention(q, k, v, scale)
        want = attention_reference(q, k, v, scale)
        tol = dict(atol=ATTN_ULP * want.float().abs().max().item(),
                   rtol=ATTN_ULP, rel_norm=ATTN_REL_NORM)
        err, rel_norm = _attention_close(f"attention {[BH, Lq, Lk, D]}",
                                         got, want, ATTN_ULP)
        del got, want
        reps = 5 if Lq >= 1024 else 20
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # q.k and p.v: 2 * 2 * Lq * Lk * D FLOP; q, o, k, v in bf16
        b_ms, b_by = bound(4.0 * BH * Lq * Lk * D, 2 * 2 * BH * D * (Lq + Lk),
                           PEAK_BF16_FLOPS)
        row = dict(kernel="attention", shape=[BH, Lq, Lk, D], max_abs_err=err,
                   rel_norm_err=rel_norm, tol=tol,
                   ms=time_ms(lambda: attention(q, k, v, scale), reps),
                   plain_ms=time_ms(
                       lambda: attention_reference(q, k, v, scale), reps),
                   library_ms=time_ms(
                       lambda: sdpa(q[None], k[None], v[None], scale=scale),
                       reps),
                   bound_ms=b_ms, bound_by=b_by)
        log("kernel", **row)
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def smooth_flow(gen, B: int, R: int) -> torch.Tensor:
    """[B, R, R, 2] flows as the codec and the residual trainer see them
    (smooth RAFT fields, not noise): per sample a translation uniform in
    [-8, 8] pixels, plus a random field at 1/32 of the frame, upsampled
    bilinearly and scaled to a standard deviation of 2 pixels."""
    g = max(1, R // 32)
    field = F.interpolate(
        torch.randn(B, 2, g, g, device="cuda", generator=gen), size=(R, R),
        mode="bilinear", align_corners=False)
    field = field * (2.0 / field.std().clamp_min(1e-6))
    shift = (torch.rand(B, 2, 1, 1, device="cuda", generator=gen) * 2 - 1) * 8
    return (field + shift).permute(0, 2, 3, 1).contiguous()


# the splat's flows: i.i.d. noise of 3 pixels (every neighbour's target
# elsewhere: the worst case for the reductions) and a smooth field
SPLAT_FLOWS = ("wide", "smooth")


def splat_inputs(gen, B: int, R: int, C: int, kind: str):
    """vals ~ N(0, 1) [B, R, R, C] and a `kind` flow ('wide': 3 N(0, 1)
    pixels, 'local': 0.5 N(0, 1), 'smooth': `smooth_flow`), with a NaN, an
    off-frame and a -1e9 row (B >= 3)."""
    vals = torch.randn(B, R, R, C, device="cuda", generator=gen)
    if kind == "smooth":
        flow = smooth_flow(gen, B, R)
    else:
        scale = {"wide": 3.0, "local": 0.5}[kind]
        flow = torch.randn(B, R, R, 2, device="cuda", generator=gen) * scale
    flow[0, 1, :4, 0] = float("nan")        # dropped pixels
    flow[1, :, -1, 0] = R + 2.0             # lands out of frame
    flow[2, 0, :, 1] = -1e9
    return vals, flow


def splat_bounds(flow: torch.Tensor, C: int) -> dict:
    """The splat's bound on these inputs: bytes read and written over
    HBM's rate against a multiply and an add a corner and channel over
    the fp32 rate (bound_ms, bound_by); and l2_bound_ms, the floats it
    would add with one reduction for each corner that lands in the frame
    (C floats each) over L2_ADD_BYTES_PER_S: a model, not a bound, since a
    kernel that sums the corners of a destination first adds fewer."""
    B, H, W, _ = flow.shape
    n = B * H * W
    b_ms, b_by = bound(4 * 2 * n * C, 4 * n * (2 * C + 2), PEAK_FP32_FLOPS)
    fx = torch.arange(W, device=flow.device) + flow[..., 0]
    fy = torch.arange(H, device=flow.device)[:, None] + flow[..., 1]
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    x0 = torch.where(finite, fx, -10.0).floor()
    y0 = torch.where(finite, fy, -10.0).floor()
    inside = sum(int(((x0 + kx >= 0) & (x0 + kx < W) & (y0 + ky >= 0)
                      & (y0 + ky < H)).sum())
                 for kx in (0, 1) for ky in (0, 1))
    return dict(bound_ms=b_ms, bound_by=b_by,
                l2_bound_ms=4 * C * inside / L2_ADD_BYTES_PER_S * 1e3)


def check_splat(gen, batch: int = BATCH, shapes=SPLAT_SHAPES) -> list:
    """The splat at (R, C) `shapes` (default: the extractor's) for `batch`
    splats (2 flow directions per sample in the extractor), under each
    kind of flow of SPLAT_FLOWS."""
    rows = []
    for R, C in shapes:
        for kind in SPLAT_FLOWS:
            vals, flow = splat_inputs(gen, batch, R, C, kind)
            err = compare(f"splat_sum {[batch, R, R, C]} {kind}",
                          splat_sum(vals, flow),
                          splat_sum_reference(vals, flow), **SPLAT_TOL)
            row = dict(kernel="splat_sum", shape=[batch, R, R, C], flow=kind,
                       max_abs_err=err, tol=SPLAT_TOL,
                       ms=time_ms(lambda: splat_sum(vals, flow), 20),
                       plain_ms=time_ms(
                           lambda: splat_sum_reference(vals, flow), 20),
                       library_ms=None, **splat_bounds(flow, C))
            log("kernel", **row)
            rows.append(row)
            del vals, flow
    return rows


def _conv_inputs(gen, B, H, W, C, O):
    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale
    return dict(x=randn(B, H, W, C).bfloat16(),
                scale=randn(B, C, scale=0.25) + 1.0, shift=randn(B, C),
                weight=randn(O, C, 3, 3, scale=(9 * C) ** -0.5).bfloat16(),
                bias=randn(O, scale=0.1).bfloat16())


def _conv_row(name, shape, got, want, fn, plain, library, reps, taps,
              nbytes, out_pixels=None, library_label=None) -> dict:
    """Check `got` against `want` (the CONV tolerance), time the kernel,
    the plain version and the library call, and bound the work: 2 * taps
    FLOP per pixel, input channel and output channel (taps = 9, or 16
    collapsed for the upsample; the input's pixels, or `out_pixels` for
    the stride-2 conv), and `nbytes` moved."""
    B, H, W, C, O = shape[:5]
    label = f"{name} {list(shape)}"
    tol = dict(atol=CONV_ULP * want.float().abs().max().item(),
               rtol=CONV_ULP, rel_norm=CONV_REL_NORM)
    err = compare(label, got, want, tol["atol"], tol["rtol"])
    rel_norm = ((got.float() - want.float()).norm()
                / want.float().norm()).item()
    if not rel_norm <= tol["rel_norm"]:
        raise AssertionError(f"{label}: ||error|| / ||plain|| = {rel_norm} "
                             f"> {tol['rel_norm']}")
    pixels = B * H * W if out_pixels is None else out_pixels
    b_ms, b_by = bound(2.0 * taps * pixels * C * O, nbytes, PEAK_BF16_FLOPS)
    row = dict(kernel=name, shape=list(shape), max_abs_err=err,
               rel_norm_err=rel_norm, tol=tol, ms=time_ms(fn, reps),
               plain_ms=time_ms(plain, reps), library_ms=time_ms(library,
                                                                 reps),
               library=library_label or (
                   "F.conv2d (cuDNN, channels-last) of the input "
                   + ("already upsampled" if taps == 16 else
                      "already activated")
                   + ": the conv part of the function"),
               bound_ms=b_ms, bound_by=b_by)
    log("kernel", **row)
    return row


def check_gn_conv(gen, shapes) -> list:
    """The GN+SiLU+conv kernel at (B, H, W, C, O, residual) `shapes`: the
    Hopper loop, or where O <= conv.HEAD_MAX_O the project-then-stencil
    kernel (its rows named `conv3x3_head`)."""
    rows = []
    for B, H, W, C, O, residual in shapes:
        a = _conv_inputs(gen, B, H, W, C, O)
        x, sc, sh, w, b = (a[k] for k in ("x", "scale", "shift", "weight",
                                          "bias"))
        res = (torch.randn(B, H, W, O, device="cuda", generator=gen)
               .bfloat16() if residual else None)
        act = F.silu((x.float() * sc[:, None, None, :]
                      + sh[:, None, None, :]).bfloat16())
        act_nchw = act.permute(0, 3, 1, 2)
        n_out = B * H * W * O
        rows.append(_conv_row(
            "conv3x3_head" if O <= conv.HEAD_MAX_O else "gn_silu_conv3x3",
            (B, H, W, C, O, residual),
            conv.gn_silu_conv3x3(x, sc, sh, w, b, res),
            conv.gn_silu_conv3x3_ref(x, sc, sh, w, b, res),
            lambda: conv.gn_silu_conv3x3(x, sc, sh, w, b, res),
            lambda: conv.gn_silu_conv3x3_ref(x, sc, sh, w, b, res),
            lambda: F.conv2d(act_nchw, w, b, padding=1),
            5 if H >= 256 else 20, 9,
            # x, out, residual, weights in bf16; scale, shift, bias fp32
            2 * (B * H * W * C + n_out * (2 if residual else 1)
                 + 9 * C * O) + 4 * (2 * B * C + O)))
        del a, x, res, act, act_nchw
        torch.cuda.empty_cache()
    return rows


def check_upsample(gen, shapes) -> list:
    """The upsample+conv kernel at (B, H, W, C, O) `shapes` (input
    resolution)."""
    rows = []
    for B, H, W, C, O in shapes:
        a = _conv_inputs(gen, B, H, W, C, O)
        x, w, b = a["x"], a["weight"], a["bias"]
        up_nchw = (x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
                   .reshape(B, 2 * H, 2 * W, C).permute(0, 3, 1, 2))
        rows.append(_conv_row(
            "upsample_conv3x3", (B, H, W, C, O),
            conv.upsample_conv3x3(x, w, b),
            conv.upsample_conv3x3_ref(x, w, b),
            lambda: conv.upsample_conv3x3(x, w, b),
            lambda: conv.upsample_conv3x3_ref(x, w, b),
            lambda: F.conv2d(up_nchw, w, b, padding=1),
            5, 16, 2 * (B * H * W * C + 4 * B * H * W * O + 9 * C * O)
            + 4 * O))
        del a, x, up_nchw
        torch.cuda.empty_cache()
    return rows


def check_conv(gen) -> list:
    """Each conv kernel at every shape the fused decoder gives it."""
    rows = check_gn_conv(gen, GN_SHAPES) + check_upsample(gen, UP_SHAPES)
    for B, H, W, C, O in SILU_SHAPES:
        a = _conv_inputs(gen, B, H, W, C, O)
        x, w, b = a["x"], a["weight"], a["bias"]
        act_nchw = F.silu(x).permute(0, 3, 1, 2)
        rows.append(_conv_row(
            "silu_conv3x3", (B, H, W, C, O), conv.silu_conv3x3(x, w, b),
            conv.silu_conv3x3_ref(x, w, b),
            lambda: conv.silu_conv3x3(x, w, b),
            lambda: conv.silu_conv3x3_ref(x, w, b),
            lambda: F.conv2d(act_nchw, w, b, padding=1),
            5, 9, 2 * (B * H * W * (C + O) + 9 * C * O) + 4 * O))
        del a, x, act_nchw
        torch.cuda.empty_cache()
    return rows


@torch.no_grad()
def fill_params(module: torch.nn.Module, gen: torch.Generator):
    """Seeded random weights made on the card: kernels ~ N(0, 1/fan_in),
    norm scales ~ 1 + N(0, 0.1^2), biases ~ N(0, 0.02^2)."""
    for name, p in module.named_parameters():
        r = torch.randn(p.shape, device=p.device, generator=gen)
        if p.dim() > 1:
            p.copy_(r * p[0].numel() ** -0.5)
        elif name.endswith("weight"):
            p.copy_(1.0 + 0.1 * r)
        else:
            p.copy_(0.02 * r)


def make_inputs(gen, B, H, ctx_dim, device, dtype):
    def randn(*shape):
        return torch.randn(shape, device=device, generator=gen)
    return dict(latents=randn(B, H // 8, H // 8, 4),
                text=(randn(B, 77, ctx_dim) * 0.02).to(dtype),
                uncond=torch.zeros(B, 77, ctx_dim, device=device,
                                   dtype=dtype),
                cond=(torch.rand((B, H, H, 6), device=device, generator=gen)
                      * 2 - 1).to(dtype),
                flow=(randn(B, H, H, 4) * 4).to(dtype))


def run(pipe, x):
    return pipe.sample(x["latents"], x["text"], x["uncond"], x["cond"],
                       x["flow"])


def build_decode(gen, steps: int = STEPS):
    """The main path's pipeline on the card with seeded random weights,
    and its inputs: (pipe, x) for `run(pipe, x)`."""
    unet_cfg = UNetConfig()
    pipe = DualFlowPipeline.create(
        unet_cfg, ControlNetConfig(unet=unet_cfg), VAEConfig(),
        SamplerConfig(num_inference_steps=steps, guidance_scale=3.5,
                      controlnet_conditioning_scale=1.35, freeu=True),
        dtype=torch.bfloat16, device="cuda")
    for m in (pipe.unet, pipe.controlnet, pipe.vae):
        fill_params(m, gen)
    x = make_inputs(gen, FRAMES, RES, unet_cfg.cross_attention_dim, "cuda",
                    torch.bfloat16)
    return pipe, x


def timed(fn):
    """(fn(), host seconds), the card synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t


def counted(fn):
    """(fn(), seconds, launches of each kernel in that call)."""
    (result, launches), seconds = timed(lambda: count_launches(fn))
    return result, seconds, launches


def check_images(label, images, frames=FRAMES, res=RES):
    if tuple(images.shape) != (frames, res, res, 3):
        raise AssertionError(f"{label}: shape {tuple(images.shape)}")
    if not torch.isfinite(images).all():
        raise AssertionError(f"{label}: non-finite values")


# decode: the main path against itself on the same inputs (no draws: the
# noise comes in).  On one pyramid every kernel it launches is
# deterministic, so two denoise loops agree bit for bit.  A pyramid made
# again differs by the order of the splat's fp32 atomics, ~1e-7 relative
# before its bf16 rounding: each level within one bf16 rounding (2^-8)
# of the first, by relL2.  The 30 bf16 steps of random-weight networks
# carry that to the images further than the 4-step decode's ~0.04 max and
# ~0.004 mean (the checkpoint phase's `repeat_*`): 0.045-0.049 and
# 0.0030-0.0053 in three pairs on the H100, so two whole decodes' images
# are held to the reference phase's bf16 limits
DECODE_REPEAT_TOL = dict(pyramid_rel=2.0 ** -8, image_max_abs=0.25,
                         image_mean_abs=0.02)
# a decode runs no backward and no encoder
NO_TRAIN_KERNELS = {"attention_bwd": 0, "downsample_conv3x3": 0}


def check_launches(label, launches, expected):
    """expected: name -> exact count, or None for "at least once"."""
    for name, n in expected.items():
        if (n is None and launches[name] <= 0) or (n is not None
                                                   and launches[name] != n):
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times, expected "
                                 f"{'> 0' if n is None else n}")


def decode(gen):
    """The main path once with launch counts, once more for the
    steady-state time, then its stages timed apart.  Returns the line's
    fields, the pipeline, its inputs and the final latents."""
    pipe, x = build_decode(gen)
    n_params = sum(p.numel() for m in (pipe.unet, pipe.controlnet, pipe.vae)
                   for p in m.parameters())
    log("decode_setup", params=n_params)

    torch.cuda.reset_peak_memory_stats()
    images, first_s, launches = counted(lambda: run(pipe, x))
    check_images("decode", images)
    # the exact point stays on cuDNN: no conv kernel
    check_launches("decode", launches, {
        "attention": None, "splat_sum": None, "gn_silu_conv3x3": 0,
        "conv3x3_head": 0, "upsample_conv3x3": 0, "silu_conv3x3": 0,
        **NO_TRAIN_KERNELS})

    images2, second_s = timed(lambda: run(pipe, x))
    # the pyramid alone, the denoise loop (pyramid included), the VAE
    with torch.no_grad():
        _, pyramid_s = timed(lambda: pipe.controlnet.extract_pyramid(
            x["cond"], x["flow"]))

    final, denoise_s = timed(lambda: pipe.denoise(
        x["latents"], x["text"], x["uncond"], x["cond"], x["flow"]))
    with torch.no_grad():
        _, vae_s = timed(lambda: decode_from_latents(pipe.vae, final))
    repeat = decode_repeat(pipe, x, images, images2, final)
    out = dict(frames=FRAMES, res=RES, steps=STEPS, first_s=first_s,
               second_s=second_s, frames_per_s=FRAMES / second_s,
               stages_s=dict(pyramid=pyramid_s, denoise=denoise_s,
                             vae=vae_s),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches, repeat=repeat,
               image_mean_abs=images.float().abs().mean().item(),
               image_std=images.float().std().item())
    log("decode", **out)
    if not repeat["ok"]:
        raise AssertionError(f"decode: a second decode of the same inputs "
                             f"differs past the splat's atomics: {repeat}")
    return out, pipe, x, final


@torch.no_grad()
def decode_repeat(pipe, x, images, images2, final) -> dict:
    """The main path against itself on the same inputs: two denoise loops
    on one pyramid (the splat's atomics run once) bit for bit, latents and
    images; a pyramid made again within a bf16 rounding of the first, level
    by level; two whole decodes' images within the reference phase's
    limits (DECODE_REPEAT_TOL), their latents' difference logged."""
    pyramid = pipe.controlnet.extract_pyramid(x["cond"], x["flow"])
    pyramid2 = pipe.controlnet.extract_pyramid(x["cond"], x["flow"])
    pipe.controlnet.extract_pyramid = lambda cond, flow: pyramid
    try:
        again = [pipe.denoise(x["latents"], x["text"], x["uncond"],
                              x["cond"], x["flow"]) for _ in range(2)]
    finally:
        del pipe.controlnet.extract_pyramid
    shown = [decode_from_latents(pipe.vae, z) for z in again]
    di = (images2.float() - images.float()).abs()
    dl = (again[0].float() - final.float()).abs()
    ref = final.float().abs()
    out = dict(one_pyramid_equal=dict(
                   latents=torch.equal(again[0], again[1]),
                   images=torch.equal(shown[0], shown[1])),
               pyramid_rel=[rel_norm(b, a) for a, b in zip(pyramid,
                                                           pyramid2)],
               image_max_abs=di.max().item(), image_mean_abs=di.mean().item(),
               latent_max_rel=(dl.max() / ref.max()).item(),
               latent_mean_rel=(dl.mean() / ref.mean()).item(),
               tol=DECODE_REPEAT_TOL)
    tol = DECODE_REPEAT_TOL
    out["ok"] = (all(out["one_pyramid_equal"].values())
                 and max(out["pyramid_rel"]) <= tol["pyramid_rel"]
                 and out["image_max_abs"] <= tol["image_max_abs"]
                 and out["image_mean_abs"] <= tol["image_mean_abs"])
    return out


def fused_vae_of(vae: AutoencoderKL) -> AutoencoderKL:
    """A fused-conv copy of `vae` with its weights, on its device."""
    p = next(vae.parameters())
    with torch.device(p.device):
        fused = AutoencoderKL(vae.cfg, fused_conv=True)
    fused.load_state_dict(vae.state_dict())
    return fused.to(p.dtype).eval().requires_grad_(False)


def decode_fusedconv(pipe, x, final) -> tuple:
    """The main path with fused_conv=True on the same models and inputs;
    its VAE against the cuDNN one on the same final latents."""
    fused = dataclasses.replace(pipe, vae=fused_vae_of(pipe.vae))
    torch.cuda.reset_peak_memory_stats()
    images, first_s, launches = counted(lambda: run(fused, x))
    check_images("decode_fusedconv", images)
    check_launches("decode_fusedconv", launches,
                   {"attention": None, "splat_sum": None, "silu_conv3x3": 0,
                    **FUSED_VAE_LAUNCHES, **NO_TRAIN_KERNELS})
    _, second_s = timed(lambda: run(fused, x))
    with torch.no_grad():
        _, pyramid_s = timed(lambda: fused.controlnet.extract_pyramid(
            x["cond"], x["flow"]))
        _, denoise_s = timed(lambda: fused.denoise(
            x["latents"], x["text"], x["uncond"], x["cond"], x["flow"]))
        got, vae_s = timed(lambda: decode_from_latents(fused.vae, final))
        want = decode_from_latents(pipe.vae, final)
    diff = (got.float().clamp(-1, 1) - want.float().clamp(-1, 1)).abs()
    # bf16 through ~30 convs rounded at other places (the kernel rounds
    # each conv + bias + residual once, the cuDNN path two or three
    # times), on images in [-1, 1]: the reference phase's limits
    tol = dict(max_abs=0.25, mean_abs=0.02)
    vs_cudnn = dict(max_abs_err=diff.max().item(),
                    mean_abs_err=diff.mean().item(), tol=tol)
    out = dict(frames=FRAMES, res=RES, steps=STEPS, first_s=first_s,
               second_s=second_s, frames_per_s=FRAMES / second_s,
               stages_s=dict(pyramid=pyramid_s, denoise=denoise_s,
                             vae=vae_s),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches, vae_vs_cudnn=vs_cudnn,
               image_mean_abs=images.float().abs().mean().item())
    log("decode_fusedconv", **out)
    if not (vs_cudnn["max_abs_err"] <= tol["max_abs"]
            and vs_cudnn["mean_abs_err"] <= tol["mean_abs"]):
        raise AssertionError(f"fused VAE disagrees with cuDNN's: {vs_cudnn}")
    return out, fused


def decode_distilled(fused, x, gen) -> dict:
    """K-step consistency decode over the fused pipeline's models: no
    CFG, so no uncond embeddings; the K - 1 re-noises from `gen`."""
    dpipe = DistilledPipeline.from_pipeline(
        fused, DistillConfig(num_student_steps=DISTILL_STEPS))

    def go():
        return dpipe.sample(x["latents"], x["text"], x["cond"], x["flow"],
                            generator=gen)

    torch.cuda.reset_peak_memory_stats()
    images, first_s, launches = counted(go)
    check_images("decode_distilled", images)
    check_launches("decode_distilled", launches,
                   {"attention": None, "splat_sum": None, "silu_conv3x3": 0,
                    **FUSED_VAE_LAUNCHES, **NO_TRAIN_KERNELS})
    _, second_s = timed(go)
    out = dict(frames=FRAMES, res=RES, steps=DISTILL_STEPS,
               timesteps=[int(t) for t in dpipe.step_schedule()],
               first_s=first_s, second_s=second_s,
               frames_per_s=FRAMES / second_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches,
               image_mean_abs=images.float().abs().mean().item())
    log("decode_distilled", **out)
    return out


def reference_check():
    """Tiny pipeline: card (bf16, kernels) against CPU (fp32, plain), with
    the VAE unfused and fused."""
    vae_cfg = VAEConfig(base_channels=8, channel_mults=(1, 1, 2, 2),
                        layers_per_block=1)
    sampler = SamplerConfig(num_inference_steps=3)
    cpu = DualFlowPipeline.create(UNetConfig.tiny(), ControlNetConfig.tiny(),
                                  vae_cfg, sampler, dtype=torch.float32,
                                  device="cpu")
    card = DualFlowPipeline.create(UNetConfig.tiny(),
                                   ControlNetConfig.tiny(), vae_cfg, sampler,
                                   dtype=torch.bfloat16, device="cuda")
    for c, g in ((cpu.unet, card.unet), (cpu.controlnet, card.controlnet),
                 (cpu.vae, card.vae)):
        fill_params(c, torch.Generator().manual_seed(7))
        g.load_state_dict(c.state_dict())
    x = make_inputs(torch.Generator().manual_seed(8), 2, 64, 32, "cpu",
                    torch.float32)
    # the initial noise stays fp32, as the pipeline carries it
    x_card = {k: v.cuda() if k == "latents" else v.cuda().bfloat16()
              for k, v in x.items()}
    # bf16 (8-bit mantissa) through the networks and 3 UniPC steps against
    # fp32 on the CPU
    tol = dict(max_abs=0.25, mean_abs=0.02)
    for mode, fused in (("unfused", False), ("fused", True)):
        if fused:
            cpu = dataclasses.replace(cpu, vae=fused_vae_of(cpu.vae))
            card = dataclasses.replace(card, vae=fused_vae_of(card.vae))
        want = run(cpu, x)
        got, _, launches = counted(lambda: run(card, x_card))
        expected = {"attention": None, "splat_sum": None}
        if fused:  # the tiny decoder's out-head is 8 -> 3
            expected.update(gn_silu_conv3x3=None, conv3x3_head=None,
                            upsample_conv3x3=None)
        check_launches(f"reference ({mode})", launches, expected)
        diff = (got.float().cpu() - want).abs()
        out = dict(vae=mode, max_abs_err=diff.max().item(),
                   mean_abs_err=diff.mean().item(), tol=tol,
                   want_mean_abs=want.abs().mean().item(),
                   launches=launches)
        log("reference", **out)
        if not (out["max_abs_err"] <= tol["max_abs"]
                and out["mean_abs_err"] <= tol["mean_abs"]):
            raise AssertionError(f"tiny decode on the card disagrees with "
                                 f"the CPU: {out}")


def check_tiled_kernels(gen) -> list:
    """Every kernel at the shapes the codec's tiled decode gives it and
    the 512 px decodes do not: a chunk of 15 tiles through the distilled
    pipeline (attention at BH = 120, splats at B = 30, the VAE's convs at
    B = 15)."""
    b = CODEC_TILE_BATCH
    return (check_attention(gen, b * HEADS) + check_splat(gen, 2 * b)
            + check_gn_conv(gen, [(b,) + s[1:] for s in GN_SHAPES
                                  if s[0] == FRAMES])
            + check_upsample(gen, [(b,) + s[1:] for s in UP_SHAPES]))


@torch.no_grad()
def fill_cmp(model: CMP, gen: torch.Generator):
    """Seeded random CMP weights: `fill_params`, with the convs' kernels
    scaled to N(0, 1.3 / fan_in) so the bin logits keep a spread of a few
    units through the 60 layers (`tests/test_torch_port_cmp.py`), and
    BatchNorm running means ~ N(0, 0.1^2), variances in [0.5, 1.5]."""
    fill_metric_net(model, gen)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.mul_(1.3 ** 0.5)


def sparse_input(gen, H, W, device, points=150):
    """An image in [0, 1] and a sparse field of `points` flow vectors
    (uniform in +-20 px) with their mask: the CMP's inputs."""
    image = torch.rand((1, H, W, 3), device=device, generator=gen)
    sparse = torch.zeros((1, H, W, 4), device=device)
    ys = torch.randint(0, H, (points,), device=device, generator=gen)
    xs = torch.randint(0, W, (points,), device=device, generator=gen)
    sparse[0, ys, xs, :2] = (torch.rand((points, 2), device=device,
                                        generator=gen) * 40 - 20)
    sparse[0, ys, xs, 2:] = 1.0
    return image, sparse


def build_cmp():
    """DiffCodec's CMP at full width with seeded random weights and
    running statistics: (on the CPU, a copy on the card)."""
    cpu = CMP().eval()
    fill_cmp(cpu, torch.Generator().manual_seed(11))
    return cpu, copy.deepcopy(cpu).cuda()


@torch.no_grad()
def cmp_phase():
    """CMP at full width on the card: ms a call at 1080 x 1920 and peak
    memory, then the card against the CPU at CMP_SMALL on the same
    weights.  Returns (its line, the model on the card)."""
    cpu, card = build_cmp()
    n_params = sum(p.numel() for p in card.parameters())
    image, sparse = sparse_input(
        torch.Generator(device="cuda").manual_seed(12), FRAME_H, FRAME_W,
        "cuda")
    torch.cuda.reset_peak_memory_stats()
    flow = card(image, sparse)
    if tuple(flow.shape) != (1, FRAME_H, FRAME_W, 2) or not bool(
            torch.isfinite(flow).all()):
        raise AssertionError(f"cmp: {tuple(flow.shape)}, finite "
                             f"{bool(torch.isfinite(flow).all())}")
    ms = time_ms(lambda: card(image, sparse), 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del image, sparse, flow

    image, sparse = sparse_input(torch.Generator().manual_seed(13),
                                 *CMP_SMALL, "cpu")
    want_logits, want = cpu.logits(image, sparse), cpu(image, sparse)
    got_logits = card.logits(image.cuda(), sparse.cuda()).cpu()
    got = card(image.cuda(), sparse.cuda()).cpu()
    diff = (got - want).abs()
    out = dict(res=[FRAME_H, FRAME_W], params=n_params, ms=ms,
               peak_mem_gib=peak, vs_cpu=dict(
                   res=list(CMP_SMALL),
                   logit_rel_norm_err=((got_logits - want_logits).norm()
                                       / want_logits.norm()).item(),
                   logit_std=want_logits.std().item(),
                   flow_max_abs_err=diff.max().item(),
                   flow_mean_abs_err=diff.mean().item(),
                   flow_std=want.std().item(), tol=CMP_TOL))
    log("cmp", **out)
    v = out["vs_cpu"]
    if not (v["logit_rel_norm_err"] <= CMP_TOL["logit_rel_norm"]
            and v["flow_max_abs_err"] <= CMP_TOL["flow_max_abs"]
            and v["flow_mean_abs_err"] <= CMP_TOL["flow_mean_abs"]):
        raise AssertionError(f"CMP on the card disagrees with the CPU: {v}")
    return out, card


def check_frames(label, images, shape):
    if tuple(images.shape) != shape:
        raise AssertionError(f"{label}: shape {tuple(images.shape)}")
    if not np.isfinite(images).all() or np.abs(images).max() > 1.0:
        raise AssertionError(f"{label}: values outside [-1, 1]")


def launches_times(n: int) -> dict:
    """The fused VAE's launches in `n` decodes."""
    return {k: n * v for k, v in FUSED_VAE_LAUNCHES.items()}


def build_tiled_exact(fused, gen):
    """bench.py's 1080p point on `fused` (the exact pipeline with the fused
    VAE): 30 UniPC steps, CFG 3.5, ControlNet scale 1.35, FreeU, tiles of
    7 a call, uint8 conditioning.  Returns (go, cond, flow): go() decodes
    one 1080p frame, the same noise each call."""
    rng = np.random.default_rng(21)
    cond = rng.integers(0, 256, (1, FRAME_H, FRAME_W, 6), dtype=np.uint8)
    flow = rng.standard_normal((1, FRAME_H, FRAME_W, 4),
                               dtype=np.float32) * 4
    ctx = fused.unet.cfg.cross_attention_dim
    text = (torch.randn((1, 77, ctx), device="cuda", generator=gen)
            * 0.02).bfloat16()
    noise = torch.Generator(device="cuda")

    def go():
        noise.manual_seed(22)
        return sample_tiled(fused, text, torch.zeros_like(text), cond, flow,
                            tile=(TILE, TILE), overlap=OVERLAP,
                            feather=FEATHER, tile_batch=TILED_EXACT_BATCH,
                            generator=noise)

    return go, cond, flow


def tiled_exact(fused, gen) -> dict:
    """One 1080p frame through `sample_tiled` at bench.py's 1080p point
    (`build_tiled_exact`), twice; the host's crop and merge timed apart."""
    go, cond, flow = build_tiled_exact(fused, gen)
    coords = tile_grid(FRAME_H, FRAME_W, (TILE, TILE), OVERLAP)
    if len(coords) != N_TILES:
        raise AssertionError(f"tiled_exact: {len(coords)} tiles")
    torch.cuda.reset_peak_memory_stats()
    images, first_s, launches = counted(go)
    check_frames("tiled_exact", images, (1, FRAME_H, FRAME_W, 3))
    chunks = -(-N_TILES // TILED_EXACT_BATCH)
    check_launches("tiled_exact", launches, {
        "attention": None, "splat_sum": None, "silu_conv3x3": 0,
        **launches_times(chunks), **NO_TRAIN_KERNELS})
    _, second_s = timed(go)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the host's share, timed apart on the same data: the crops (before
    # the upload) and the merge (after the fetch)
    t = time.perf_counter()
    _crop_batch(cond, coords, TILE, TILE)
    _crop_batch(flow, coords, TILE, TILE)
    crop_s = time.perf_counter() - t
    tiles = _crop_batch(images, coords, TILE, TILE)
    t = time.perf_counter()
    merge_tiles([tile[:y2 - y1, :x2 - x1] for tile, (y1, y2, x1, x2)
                 in zip(tiles, coords)], coords, (FRAME_H, FRAME_W),
                feather=FEATHER, as_uint8=False)
    merge_s = time.perf_counter() - t
    out = dict(frames=1, res=[FRAME_H, FRAME_W], tiles=len(coords),
               tile_batch=TILED_EXACT_BATCH, steps=STEPS, first_s=first_s,
               second_s=second_s, s_per_frame=second_s,
               host_s=dict(crop=crop_s, merge=merge_s), peak_mem_gib=peak,
               launches=launches,
               image_mean_abs=float(np.abs(images).mean()))
    log("tiled_exact", **out)
    return out


def synthetic_clip(seed: int):
    """CODEC_FRAMES 1080p frames and their known flows: a textured
    background that moves (3, 2) px a frame and a 240 px square that moves
    (-5, 4), wrapping round.  Returns (frames [N, H, W, 3] uint8, forward
    flows {t: anchor 0 -> t}, backward flows {t: anchor 8 -> t}), each
    flow [H, W, 2] (u, v) on the anchor's pixels."""
    rng = np.random.default_rng(seed)
    H, W = FRAME_H, FRAME_W
    coarse = rng.uniform(30, 220, (H // 40 + 1, W // 40 + 1, 3))
    background = np.repeat(np.repeat(coarse, 40, 0), 40, 1)[:H, :W]
    background += rng.normal(0, 6, (H, W, 3))
    bg_v, obj_v = np.array([3, 2]), np.array([-5, 4])
    obj0, size = (400, 700), 240
    color = rng.uniform(0, 255, 3)

    def obj_mask(t):
        yy, xx = np.ogrid[:H, :W]
        y0, x0 = obj0[0] + obj_v[1] * t, obj0[1] + obj_v[0] * t
        return ((yy - y0) % H < size) & ((xx - x0) % W < size)

    frames = []
    for t in range(CODEC_FRAMES):
        f = np.roll(background, (bg_v[1] * t, bg_v[0] * t), (0, 1)).copy()
        f[obj_mask(t)] = color
        frames.append(np.clip(f, 0, 255).astype(np.uint8))

    def flow(anchor, t):
        field = np.empty((H, W, 2), np.float32)
        field[:] = bg_v * (t - anchor)
        field[obj_mask(anchor)] = obj_v * (t - anchor)
        return field

    inter = [i for i in range(CODEC_FRAMES) if i % CODEC_GOP]
    return (np.stack(frames), {t: flow(0, t) for t in inter},
            {t: flow(CODEC_GOP, t) for t in inter})


def build_codec(fused, cmp_model, gen, workdir: str):
    """A synthetic 1080p GOP-8 through the codec's sparse mode: its flow
    bitstreams written under `workdir` (the port's watershed + grid
    sampler), the CMP densifying each on the card, and
    `decode_inter_frames` with `sample_tiled` over the distilled K = 4
    pipeline on `fused`'s models, one frame's 15 tiles a call.  Returns a
    namespace: go() decodes the GOP, the same noise each call, and
    refills `stage_s` and `calls` (the densifier's and the sampler's
    seconds and calls); `frames` the clip, `anchors` its decoded anchors,
    `enc` the encoded video, `nbytes` the flow bitstreams' bytes,
    `encode_s` the seconds to write them."""
    frames, flows_fwd, flows_bwd = synthetic_clip(31)
    schedule = gop_schedule(CODEC_FRAMES, CODEC_GOP)
    dpipe = DistilledPipeline.from_pipeline(
        fused, DistillConfig(num_student_steps=DISTILL_STEPS))
    ctx = fused.unet.cfg.cross_attention_dim
    text = (torch.randn((CODEC_INTER, 77, ctx), device="cuda", generator=gen)
            * 0.02).bfloat16()
    noise = torch.Generator(device="cuda")
    densify = make_cmp_densifier(cmp_model, "cuda")
    stage_s = dict(densify=0.0, sample=0.0)
    calls = dict(densify=0, sample=0)

    def densify_fn(*args):
        (out, s) = timed(lambda: densify(*args))
        stage_s["densify"] += s
        calls["densify"] += 1
        return out

    def sample_fn(cond, flow):
        (out, s) = timed(lambda: sample_tiled(
            dpipe, text[:cond.shape[0]], None, cond, flow,
            tile=(TILE, TILE), overlap=OVERLAP, feather=FEATHER,
            tile_batch=CODEC_TILE_BATCH, generator=noise))
        stage_s["sample"] += s
        calls["sample"] += 1
        return out

    anchors = np.zeros_like(frames)
    anchors[[0, CODEC_GOP]] = frames[[0, CODEC_GOP]]
    t = time.perf_counter()
    nbytes = encode_flows(workdir, schedule, flows_fwd, flows_bwd, "sparse")
    encode_s = time.perf_counter() - t
    enc = EncodedVideo(path=workdir, meta=dict(
        num_frames=CODEC_FRAMES, height=FRAME_H, width=FRAME_W,
        gop_size=CODEC_GOP, flow_rate_mode="sparse"))

    def go():
        noise.manual_seed(32)
        for k in stage_s:
            stage_s[k], calls[k] = 0.0, 0
        return decode_inter_frames(anchors, enc, sample_fn, densify_fn,
                                   max_batch=CODEC_INTER,
                                   transfer_dtype=torch.bfloat16,
                                   device="cuda")

    return types.SimpleNamespace(go=go, frames=frames, anchors=anchors,
                                 enc=enc, nbytes=nbytes, encode_s=encode_s,
                                 stage_s=stage_s, calls=calls)


def _standin_sampler(cond, flow):
    """Elementwise, exact in fp32 (products by powers of 2): the same
    bits on any device."""
    return cond[..., :3].float() * 2.0 - 1.0 + flow[..., :1].float() * 0.25


def codec(fused, cmp_model, gen) -> tuple:
    """The codec's GOP (`build_codec`) decoded twice: seconds and inter
    frames/s of the second call, its stage seconds, flow bytes and bpp,
    peak memory and launches; asserts uint8 frames of the clip's shape,
    the anchors unchanged, 14 densifier calls and one sampler call, and
    that a sampler returning a tensor on the card decodes as on the
    CPU.  Returns (its line, the decoded GOP, the clip's frames)."""
    with tempfile.TemporaryDirectory() as d:
        c = build_codec(fused, cmp_model, gen, d)
        torch.cuda.reset_peak_memory_stats()
        out, first_s, launches = counted(c.go)
        first_calls = dict(c.calls)
        _, second_s = timed(c.go)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the branch for a sampler that returns a tensor on the card (the
        # uint8 conversion and the pinned copy queued behind each chunk,
        # chunks of 3, 3 and 1 padded to 3) against the CPU's, bit for bit
        on_card, on_cpu = (decode_inter_frames(
            c.anchors, c.enc, _standin_sampler, max_batch=3, device=dev)
            for dev in ("cuda", "cpu"))
        if not np.array_equal(on_card, on_cpu):
            raise AssertionError("codec: decode_inter_frames' device branch "
                                 "differs from the CPU's")
    frames, nbytes = c.frames, c.nbytes
    total_bytes = sum(sum(d.values()) for d in nbytes.values())
    points = {k: [(n - 18) // 6 for n in d.values()]
              for k, d in nbytes.items()}
    res = dict(frames=CODEC_FRAMES, inter_frames=CODEC_INTER,
               res=[FRAME_H, FRAME_W], tiles_a_frame=N_TILES,
               tile_batch=CODEC_TILE_BATCH, steps=DISTILL_STEPS,
               flow_bytes=nbytes, flow_points=points,
               flow_bpp=total_bytes * 8 / (CODEC_FRAMES * FRAME_H * FRAME_W),
               encode_flows_s=c.encode_s, first_s=first_s,
               second_s=second_s, inter_frames_per_s=CODEC_INTER / second_s,
               stages_s=dict(c.stage_s), calls=first_calls,
               peak_mem_gib=peak, launches=launches)
    log("codec", **res)
    if out.dtype != np.uint8 or out.shape != frames.shape:
        raise AssertionError(f"codec: {out.dtype} {out.shape}")
    if not (np.array_equal(out[0], frames[0])
            and np.array_equal(out[CODEC_GOP], frames[CODEC_GOP])):
        raise AssertionError("codec: an anchor changed")
    if first_calls != dict(densify=2 * CODEC_INTER, sample=1):
        raise AssertionError(f"codec: calls {first_calls}")
    check_launches("codec", launches, {
        "attention": None, "splat_sum": None, "silu_conv3x3": 0,
        **launches_times(CODEC_INTER * N_TILES // CODEC_TILE_BATCH),
        **NO_TRAIN_KERNELS})
    return res, out, frames


def bits_differ(a: torch.nn.Module, b: torch.nn.Module, names) -> list:
    """The names whose tensors differ between a and b in dtype, shape or
    any bit."""
    sa, sb = a.state_dict(), b.state_dict()
    return [n for n in names if not (
        sa[n].dtype == sb[n].dtype and sa[n].shape == sb[n].shape
        and torch.equal(sa[n].reshape(-1).view(torch.uint8),
                        sb[n].reshape(-1).view(torch.uint8)))]


@torch.no_grad()
def fill_metric_net(model: torch.nn.Module, gen: torch.Generator):
    """`fill_params`, BatchNorm running means ~ N(0, 0.1^2) and variances
    in [0.5, 1.5], and LPIPS' lins made non-negative (as trained ones
    are: a distance weighs each layer's differences up)."""
    fill_params(model, gen)
    if isinstance(model, LPIPS):
        for k in range(5):
            getattr(model, f"lin{k}").model[1].weight.abs_()
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            shape, dev = m.running_mean.shape, m.running_mean.device
            m.running_mean.copy_(0.1 * torch.randn(shape, device=dev,
                                                   generator=gen))
            m.running_var.copy_(0.5 + torch.rand(shape, device=dev,
                                                 generator=gen))


def aux_inputs(gen):
    """{name: forward arguments} of each metric network (and the CMP) on
    the card."""
    def u(*shape):
        return torch.rand(shape, device="cuda", generator=gen) * 2 - 1
    return {"lpips": (u(2, 64, 64, 3), u(2, 64, 64, 3)),
            "inception": (u(2, 299, 299, 3),),
            "i3d": (u(1, 16, 64, 64, 3),),
            "cmp": sparse_input(gen, 64, 96, "cuda")}


@torch.no_grad()
def checkpoint(fused, x, cmp_model, gen) -> tuple:
    """The weights-readiness path at full width: the fused pipeline's
    UNet, DualFlowControlNet and VAE and a seeded CLIP text tower (bf16)
    written as a diffusers root by `synthesize_sd_checkpoint_dir`, loaded
    by `load_sd_checkpoint_dir` into fresh modules on the card; every
    tensor bit-identical, and the distilled K = 4 decode with the loaded
    weights (launches counted) against the same decode from the
    originals.  Then LPIPS, I3D, the FID-64 prefix and the CMP through
    `synthesize_aux_checkpoints` / `load_aux_checkpoints`: bit-identical
    tensors and forwards.  Returns (its line, the loaded metric
    networks)."""
    with torch.device("cuda"):
        text = CLIPTextEncoder(CLIPTextConfig()).to(torch.bfloat16).eval()
    fill_params(text, gen)
    sd = {"unet": fused.unet, "controlnet": fused.controlnet,
          "vae": fused.vae, "text": text}
    unet_cfg = fused.unet.cfg
    with tempfile.TemporaryDirectory() as d:
        written, write_s = timed(
            lambda: checkpoints.synthesize_sd_checkpoint_dir(d, sd))
        fresh = DualFlowPipeline.create(
            unet_cfg, fused.controlnet.cfg, fused.vae.cfg, fused.sampler,
            dtype=torch.bfloat16, device="cuda", fused_conv=True)
        with torch.device("cuda"):
            fresh_text = CLIPTextEncoder(CLIPTextConfig()).to(
                torch.bfloat16).eval()
        loaded = {"unet": fresh.unet, "controlnet": fresh.controlnet,
                  "vae": fresh.vae, "text": fresh_text}
        report, load_s = timed(
            lambda: checkpoints.load_sd_checkpoint_dir(d, loaded))
        read = sum(os.path.getsize(r["path"]) for r in report.values())
    differ = {k: bits_differ(sd[k], loaded[k],
                             checkpoints.module_names(k, sd[k]))
              for k in sd}
    n_tensors = sum(len(checkpoints.module_names(k, m))
                    for k, m in sd.items())
    n_params = sum(p.numel() for m in sd.values() for p in m.parameters())
    del text, fresh_text, loaded
    torch.cuda.empty_cache()

    def distilled(pipe):
        g = torch.Generator(device="cuda").manual_seed(41)
        return DistilledPipeline.from_pipeline(
            pipe, DistillConfig(num_student_steps=DISTILL_STEPS)).sample(
                x["latents"], x["text"], x["cond"], x["flow"], generator=g)

    want = distilled(fused)
    got, _, launches = counted(lambda: distilled(fresh))
    again = distilled(fused)
    check_images("checkpoint", got)
    check_launches("checkpoint", launches,
                   {"attention": None, "splat_sum": None, "silu_conv3x3": 0,
                    **FUSED_VAE_LAUNCHES, **NO_TRAIN_KERNELS})
    diff = (got.float() - want.float()).abs()
    diff = dict(max=diff.max().item(), mean=diff.mean().item())
    repeat = (again.float() - want.float()).abs()
    repeat = dict(max=repeat.max().item(), mean=repeat.mean().item())
    del fresh, got, want, again
    torch.cuda.empty_cache()

    # the metric networks and the CMP
    with torch.device("cuda"):
        aux = {"lpips": LPIPS(), "i3d": InceptionI3D(),
               "inception": InceptionFID64()}
    for m in aux.values():
        fill_metric_net(m, gen)
    aux = {k: m.eval() for k, m in aux.items()}
    aux["cmp"] = cmp_model
    with tempfile.TemporaryDirectory() as d:
        aux_written, aux_write_s = timed(
            lambda: checkpoints.synthesize_aux_checkpoints(d, modules=aux))
        aux_loaded, aux_load_s = timed(
            lambda: checkpoints.load_aux_checkpoints(d, device="cuda"))
    inputs = aux_inputs(gen)
    aux_differ, aux_out_err = {}, {}
    for name, m in aux.items():
        aux_differ[name] = bits_differ(m, aux_loaded[name],
                                       checkpoints.module_names(name, m))
        a, b = m(*inputs[name]), aux_loaded[name](*inputs[name])
        aux_out_err[name] = (a - b).abs().max().item()
    out = dict(
        sd=dict(params=n_params, tensors=n_tensors, dtype="bfloat16",
                bytes_written=written, write_s=write_s,
                write_gb_per_s=written / write_s / 1e9, bytes_read=read,
                load_s=load_s, load_gb_per_s=read / load_s / 1e9,
                unused={k: r["unused"] for k, r in report.items()},
                tensors_differing={k: len(v) for k, v in differ.items()}),
        decode=dict(steps=DISTILL_STEPS, max_abs_err=diff["max"],
                    mean_abs_err=diff["mean"],
                    repeat_max_abs_err=repeat["max"],
                    repeat_mean_abs_err=repeat["mean"],
                    tol=CKPT_DECODE_TOL,
                    launches=launches),
        aux=dict(bytes_written=aux_written, write_s=aux_write_s,
                 load_s=aux_load_s,
                 tensors_differing={k: len(v) for k, v in
                                    aux_differ.items()},
                 forward_max_abs_diff=aux_out_err))
    log("checkpoint", **out)
    bad = {k: v[:3] for k, v in {**differ, **aux_differ}.items() if v}
    if bad:
        raise AssertionError(f"checkpoint: reloaded tensors differ: {bad}")
    if any(r["unused"] for r in report.values()):
        raise AssertionError(f"checkpoint: unused names {out['sd']}")
    d = out["decode"]
    if not (d["max_abs_err"] <= CKPT_DECODE_TOL["max_abs"]
            and d["mean_abs_err"] <= CKPT_DECODE_TOL["mean_abs"]):
        raise AssertionError(f"checkpoint: reloaded decode disagrees: {d}")
    return out, aux_loaded


def rel_norm(got, want) -> float:
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return ((got - want).norm() / want.norm()).item()


def psnr_bf16(a, b) -> torch.Tensor:
    """PSNR with its mean squared error held in bf16: what a metric path
    that lost its fp32 reads (EVAL_TOL's probe)."""
    mse = ((a.bfloat16() - b.bfloat16()) ** 2).mean(dim=(-3, -2, -1))
    return 20.0 * np.log10(255.0) - 10.0 * torch.log10(mse.float())


class BF16Autocast(torch.nn.Module):
    """A module run under bf16 autocast, fp32 out: the LPIPS term as a
    lower-precision network would give it (TRAIN_REF_TOL's probe)."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, *args):
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return self.inner(*args).float()


@torch.no_grad()
def evaluate(decoded: np.ndarray, frames: np.ndarray, aux) -> dict:
    """The codec's 1080p GOP scored against its synthetic originals on the
    card: PSNR, MS-SSIM, LPIPS, the FID-64 features and the I3D features
    of the clip, seconds of each (the second of two calls); held against
    the port's CPU path (PSNR and MS-SSIM on the full frames, the networks
    on a EVAL_CROP crop of both), beside the same metrics in bf16 that
    EVAL_TOL must refuse; BD-rates of `anchors_data`'s UVG curves on the
    host."""
    orig = torch.from_numpy(frames).cuda()
    pred = torch.from_numpy(decoded).cuda()
    half = torch.full((), 127.5, device="cuda")
    lpips_fn = make_lpips_fn(aux["lpips"], device="cuda")
    fid_fn = make_fid64_feature_fn(aux["inception"], device="cuda")
    fvd_fn = make_i3d_feature_fn(aux["i3d"], device="cuda")
    runs = {
        "psnr": lambda: eval_metrics.psnr(orig, pred),
        "ms_ssim": lambda: eval_metrics.ms_ssim(orig, pred),
        "lpips": lambda: lpips_fn(pred / half - 1.0, orig / half - 1.0),
        "fid64_features": lambda: fid_fn(torch.cat([orig, pred])),
        "i3d_features": lambda: fvd_fn(unit_from_uint8(
            torch.stack([orig, pred]), torch.float32)),
    }
    card, seconds, first_s = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, fn in runs.items():
        _, first_s[name] = timed(fn)
        card[name], seconds[name] = timed(fn)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # the CPU: PSNR and MS-SSIM on the full frames, the networks on a crop
    o_cpu, p_cpu = torch.from_numpy(frames), torch.from_numpy(decoded)
    cpu_psnr = eval_metrics.psnr(o_cpu, p_cpu)
    cpu_ms_ssim = eval_metrics.ms_ssim(o_cpu, p_cpu)
    # what the limits must tell apart: the same metrics in bf16
    bf16_psnr = psnr_bf16(orig, pred).cpu()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        bf16_ms_ssim = eval_metrics.ms_ssim(orig, pred).float().cpu()
    y0, x0 = (FRAME_H - EVAL_CROP) // 2, (FRAME_W - EVAL_CROP) // 2
    crop = (slice(None), slice(y0, y0 + EVAL_CROP),
            slice(x0, x0 + EVAL_CROP))
    oc, pc = frames[crop], decoded[crop]
    nets = {}
    for name, dev_fn in (
            ("lpips", lambda m, dev: make_lpips_fn(m, device=dev)(
                torch.from_numpy(pc).to(dev).float() / 127.5 - 1.0,
                torch.from_numpy(oc).to(dev).float() / 127.5 - 1.0)),
            ("inception", lambda m, dev: make_fid64_feature_fn(
                m, device=dev)(np.concatenate([oc, pc]))),
            ("i3d", lambda m, dev: make_i3d_feature_fn(m, device=dev)(
                np.stack([oc, pc]).astype(np.float32) / 255.0))):
        cpu_model = copy.deepcopy(aux[name]).cpu()
        want = torch.as_tensor(dev_fn(cpu_model, "cpu"))
        got = torch.as_tensor(dev_fn(aux[name], "cuda")).cpu()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            low = torch.as_tensor(dev_fn(aux[name], "cuda")).cpu()
        nets[name] = dict(rel_norm_err=rel_norm(got, want),
                          bf16_rel_norm_err=rel_norm(low, want),
                          want_norm=want.float().norm().item())

    finite = torch.isfinite(cpu_psnr)
    psnr_card = card["psnr"].cpu()
    anchors, ours = uvg_rd_curves(8)
    table, bd_s = timed(lambda: bd_rate_table(anchors, ours))
    out = dict(
        frames=list(frames.shape), seconds=seconds, first_s=first_s,
        peak_mem_gib=peak,
        card=dict(psnr=psnr_card.tolist(),
                  ms_ssim=card["ms_ssim"].cpu().tolist(),
                  lpips=card["lpips"].cpu().tolist(),
                  fid64_features=list(card["fid64_features"].shape),
                  i3d_features=list(card["i3d_features"].shape)),
        vs_cpu=dict(
            psnr_max_abs_err=(psnr_card[finite] - cpu_psnr[finite]).abs()
            .max().item(),
            psnr_inf_same=bool(torch.equal(torch.isinf(psnr_card),
                                           torch.isinf(cpu_psnr))),
            ms_ssim_max_abs_err=(card["ms_ssim"].cpu() - cpu_ms_ssim).abs()
            .max().item(),
            bf16_psnr_max_abs_err=(bf16_psnr[finite] - cpu_psnr[finite])
            .abs().max().item(),
            bf16_ms_ssim_max_abs_err=(bf16_ms_ssim - cpu_ms_ssim).abs()
            .max().item(), crop=EVAL_CROP, nets=nets, tol=EVAL_TOL),
        bd_rate_uvg_gop8={k: v for k, v in table.items()}, bd_rate_s=bd_s)
    log("eval", **out)
    v = out["vs_cpu"]
    if not (v["psnr_inf_same"] and v["psnr_max_abs_err"]
            <= EVAL_TOL["psnr_abs"]
            and v["ms_ssim_max_abs_err"] <= EVAL_TOL["ms_ssim_abs"]
            and all(n["rel_norm_err"] <= EVAL_TOL[name + "_rel_norm"]
                    for name, n in nets.items())):
        raise AssertionError(f"eval: the card disagrees with the CPU: {v}")
    if not (out["card"]["fid64_features"] == [2 * CODEC_FRAMES, 64]
            and out["card"]["i3d_features"] == [2, 400]
            and np.isfinite(card["fid64_features"]).all()
            and np.isfinite(card["i3d_features"]).all()
            and bool(torch.isfinite(card["lpips"]).all())):
        raise AssertionError(f"eval: features {out['card']}")
    if not any(np.isfinite(x) for row in table.values()
               for x in row.values()):
        raise AssertionError(f"eval: no finite BD-rate: {table}")
    return out


def tiled_reference():
    """A tiny pipeline tiled over a 112 x 168 frame (tiles of 64 with
    overlap 16: 3 x 4 tiles, the last row and column padded past their
    width): the card (bf16, kernels) against the CPU (fp32, plain
    versions) on the same weights and noise, exact and distilled, with
    the fused VAE."""
    vae_cfg = VAEConfig(base_channels=8, channel_mults=(1, 1, 2, 2),
                        layers_per_block=1)
    sampler = SamplerConfig(num_inference_steps=3)
    pipes = [DualFlowPipeline.create(
        UNetConfig.tiny(), ControlNetConfig.tiny(), vae_cfg, sampler,
        dtype=dtype, device=device, fused_conv=True)
        for dtype, device in ((torch.float32, "cpu"),
                              (torch.bfloat16, "cuda"))]
    for c, g in ((pipes[0].unet, pipes[1].unet),
                 (pipes[0].controlnet, pipes[1].controlnet),
                 (pipes[0].vae, pipes[1].vae)):
        fill_params(c, torch.Generator().manual_seed(7))
        g.load_state_dict(c.state_dict())
    H, W, tile, overlap = 112, 168, 64, 16
    n = len(tile_grid(H, W, (tile, tile), overlap))
    g = torch.Generator().manual_seed(8)
    cond = torch.randint(0, 256, (1, H, W, 6), generator=g,
                         dtype=torch.uint8).numpy()
    flow = (torch.randn((1, H, W, 4), generator=g) * 4).numpy()
    text = (torch.randn((1, 77, 32), generator=g) * 0.02).numpy()
    latents = torch.randn((n, tile // 8, tile // 8, 4), generator=g)
    noises = [torch.randn(latents.shape, generator=g)]
    tol = dict(max_abs=0.25, mean_abs=0.02)  # reference_check's
    for mode in ("exact", "distilled"):
        if mode == "distilled":
            pipes = [DistilledPipeline.from_pipeline(
                p, DistillConfig(num_student_steps=2)) for p in pipes]

        def run_tiled(pipe):
            return sample_tiled(pipe, text, np.zeros_like(text), cond, flow,
                                tile=(tile, tile), overlap=overlap,
                                feather=overlap, tile_batch=5,
                                latents=latents,
                                noises=noises if mode == "distilled"
                                else None)

        want = run_tiled(pipes[0])
        got, _, launches = counted(lambda: run_tiled(pipes[1]))
        check_launches(f"tiled_reference ({mode})", launches, {
            name: None for name in ("attention", "splat_sum",
                                    "gn_silu_conv3x3", "conv3x3_head",
                                    "upsample_conv3x3")})
        check_frames(f"tiled_reference ({mode})", got, (1, H, W, 3))
        diff = np.abs(got - want)
        out = dict(mode=mode, res=[H, W], tiles=n,
                   max_abs_err=float(diff.max()),
                   mean_abs_err=float(diff.mean()), tol=tol,
                   want_mean_abs=float(np.abs(want).mean()),
                   launches=launches)
        log("tiled_reference", **out)
        if not (out["max_abs_err"] <= tol["max_abs"]
                and out["mean_abs_err"] <= tol["mean_abs"]):
            raise AssertionError(f"tiled tiny decode on the card disagrees "
                                 f"with the CPU: {out}")


FULLWIDTH_RES, FULLWIDTH_T = 64, 500
# one ControlNet + UNet call at batch 1 over 8 x 8 latents, one layer a
# block: a self- and a cross-attention (77 tokens) in each transformer, 8
# heads of 40/80/160 over 64/16/4 positions and the mid block's 1 (the
# ControlNet's 3 levels and mid, 8 launches; the UNet's down 6, mid 2, up
# 3 levels x 2 layers x 2, 20); two splats a pyramid level, both flow
# directions in one launch: the features' half of the inject width plus
# the metric, and the 3-channel occlusion check
FULLWIDTH_ATTENTION = {(8, L, Lk, D) for L, D in ((64, 40), (16, 80),
                                                  (4, 160), (1, 160))
                       for Lk in (L, 77)}
FULLWIDTH_SPLATS = {(2, h, h, c) for h, C in ((8, 161), (4, 161), (2, 321),
                                              (1, 641)) for c in (C, 3)}
FULLWIDTH_LAUNCHES = {"attention": 28, "splat_sum": 8}
# The bf16 rule, here and in tests/test_torch_port_fullwidth.py, which
# takes it from this module: with e_ref the reference's own bf16 error
# against its fp32 (the CPU's here, JAX's there), a bf16 result's error
# against that fp32 within e_scale e_ref, and its distance from the
# reference's bf16 within d_scale e_ref (two independent roundings of one
# size put it near 1.41), each plus floor
FULLWIDTH_RULE = dict(e_scale=1.5, d_scale=2.5, floor=1e-3)


def within_bf16_rule(e_ref: float, e_got: float, d: float) -> bool:
    r = FULLWIDTH_RULE
    return (e_got <= r["e_scale"] * e_ref + r["floor"]
            and d <= r["d_scale"] * e_ref + r["floor"])


def _fullwidth_nets(models, device, dtype) -> dict:
    """`models` moved to `device` in `dtype` (in place), with a fused
    copy of the VAE where there is one."""
    nets = {k: m.to(device, dtype).eval() for k, m in models.items()}
    if "vae" in nets:
        nets["vae_fused"] = fused_vae_of(nets["vae"])
    return nets


def _seeded_models(makers: dict, seed: int) -> dict:
    """{name: module}: each made on the meta device, allocated on the card
    and filled by `fill_params` from one seeded generator there, then
    moved to the CPU in fp32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    models = {}
    for name, make in makers.items():
        with torch.device("meta"):
            m = make()
        models[name] = m.to_empty(device="cuda")
        fill_params(models[name], gen)
    return {k: m.cpu() for k, m in models.items()}


def _card_against_cpu(models: dict, run, residuals_of) -> tuple:
    """The same weights in turn: run(nets, dtype, residuals) in fp32 and
    bf16 on the CPU, in bf16 on the card (after a warm-up, its launches
    counted and recorded), the bf16 runs' UNet fed the residuals that
    residuals_of picks from the fp32 run.  `models` ends on the card and
    is emptied.  Returns (errors: {net: [[e_ref, e_card, d], ...]},
    failed, launches, calls, seconds of each run)."""
    runs = {}
    nets = _fullwidth_nets(models, "cpu", torch.float32)
    runs["cpu_fp32"], cpu32_s = timed(lambda: run(nets, torch.float32,
                                                  None))
    residuals = residuals_of(runs["cpu_fp32"])
    nets = _fullwidth_nets(models, "cpu", torch.bfloat16)
    runs["cpu_bf16"], cpu16_s = timed(lambda: run(nets, torch.bfloat16,
                                                  residuals))
    nets = _fullwidth_nets(models, "cuda", torch.bfloat16)
    run(nets, torch.bfloat16, residuals)  # warm-up
    (runs["card_bf16"], launches, calls), card_s = timed(
        lambda: recorded_launches(lambda: run(nets, torch.bfloat16,
                                              residuals)))
    del nets
    models.clear()
    torch.cuda.empty_cache()

    errors, failed = {}, []
    for net, f32s in runs["cpu_fp32"].items():
        rows = []
        for i, (f32, b16, got) in enumerate(zip(
                f32s, runs["cpu_bf16"][net], runs["card_bf16"][net])):
            if not torch.isfinite(got).all() or got.shape != f32.shape:
                failed.append((net, i, "shape or non-finite"))
            e_ref = rel_norm(b16, f32)
            e_card, d = rel_norm(got, f32), rel_norm(got, b16)
            rows.append([e_ref, e_card, d])
            if not within_bf16_rule(e_ref, e_card, d):
                failed.append((net, i, e_ref, e_card, d))
        errors[net] = rows
    return errors, failed, launches, calls, dict(
        card_s=card_s, cpu_bf16_s=cpu16_s, cpu_fp32_s=cpu32_s)


def _worst(errors: dict) -> dict:
    rows = [r for v in errors.values() for r in v]
    return dict(e_card_over_e_ref=max(r[1] / max(r[0], 1e-30)
                                      for r in rows),
                d_over_e_ref=max(r[2] / max(r[0], 1e-30) for r in rows))


@torch.no_grad()
def _fullwidth_run(nets, x, dtype, residuals=None):
    """{'controlnet': [4 pyramid features, 8 down residuals, mid],
    'unet': [eps], 'vae': [images], 'vae_fused': [images]} on the nets'
    device, float32 on the CPU; the UNet takes `residuals` (fp32, cast),
    else the ControlNet's own."""
    dev = next(nets["unet"].parameters()).device
    cast = {k: v.to(dev, dtype) if k in ("cond", "flow", "text")
            else v.to(dev) for k, v in x.items()}
    pyr = nets["controlnet"].extract_pyramid(cast["cond"], cast["flow"])
    down, mid = nets["controlnet"].backbone(cast["noise"], FULLWIDTH_T,
                                            cast["text"], pyr, 1.35)
    cn = [*pyr, *down, mid]
    res = ([r.to(dev, dtype) for r in residuals] if residuals is not None
           else cn[len(pyr):])
    s = SamplerConfig()
    eps = nets["unet"](cast["noise"], FULLWIDTH_T, cast["text"],
                       down_block_additional_residuals=res[:-1],
                       mid_block_additional_residual=res[-1],
                       freeu=(s.freeu_s1, s.freeu_s2, s.freeu_b1,
                              s.freeu_b2))
    out = {"controlnet": cn, "unet": [eps]}
    for k in ("vae", "vae_fused"):
        out[k] = [decode_from_latents(nets[k], cast["latents"])]
    return {k: [t.float().cpu() for t in v] for k, v in out.items()}


def fullwidth():
    """SD-1.5's widths at one layer a block, 64 px, batch 1 (see the
    module's docstring): the card's bf16 against the CPU's bf16 and fp32,
    output by output, and its launches."""
    unet_cfg = UNetConfig(layers_per_block=1)
    cn_cfg, vae_cfg = ControlNetConfig(unet=unet_cfg), VAEConfig()
    t0 = time.perf_counter()
    models = _seeded_models(
        {"controlnet": lambda: DualFlowControlNet(cn_cfg),
         "unet": lambda: UNet2DConditionModel(unet_cfg),
         "vae": lambda: AutoencoderKL(vae_cfg)}, 19)
    B, H, h = 1, FULLWIDTH_RES, FULLWIDTH_RES // 8
    g = torch.Generator().manual_seed(20)
    x = dict(cond=torch.rand((B, H, H, 6), generator=g) * 2 - 1,
             flow=torch.randn((B, H, H, 4), generator=g) * 2,
             text=torch.randn((B, 77, unet_cfg.cross_attention_dim),
                              generator=g) * 0.1,
             noise=torch.randn((B, h, h, 4), generator=g),
             latents=torch.randn((B, h, h, 4), generator=g))
    outputs, failed, launches, calls, times = _card_against_cpu(
        models, lambda nets, dtype, res: _fullwidth_run(nets, x, dtype, res),
        lambda cpu: cpu["controlnet"][len(cn_cfg.inject_channels):])

    check_launches("fullwidth", launches, {
        **FULLWIDTH_LAUNCHES, **FUSED_VAE_LAUNCHES, "silu_conv3x3": 0,
        **NO_TRAIN_KERNELS})
    shapes = {"attention": set(calls.get("dc_attention_fwd", [])),
              "splat_sum": set(calls.get("dc_splat_sum", []))}
    for name, want in (("attention", FULLWIDTH_ATTENTION),
                       ("splat_sum", FULLWIDTH_SPLATS)):
        if shapes[name] != want:
            failed.append((name, sorted(shapes[name]), sorted(want)))
    # B, H, W, C, O (the conv entry takes its prologue after them)
    convs = [c[:5] for c in calls.get("dc_conv3x3", [])]
    ups = calls.get("dc_upsample_conv3x3", [])
    if (len(convs) != FUSED_VAE_LAUNCHES["gn_silu_conv3x3"]
            or len(ups) != FUSED_VAE_LAUNCHES["upsample_conv3x3"]
            or (B, H, H, vae_cfg.base_channels, 3) not in convs):
        failed.append(("vae_fused", convs, ups))

    out = dict(res=H, batch=B, layers_per_block=unet_cfg.layers_per_block,
               timestep=FULLWIDTH_T, rule=FULLWIDTH_RULE,
               columns=["e_ref", "e_card", "d"], errors=outputs,
               worst=_worst(outputs), launches=launches,
               shapes={k: sorted(v) for k, v in shapes.items()},
               conv_shapes=sorted(set(convs)), upsample_shapes=sorted(
                   set(ups)),
               **times, seconds=time.perf_counter() - t0)
    log("fullwidth", **out)
    if failed:
        raise AssertionError(f"fullwidth: {failed}")


FULLDEPTH_RES, FULLDEPTH_T = 512, 500
# one CFG step of the 512 px decode at SD-1.5's depth (2 layers a block):
# the ControlNet's 7 transformers (2 a level at 64/32/16 latents, the mid
# block's at 8) and the UNet's 16 (2 a level down, the mid block's, 3 a
# level up), a self- and a cross-attention (77 tokens) each, 8 heads of 2
# samples: 46 launches, 7 a shape at 4096/1024/256 positions and 2 at the
# mid block's 64; the pyramid's 8 splats at one frame's both directions
FULLDEPTH_ATTENTION = collections.Counter(
    {(16, L, Lk, D): n for L, D, n in ((4096, 40, 7), (1024, 80, 7),
                                       (256, 160, 7), (64, 160, 2))
     for Lk in (L, 77)})
FULLDEPTH_SPLATS = collections.Counter(
    {(2, h, h, c): 1 for h, C in ((64, 161), (32, 161), (16, 321), (8, 641))
     for c in (C, 3)})
FULLDEPTH_LAUNCHES = {"attention": 46, "splat_sum": 8}


@torch.no_grad()
def _fulldepth_run(nets, x, dtype, residuals=None):
    """{'controlnet': [12 down residuals, mid], 'unet': [eps]}: the
    pyramid of one frame, then one step of the CFG decode at FULLDEPTH_T
    (the batch doubled, [uncond, text]), on the nets' device, float32 on
    the CPU; the UNet takes `residuals` (fp32, cast), else the
    ControlNet's own."""
    dev = next(nets["unet"].parameters()).device
    cast = {k: v.to(dev, dtype) if k in ("cond", "flow", "text", "uncond")
            else v.to(dev) for k, v in x.items()}
    pyramid = [torch.cat([p, p]) for p in nets["controlnet"].extract_pyramid(
        cast["cond"], cast["flow"])]
    ctx = torch.cat([cast["uncond"], cast["text"]])
    lat = torch.cat([cast["latents"], cast["latents"]])
    s = SamplerConfig()
    down, mid = nets["controlnet"].backbone(
        lat, FULLDEPTH_T, ctx, pyramid, s.controlnet_conditioning_scale)
    res = ([r.to(dev, dtype) for r in residuals] if residuals is not None
           else [*down, mid])
    eps = nets["unet"](lat, FULLDEPTH_T, ctx,
                       down_block_additional_residuals=res[:-1],
                       mid_block_additional_residual=res[-1],
                       freeu=(s.freeu_s1, s.freeu_s2, s.freeu_b1,
                              s.freeu_b2))
    out = {"controlnet": [*down, mid], "unet": [eps]}
    return {k: [t.float().cpu() for t in v] for k, v in out.items()}


def fulldepth() -> dict:
    """SD-1.5 whole (2 layers a block) at the decode's operating point:
    512 px, CFG batch 2, one step at a mid timestep, FreeU; the card's
    bf16 against the CPU's bf16 and fp32 by `within_bf16_rule`, output by
    output (12 down residuals, mid, eps), and its launches, counted and
    recorded by shape.  Returns the launches."""
    unet_cfg = UNetConfig()
    cn_cfg = ControlNetConfig(unet=unet_cfg)
    t0 = time.perf_counter()
    models = _seeded_models(
        {"controlnet": lambda: DualFlowControlNet(cn_cfg),
         "unet": lambda: UNet2DConditionModel(unet_cfg)}, 21)
    H, h, D = FULLDEPTH_RES, FULLDEPTH_RES // 8, unet_cfg.cross_attention_dim
    g = torch.Generator().manual_seed(22)
    x = dict(cond=torch.rand((1, H, H, 6), generator=g) * 2 - 1,
             flow=torch.randn((1, H, H, 4), generator=g) * 4,
             text=torch.randn((1, 77, D), generator=g) * 0.1,
             uncond=torch.randn((1, 77, D), generator=g) * 0.1,
             latents=torch.randn((1, h, h, 4), generator=g))
    errors, failed, launches, calls, times = _card_against_cpu(
        models, lambda nets, dtype, res: _fulldepth_run(nets, x, dtype, res),
        lambda cpu: cpu["controlnet"])
    if len(errors["controlnet"]) != 13:
        failed.append(("controlnet outputs", len(errors["controlnet"])))

    check_launches("fulldepth", launches, {
        **FULLDEPTH_LAUNCHES, "gn_silu_conv3x3": 0, "conv3x3_head": 0,
        "upsample_conv3x3": 0, "silu_conv3x3": 0, **NO_TRAIN_KERNELS})
    shapes = {"attention": collections.Counter(calls.get("dc_attention_fwd",
                                                         [])),
              "splat_sum": collections.Counter(calls.get("dc_splat_sum",
                                                         []))}
    for name, want in (("attention", FULLDEPTH_ATTENTION),
                       ("splat_sum", FULLDEPTH_SPLATS)):
        if shapes[name] != want:
            failed.append((name, sorted(shapes[name].items()),
                           sorted(want.items())))

    out = dict(res=H, batch=2, layers_per_block=unet_cfg.layers_per_block,
               timestep=FULLDEPTH_T, rule=FULLWIDTH_RULE,
               columns=["e_ref", "e_card", "d"], errors=errors,
               worst=_worst(errors), launches=launches,
               shapes={k: sorted([list(s), n] for s, n in v.items())
                       for k, v in shapes.items()},
               **times, seconds=time.perf_counter() - t0)
    log("fulldepth", **out)
    if failed:
        raise AssertionError(f"fulldepth: {failed}")
    return launches


def attention_bwd_bound(BH, Lq, Lk, D):
    """(ms, 'operations' | 'bytes') of the attention backward as a
    function, (q, k, v, out, dout, lse) -> (dq, dk, dv): S, dP, dV, dK and
    dQ (5 products) and rowsum(dout * out); q, k, v, out and dout read in
    bf16 and lse in fp32, dq, dk and dv written in bf16, each once."""
    return bound(10.0 * BH * Lq * Lk * D + 2.0 * BH * Lq * D,
                 2 * BH * D * (3 * Lq + 2 * Lk) + 4 * BH * Lq
                 + 2 * BH * D * (Lq + 2 * Lk),
                 PEAK_BF16_FLOPS)


def check_attention_train(gen, BH: int = TRAIN_BH) -> list:
    """The attention kernels at every shape of a training step at BH
    (default: batch 8): the forward with its log-sum-exp, and the backward
    kernel against autograd of the plain version (dQ, dK and dV)."""
    rows = []
    sdpa = F.scaled_dot_product_attention
    for Lq, Lk, D in ATTN_SHAPES:
        scale = D ** -0.5
        shape = [BH, Lq, Lk, D]
        q, k, v, dout = (torch.randn(BH, L, D, device="cuda", generator=gen)
                         .bfloat16() for L in (Lq, Lk, Lk, Lq))
        reps = 3 if Lq >= 1024 else 10
        out, lse = attention_forward(q, k, v, scale, with_lse=True)
        err, rel = _attention_close(f"attention (lse) {shape}", out,
                                    attention_reference(q, k, v, scale),
                                    ATTN_ULP)
        logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
        want_lse = torch.logsumexp(logits, -1)
        del logits
        # fp32 sums of exponentials in another order: a few ulps of lse
        lse_err = compare(f"lse {shape}", lse, want_lse, 1e-4, 1e-5)
        b_ms, b_by = bound(4.0 * BH * Lq * Lk * D,
                           2 * 2 * BH * D * (Lq + Lk) + 4 * BH * Lq,
                           PEAK_BF16_FLOPS)
        row = dict(kernel="attention", shape=shape, with_lse=True,
                   max_abs_err=err, rel_norm_err=rel, lse_max_abs_err=lse_err,
                   tol=dict(atol=ATTN_ULP, rtol=ATTN_ULP,
                            rel_norm=ATTN_REL_NORM, lse_atol=1e-4,
                            lse_rtol=1e-5),
                   ms=time_ms(lambda: attention_forward(q, k, v, scale,
                                                        with_lse=True), reps),
                   plain_ms=time_ms(
                       lambda: attention_reference(q, k, v, scale), reps),
                   library_ms=time_ms(
                       lambda: sdpa(q[None], k[None], v[None], scale=scale),
                       reps),
                   bound_ms=b_ms, bound_by=b_by)
        log("kernel", **row)
        rows.append(row)

        dq, dk, dv = attention_backward(q, k, v, out, lse, dout, scale)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ref = attention_reference(*leaves, scale)
        gq, gk, gv = torch.autograd.grad(ref, leaves, dout, retain_graph=True)
        errs = {n: _attention_close(f"d{n} {shape}", g_, w_, GRAD_ULP)
                for n, g_, w_ in (("q", dq, gq), ("k", dk, gk),
                                  ("v", dv, gv))}
        del dq, dk, dv, gq, gk, gv
        plain_ms = time_ms(lambda: torch.autograd.grad(
            ref, leaves, dout, retain_graph=True), reps)
        del ref, leaves
        torch.cuda.empty_cache()
        sq = [t.detach()[None].requires_grad_() for t in (q, k, v)]
        s_out = sdpa(*sq, scale=scale)
        library_ms = time_ms(lambda: torch.autograd.grad(
            s_out, sq, dout[None], retain_graph=True), reps)
        del s_out, sq
        b_ms, b_by = attention_bwd_bound(BH, Lq, Lk, D)
        row = dict(kernel="attention_bwd", shape=shape,
                   max_abs_err=max(e[0] for e in errs.values()),
                   rel_norm_err=max(e[1] for e in errs.values()),
                   errs={f"d{n}": dict(max_abs=e[0], rel_norm=e[1])
                         for n, e in errs.items()},
                   tol=dict(atol=GRAD_ULP, rtol=GRAD_ULP,
                            rel_norm=ATTN_REL_NORM),
                   ms=time_ms(lambda: attention_bwd(q, k, v, out, dout, lse,
                                                    scale), 10),
                   backward_ms=time_ms(lambda: attention_backward(
                       q, k, v, out, lse, dout, scale), 10),
                   plain_ms=plain_ms, library_ms=library_ms,
                   plain="autograd of attention_reference (dQ, dK, dV)",
                   library="SDPA's backward (dQ, dK, dV)",
                   bound_ms=b_ms, bound_by=b_by)
        log("kernel", **row)
        rows.append(row)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    return rows


def check_downsample(gen, shapes=DOWN_SHAPES) -> list:
    """The stride-2 conv at the encoder's (B, H, W, C, O) `shapes`, with
    both paddings; cuDNN's stride-2 conv of the input already padded
    beside it."""
    rows = []
    for B, H, W, C, O in shapes:
        for asymmetric_pad in (True, False):
            a = _conv_inputs(gen, B, H, W, C, O)
            x, w, b = a["x"], a["weight"], a["bias"]
            pad = 0 if asymmetric_pad else 1
            Ho, Wo = (H + pad - 2) // 2 + 1, (W + pad - 2) // 2 + 1
            xp = F.pad(x, (0, 0, pad, 1, pad, 1)).permute(0, 3, 1, 2)
            rows.append(_conv_row(
                "downsample_conv3x3", (B, H, W, C, O, asymmetric_pad),
                conv.downsample_conv3x3(x, w, b, asymmetric_pad),
                conv.downsample_conv3x3_ref(x, w, b, asymmetric_pad),
                lambda: conv.downsample_conv3x3(x, w, b, asymmetric_pad),
                lambda: conv.downsample_conv3x3_ref(x, w, b, asymmetric_pad),
                lambda: F.conv2d(xp, w, b, stride=2), 5, 9,
                # x, out, weights in bf16, bias fp32
                2 * (B * H * W * C + B * Ho * Wo * O + 9 * C * O) + 4 * O,
                out_pixels=B * Ho * Wo,
                library_label="F.conv2d stride 2 (cuDNN, channels-last) of "
                              "the input already padded"))
            del a, x, xp
            torch.cuda.empty_cache()
    return rows


def make_trainer(unet, controlnet, vae, cfg: TrainConfig, dtype,
                 lpips=None):
    """(trainer, state) over fp32 models: the ControlNet's fp32 masters in
    the TrainState, the models cast to `dtype` (the ControlNet as the
    working copy, the UNet and the VAE frozen; `lpips`, the perceptual
    term's network, stays fp32 and frozen)."""
    state = TrainState.create(dict(controlnet.named_parameters()),
                              Optimizer(cfg))
    trainer = ControlNetTrainer(
        unet=unet.to(dtype).eval(), controlnet=controlnet.to(dtype),
        vae=vae.to(dtype).eval(),
        schedule=NoiseSchedule.create(SchedulerConfig()), config=cfg,
        lpips=lpips)
    return trainer, state


def train_models(unet_cfg, cn_cfg, vae_cfg, device,
                 controlnet_cls=DualFlowControlNet):
    """fp32 UNet, ControlNet (`controlnet_cls`) and fused-conv VAE on
    `device`."""
    with torch.device(device):
        return (UNet2DConditionModel(unet_cfg), controlnet_cls(cn_cfg),
                AutoencoderKL(vae_cfg, fused_conv=True))


def train_batch(gen, B, res, ctx_dim, device, dtype):
    """A synthetic batch: ground-truth images and anchors uniform in
    [-1, 1], flow ~ 4 N(0, 1) pixels, 77 text tokens."""
    def rand(*shape):
        return torch.rand(shape, device=device, generator=gen) * 2 - 1
    return dict(image=rand(B, res, res, 3).to(dtype),
                cond=rand(B, res, res, 6).to(dtype),
                flow=torch.randn((B, res, res, 4), device=device,
                                 generator=gen) * 4,
                text_embeds=(torch.randn((B, 77, ctx_dim), device=device,
                                         generator=gen) * 0.02).to(dtype))


def fingerprint(*modules) -> torch.Tensor:
    return torch.stack([p.float().sum() for m in modules
                        for p in m.parameters()])


def _warpers(controlnet):
    fe = controlnet.feature_extractor
    return fe.warpers if isinstance(fe, BiDirResidueExtractor) else fe.wrapper


@torch.no_grad()
def positive_confidence(controlnet):
    """Set each level's confidence head (the last bias of `metric_net`, one
    scalar) to 1.  With random weights the extractor's features are small,
    so a level's confidence takes that bias's sign at every pixel: negative
    for half the levels, where `soft_fuse` clamps it to 0 and the level
    passes no gradient back to the extractor at all, whatever the kernels
    do.  A trained extractor's confidences are positive."""
    for warper in _warpers(controlnet):
        warper.metric_net[2].bias.fill_(1.0)


def upstream_of_splats(controlnet):
    """The feature extractor's parameters that feed the splats: the
    pre-extractors, the per-scale extractors and the metric nets (and the
    residue extractor's flow refiners)."""
    if isinstance(controlnet.feature_extractor, BiDirResidueExtractor):
        prefixes = ("prev_pre", "next_pre", "prev_pyramids",
                    "next_pyramids", "flow_refiners", "warpers.")
    else:
        prefixes = ("first_pre", "last_pre", "extractors_", "wrapper.")
    return {n: p for n, p in
            controlnet.feature_extractor.named_parameters()
            if n.startswith(prefixes)}


def zero_grads(params) -> list:
    """Names of the parameters in {name: parameter} with no or an all-zero
    gradient."""
    return [n for n, p in params.items()
            if p.grad is None or not bool(p.grad.abs().sum() > 0)]


def attention_needing_grad(trainer, launches, text_embeds) -> int:
    """The attention launches of a counted step that need a gradient: all
    but those of the frozen UNet's down path and mid block, which do not
    depend on the ControlNet (its mid residual is added after the mid
    block; JAX's VJP drops them too)."""
    unet = trainer.unet
    B = text_embeds.shape[0]

    def independent_of_controlnet():
        t = torch.zeros(B, dtype=torch.long, device="cuda")
        h, _ = unet.encode(torch.zeros(B, RES // 8, RES // 8, 4,
                                       device="cuda"), t, text_embeds)
        unet.mid_block(h, unet.time_emb(t, B), text_embeds.to(unet.dtype))

    with torch.no_grad():
        _, _, frozen = counted(independent_of_controlnet)
    return launches["attention"] - frozen["attention"]


def train(gen) -> dict:
    """The training path at the operating point: TRAIN_STEPS steps, one
    counted, then one step timed stage by stage."""
    unet_cfg, cfg = UNetConfig(), TrainConfig()
    models = train_models(unet_cfg, ControlNetConfig(unet=unet_cfg),
                          VAEConfig(), "cuda")
    for m in models:
        fill_params(m, gen)
    positive_confidence(models[1])
    trainer, state = make_trainer(*models, cfg, torch.bfloat16)
    batch = train_batch(gen, TRAIN_BATCH, RES, unet_cfg.cross_attention_dim,
                        "cuda", torch.bfloat16)
    log("train_setup", batch=TRAIN_BATCH, res=RES,
        trainable=sum(p.numel() for p in state.params.values()),
        frozen=sum(p.numel() for m in (trainer.unet, trainer.vae)
                   for p in m.parameters()))
    masters0 = {n: p.clone() for n, p in state.params.items()}
    frozen0 = fingerprint(trainer.unet, trainer.vae)

    torch.cuda.reset_peak_memory_stats()
    step_s, losses, launches = [], [], None
    for i in range(TRAIN_STEPS):
        def step():
            return trainer.train_step(state, batch, gen)[1]["loss"].item()
        if i == 1:
            loss, s, launches = counted(step)
        else:
            loss, s = timed(step)
        step_s.append(s)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # one more step, synchronised stage by stage
    moments, encode_s = timed(lambda: trainer.moments(batch))
    (loss, _), forward_s = timed(lambda: trainer.loss_fn(batch, gen,
                                                         moments=moments))
    _, backward_s = timed(loss.backward)
    upstream = upstream_of_splats(trainer.controlnet)
    dead = zero_grads(upstream)
    _, update_s = timed(lambda: trainer.update(state))
    losses.append(loss.item())
    with_grad = attention_needing_grad(trainer, launches,
                                       batch["text_embeds"])
    changed = [n for n, p in state.params.items()
               if not torch.equal(p, masters0[n])]
    out = dict(batch=TRAIN_BATCH, res=RES, steps=TRAIN_STEPS,
               step_s=step_s,
               samples_per_s=TRAIN_BATCH / statistics.median(step_s[1:]),
               stages_s=dict(encode=encode_s, forward=forward_s,
                             backward=backward_s, update=update_s),
               peak_mem_gib=peak, losses=losses, launches=launches,
               attention_launches_needing_grad=with_grad,
               masters_changed=f"{len(changed)}/{len(state.params)}",
               upstream_of_splats_with_zero_grad=dead)
    log("train", **out)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: non-finite loss {losses}")
    check_launches("train", launches, {
        **ENCODER_LAUNCHES, "splat_sum": None, "upsample_conv3x3": 0,
        "conv3x3_head": 0, "silu_conv3x3": 0, "attention_bwd": with_grad})
    if with_grad <= 0:
        raise AssertionError("train: no attention call needed a gradient")
    if len(changed) < 0.95 * len(state.params):
        raise AssertionError(f"train: only {out['masters_changed']} master "
                             "tensors changed")
    if not torch.equal(fingerprint(trainer.unet, trainer.vae), frozen0):
        raise AssertionError("train: a frozen parameter changed")
    if not upstream or dead:
        raise AssertionError(f"train: no gradient upstream of the splats: "
                             f"{dead}")
    return out


def train_reference():
    """One step's loss and ControlNet gradients at a tiny config: the card
    (bf16, kernels) against the CPU (fp32, plain versions), with the MSE
    and edge terms, then with the LPIPS term too (the full-width AlexNet
    LPIPS, seeded, fp32 on both sides; TF32 convs on the card)."""
    cfgs = (UNetConfig.tiny(), ControlNetConfig.tiny(),
            VAEConfig(base_channels=8, channel_mults=(1, 1, 2, 2),
                      layers_per_block=1))
    lpips_cpu = LPIPS().eval()
    fill_metric_net(lpips_cpu, torch.Generator().manual_seed(9))
    for label, cfg, lp in (
            ("mse", TrainConfig(), None),
            ("lpips", TrainConfig(lpips_weight=1.0, edge_weight=0.5),
             lpips_cpu)):
        cpu_models = train_models(*cfgs, "cpu")
        card_models = train_models(*cfgs, "cuda")
        for c, g in zip(cpu_models, card_models):
            fill_params(c, torch.Generator().manual_seed(7))
            if isinstance(c, DualFlowControlNet):
                positive_confidence(c)
            g.load_state_dict(c.state_dict())
        cpu, _ = make_trainer(*cpu_models, cfg, torch.float32, lp)
        card, _ = make_trainer(*card_models, cfg, torch.bfloat16,
                               lp and copy.deepcopy(lp).cuda())
        g = torch.Generator().manual_seed(8)
        batch = train_batch(g, 2, 64, 32, "cpu", torch.float32)
        draws = dict(noise=torch.randn(2, 8, 8, 4, generator=g),
                     timesteps=torch.randint(0, 1000, (2,), generator=g),
                     latent_eps=torch.randn(2, 8, 8, 4, generator=g))

        def grads(trainer, batch, draws):
            loss, metrics = trainer.loss_fn(batch, **draws)
            loss.backward()
            gr = trainer.gradients()
            return (loss.item(), metrics.get("loss_lpips"),
                    torch.cat([gr[n].flatten().cpu() for n in sorted(gr)]))

        want_loss, want_lp, want = grads(cpu, batch, draws)
        card_batch = {k: v.cuda() if k == "flow" else v.cuda().bfloat16()
                      for k, v in batch.items()}
        (got_loss, got_lp, got), _, launches = counted(lambda: grads(
            card, card_batch, {k: v.cuda() for k, v in draws.items()}))
        out = dict(terms=label, loss=got_loss, loss_cpu=want_loss,
                   loss_rel_err=abs(got_loss - want_loss) / abs(want_loss),
                   grad_norm=got.norm().item(),
                   grad_norm_cpu=want.norm().item(),
                   grad_norm_rel_err=abs(got.norm().item()
                                         - want.norm().item())
                   / want.norm().item(),
                   grad_cosine=F.cosine_similarity(got, want, dim=0).item(),
                   tol=TRAIN_REF_TOL, launches=launches)
        if lp is not None:
            # the term with its network in bf16: what the limit must refuse
            card.lpips = BF16Autocast(card.lpips)
            with torch.no_grad():
                low_lp = card.loss_fn(card_batch, **{
                    k: v.cuda() for k, v in draws.items()})[1]["loss_lpips"]
            out.update(loss_lpips=got_lp.item(), loss_lpips_cpu=want_lp.item(),
                       loss_lpips_rel_err=abs(got_lp.item() - want_lp.item())
                       / want_lp.item(), loss_lpips_bf16=low_lp.item(),
                       loss_lpips_bf16_rel_err=abs(low_lp.item()
                                                   - want_lp.item())
                       / want_lp.item())
        log("train_reference", **out)
        check_launches("train_reference", launches, {
            name: None for name in ("attention", "attention_bwd",
                                    "splat_sum", "gn_silu_conv3x3",
                                    "downsample_conv3x3")})
        if lp is not None and not (
                want_lp.item() > 0 and abs(got_lp.item() - want_lp.item())
                <= TRAIN_REF_TOL["lpips_rel"] * want_lp.item()):
            raise AssertionError(f"the LPIPS term on the card disagrees "
                                 f"with the CPU: {out}")
        if not (out["loss_rel_err"] <= TRAIN_REF_TOL["loss_rel"]
                and out["grad_norm_rel_err"]
                <= TRAIN_REF_TOL["grad_norm_rel"]
                and out["grad_cosine"] >= TRAIN_REF_TOL["grad_cosine"]):
            raise AssertionError(f"tiny training step on the card disagrees "
                                 f"with the CPU: {out}")


def residual_raw_batch(gen, B, res, device):
    """A synthetic ControlNet batch as the dataset gives it, fp32: the
    ground truth uniform in [-1, 1], the anchors uniform in [0, 1]
    (`make_residue_batch` maps them to [-1, 1]), flow ~ 4 N(0, 1)
    pixels."""
    def rand(*shape):
        return torch.rand(shape, device=device, generator=gen)
    return dict(image=rand(B, res, res, 3) * 2 - 1,
                cond=rand(B, res, res, 6),
                flow=torch.randn((B, res, res, 4), device=device,
                                 generator=gen) * 4)


def build_train_residual(gen) -> types.SimpleNamespace:
    """The residual training path on the card with seeded random weights:
    the trainer and its state over `ResControlNet`, the bf16 CLIP text
    encoder, a raw batch, and its stages as closures: `embed` (captions ->
    text_embeds), `prepare` (the residue batch) and `iteration` (both,
    then one train step; returns the loss)."""
    unet_cfg, cfg = UNetConfig(), TrainConfig()
    models = train_models(unet_cfg, ControlNetConfig(unet=unet_cfg),
                          VAEConfig(), "cuda", ResControlNet)
    with torch.device("cuda"):
        clip = CLIPTextEncoder(CLIPTextConfig())
    for m in models + (clip,):
        fill_params(m, gen)
    positive_confidence(models[1])
    clip = clip.to(torch.bfloat16).eval().requires_grad_(False)
    tokenizer = HashTokenizer(context_length=clip.cfg.max_length)
    trainer, state = make_trainer(*models, cfg, torch.bfloat16)
    raw = residual_raw_batch(gen, TRAIN_BATCH, RES, "cuda")
    captions = CAPTIONS[:TRAIN_BATCH]

    @torch.no_grad()
    def embed():
        return clip(torch.from_numpy(tokenizer(captions)))

    def prepare():
        return make_residue_batch(raw)

    def iteration():
        batch = prepare()
        batch["text_embeds"] = embed()
        return trainer.train_step(state, batch, gen)[1]["loss"].item()

    return types.SimpleNamespace(trainer=trainer, state=state, clip=clip,
                                 embed=embed, prepare=prepare,
                                 iteration=iteration)


def train_residual(gen) -> dict:
    """The residual second stage's training path at the operating point,
    from captions: TRAIN_STEPS iterations of text encode, residue batch
    and train step, one counted; then one iteration timed stage by
    stage."""
    path = build_train_residual(gen)
    trainer, state, clip = path.trainer, path.state, path.clip
    embed, prepare = path.embed, path.prepare
    log("train_residual_setup", batch=TRAIN_BATCH, res=RES,
        trainable=sum(p.numel() for p in state.params.values()),
        frozen=sum(p.numel() for m in (trainer.unet, trainer.vae, clip)
                   for p in m.parameters()),
        text_encoder=sum(p.numel() for p in clip.parameters()))
    masters0 = {n: p.clone() for n, p in state.params.items()}
    frozen0 = fingerprint(trainer.unet, trainer.vae, clip)
    torch.cuda.reset_peak_memory_stats()
    step_s, losses, parts = [], [], None
    for i in range(TRAIN_STEPS):
        if i == 1:
            text, text_s, text_n = counted(embed)
            batch, prep_s, prep_n = counted(prepare)
            batch["text_embeds"] = text
            loss, s, step_n = counted(lambda: trainer.train_step(
                state, batch, gen)[1]["loss"].item())
            parts = dict(text_encode=text_n, residue_batch=prep_n,
                         train_step=step_n)
            s += text_s + prep_s
        else:
            loss, s = timed(path.iteration)
        step_s.append(s)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # one more iteration, synchronised stage by stage
    text, text_s = timed(embed)
    batch, prep_s = timed(prepare)
    batch["text_embeds"] = text
    moments, encode_s = timed(lambda: trainer.moments(batch))
    (loss, _), forward_s = timed(lambda: trainer.loss_fn(batch, gen,
                                                         moments=moments))
    _, backward_s = timed(loss.backward)
    cn = trainer.controlnet
    dead = zero_grads(upstream_of_splats(cn))
    dead_warp = zero_grads(dict(cn.warp_extractor.named_parameters()))
    _, update_s = timed(lambda: trainer.update(state))
    losses.append(loss.item())

    launches = {k: sum(n[k] for n in parts.values())
                for k in parts["train_step"]}
    with_grad = attention_needing_grad(trainer, parts["train_step"],
                                       batch["text_embeds"])
    changed = [n for n, p in state.params.items()
               if not torch.equal(p, masters0[n])]
    warped = batch["warped"]
    out = dict(batch=TRAIN_BATCH, res=RES, steps=TRAIN_STEPS,
               step_s=step_s,
               samples_per_s=TRAIN_BATCH / statistics.median(step_s[1:]),
               stages_s=dict(text_encode=text_s, residue_batch=prep_s,
                             encode=encode_s, forward=forward_s,
                             backward=backward_s, update=update_s),
               peak_mem_gib=peak, losses=losses, launches=launches,
               launches_by_stage=parts,
               attention_launches_needing_grad=with_grad,
               masters_changed=f"{len(changed)}/{len(state.params)}",
               upstream_of_splats_with_zero_grad=dead,
               warp_extractor_with_zero_grad=dead_warp,
               text_embeds=dict(shape=list(text.shape),
                                std=text.float().std().item()),
               warped=dict(min=warped.min().item(), max=warped.max().item(),
                           residual_mean_abs=batch["residual"].abs().mean()
                           .item()))
    log("train_residual", **out)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train_residual: non-finite loss {losses}")
    if not torch.isfinite(text).all() or tuple(text.shape) != (
            TRAIN_BATCH, clip.cfg.max_length,
            trainer.unet.cfg.cross_attention_dim):
        raise AssertionError("train_residual: text embeddings "
                             f"{tuple(text.shape)}, finite "
                             f"{bool(torch.isfinite(text).all())}")
    if not (torch.isfinite(warped).all() and warped.abs().max() <= 1.0):
        raise AssertionError("train_residual: warped prediction outside "
                             "[-1, 1] or not finite")
    check_launches("train_residual (text encode)", parts["text_encode"],
                   {k: 0 for k in parts["text_encode"]})
    check_launches("train_residual (residue batch)", parts["residue_batch"],
                   RESIDUE_BATCH_LAUNCHES)
    check_launches("train_residual (train step)", parts["train_step"], {
        **ENCODER_LAUNCHES, "splat_sum": RESIDUE_EXTRACTOR_SPLATS,
        "upsample_conv3x3": 0, "conv3x3_head": 0, "silu_conv3x3": 0,
        "attention_bwd": with_grad})
    if with_grad <= 0:
        raise AssertionError("train_residual: no attention call needed a "
                             "gradient")
    if len(changed) < 0.95 * len(state.params):
        raise AssertionError(f"train_residual: only "
                             f"{out['masters_changed']} master tensors "
                             "changed")
    if not torch.equal(fingerprint(trainer.unet, trainer.vae, clip),
                       frozen0):
        raise AssertionError("train_residual: a frozen parameter changed")
    if dead or dead_warp:
        raise AssertionError(f"train_residual: parameters without gradient "
                             f"upstream of the splats {dead} or in the "
                             f"warp extractor {dead_warp}")
    return out


def residual_reference():
    """One residual step at a tiny config, its residue batch made on each
    device: the card (bf16, kernels) against the CPU (fp32, plain
    versions) on the same weights, raw batch and draws."""
    cfgs = (UNetConfig.tiny(), ControlNetConfig.tiny(),
            VAEConfig(base_channels=8, channel_mults=(1, 1, 2, 2),
                      layers_per_block=1))
    cpu_models = train_models(*cfgs, "cpu", ResControlNet)
    card_models = train_models(*cfgs, "cuda", ResControlNet)
    for c, g in zip(cpu_models, card_models):
        fill_params(c, torch.Generator().manual_seed(9))
        if isinstance(c, ResControlNet):
            positive_confidence(c)
        g.load_state_dict(c.state_dict())
    cfg = TrainConfig()
    cpu, _ = make_trainer(*cpu_models, cfg, torch.float32)
    card, _ = make_trainer(*card_models, cfg, torch.bfloat16)
    g = torch.Generator().manual_seed(10)
    raw = residual_raw_batch(g, 2, 64, "cpu")
    text = torch.randn((2, 77, 32), generator=g) * 0.02
    draws = dict(noise=torch.randn(2, 8, 8, 4, generator=g),
                 timesteps=torch.randint(0, 1000, (2,), generator=g),
                 latent_eps=torch.randn(2, 8, 8, 4, generator=g))

    def grads(trainer, raw, text, draws):
        batch = make_residue_batch(raw)
        batch["text_embeds"] = text
        loss, _ = trainer.loss_fn(batch, **draws)
        loss.backward()
        gr = trainer.gradients()
        return (batch["warped"].cpu(), loss.item(),
                torch.cat([gr[n].flatten().cpu() for n in sorted(gr)]))

    want_warped, want_loss, want = grads(cpu, raw, text, draws)
    (got_warped, got_loss, got), _, launches = counted(lambda: grads(
        card, {k: v.cuda() for k, v in raw.items()},
        text.cuda().bfloat16(), {k: v.cuda() for k, v in draws.items()}))
    out = dict(warped_max_abs_err=(got_warped - want_warped).abs().max()
               .item(),
               loss=got_loss, loss_cpu=want_loss,
               loss_rel_err=abs(got_loss - want_loss) / abs(want_loss),
               grad_norm=got.norm().item(), grad_norm_cpu=want.norm().item(),
               grad_norm_rel_err=abs(got.norm().item() - want.norm().item())
               / want.norm().item(),
               grad_cosine=F.cosine_similarity(got, want, dim=0).item(),
               tol=dict(TRAIN_REF_TOL, warped_max_abs=RESIDUE_TOL),
               launches=launches)
    log("residual_reference", **out)
    # the residue batch's 2 splats and 2 a level of the tiny extractor
    check_launches("residual_reference", launches, {
        "attention": None, "attention_bwd": None, "gn_silu_conv3x3": None,
        "downsample_conv3x3": None,
        "splat_sum": 2 + 2 * len(cfgs[1].inject_channels)})
    if not (out["warped_max_abs_err"] <= RESIDUE_TOL
            and out["loss_rel_err"] <= TRAIN_REF_TOL["loss_rel"]
            and out["grad_norm_rel_err"] <= TRAIN_REF_TOL["grad_norm_rel"]
            and out["grad_cosine"] >= TRAIN_REF_TOL["grad_cosine"]):
        raise AssertionError(f"tiny residual step on the card disagrees "
                             f"with the CPU: {out}")


def build_residual_ddpm(gen):
    """The residual DDPM on the card with seeded random weights:
    (unet, schedule, raw batch, step), `step()` one training step
    (residue batch, then the AdamW step; returns the loss)."""
    with torch.device("cuda"):
        unet = UNet2DModel()
    fill_params(unet, gen)
    schedule, tx = ddpm_schedule(), ddpm_optimizer()
    opt_state = tx.init(dict(unet.named_parameters()))
    raw = residual_raw_batch(gen, DDPM_BATCH, DDPM_RES, "cuda")

    def step():
        residual = make_residue_batch(raw)["residual"]
        return ddpm_train_step(unet, schedule, tx, opt_state, residual,
                               gen).item()

    return unet, schedule, raw, step


def residual_ddpm(gen) -> dict:
    """The residual pixel DDPM at train_residual.py's defaults: DDPM_STEPS
    steps (residue batch, then the AdamW step), one counted; then one
    ddpm_step from the UNet's output, on the card and on the CPU."""
    unet, schedule, raw, step = build_residual_ddpm(gen)
    log("residual_ddpm_setup", batch=DDPM_BATCH, res=DDPM_RES,
        params=sum(p.numel() for p in unet.parameters()))
    p0 = fingerprint(unet)

    torch.cuda.reset_peak_memory_stats()
    step_s, losses, launches = [], [], None
    for i in range(DDPM_STEPS):
        if i == 1:
            loss, s, launches = counted(step)
        else:
            loss, s = timed(step)
        step_s.append(s)
        losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    # one ancestral step from the UNet's output, card against CPU
    t = 249
    residual = make_residue_batch(raw)["residual"]
    noise = torch.randn(residual.shape, device="cuda", generator=gen)
    x_t = schedule.add_noise(residual, noise, t)
    with torch.no_grad():
        eps = unet(x_t, t)
    z = torch.randn(residual.shape, device="cuda", generator=gen)
    got = ddpm_step(schedule, eps, t, t - 1, x_t, z)
    want = ddpm_step(schedule, eps.cpu(), t, t - 1, x_t.cpu(), z.cpu())
    err = compare("ddpm_step", got.cpu(), want, **DDPM_STEP_TOL)
    out = dict(batch=DDPM_BATCH, res=DDPM_RES, steps=DDPM_STEPS,
               step_s=step_s,
               samples_per_s=DDPM_BATCH / statistics.median(step_s[1:]),
               peak_mem_gib=peak, losses=losses, launches=launches,
               ddpm_step=dict(t=t, max_abs_err=err, tol=DDPM_STEP_TOL,
                              eps_std=eps.std().item()))
    log("residual_ddpm", **out)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"residual_ddpm: non-finite loss {losses}")
    if torch.equal(fingerprint(unet), p0):
        raise AssertionError("residual_ddpm: the parameters did not move")
    check_launches("residual_ddpm", launches, RESIDUE_BATCH_LAUNCHES)
    return out


def distill_models(unet_cfg, cn_cfg, vae_cfg, device, gen):
    """The teacher's fp32 UNet and ControlNet and the fused-conv VAE on
    `device`, seeded random weights, the extractor's confidences positive
    (see `positive_confidence`)."""
    models = train_models(unet_cfg, cn_cfg, vae_cfg, device)
    for m in models:
        fill_params(m, gen)
    positive_confidence(models[1])
    return models


def make_distiller(models, cfg: TrainConfig, dtype):
    """(distiller, state): the student and the EMA warm-started from the
    teacher `models` (UNet, ControlNet, VAE), at the distillation
    script's DistillConfig defaults."""
    return ConsistencyDistiller.create(
        *models, NoiseSchedule.create(SchedulerConfig()), DistillConfig(),
        Optimizer(cfg), dtype)


def distill_batch(gen, B, res, ctx_dim, device, dtype):
    """`train_batch` with the CFG teacher's uncond embeddings (zeros, the
    JAX CLIs' empty prompt without a text encoder)."""
    batch = train_batch(gen, B, res, ctx_dim, device, dtype)
    batch["uncond_embeds"] = torch.zeros_like(batch["text_embeds"])
    return batch


def check_distill_kernels(gen) -> list:
    """Every kernel at the shapes a distillation step at batch 2 gives it
    and no other phase covers: attention at BH = 32 (the CFG teacher, no
    lse) and BH = 16 (the student, lse and backward), splats at B = 8
    (the teacher's pyramid) and 4, the encoder's convs at B = 2."""
    b = DISTILL_BATCH
    return (check_attention(gen, 2 * b * HEADS)
            + check_attention_train(gen, b * HEADS)
            + check_splat(gen, 4 * b) + check_splat(gen, 2 * b)
            + check_gn_conv(gen, [(b,) + s[1:] for s in ENCODER_GN_SHAPES])
            + check_downsample(gen, [(b,) + s[1:] for s in DOWN_SHAPES]))


def staged_distill_step(d, state, batch, gen) -> tuple:
    """One distillation step synchronised stage by stage: `loss_fn` with
    the VAE's encode, the teacher, the student's and the target's
    consistency functions each timed apart (`timed` wrappers on the
    instance), then the backward, the optimizer's update, the EMA and the
    copy into the working copies (`ConsistencyDistiller.update`'s parts).
    Returns (stage seconds, loss, dead gradients, EMA check)."""
    stages = {}

    def stage(name, fn):
        def run(*args, **kwargs):
            out, stages[name] = timed(lambda: fn(*args, **kwargs))
            return out
        return run

    def consistency(net, *args):
        name = "student_forward" if net is d.student else "target"
        return stage(name, ConsistencyDistiller.consistency_fn)(d, net,
                                                                *args)

    d.vae.encode = stage("encode", d.vae.encode)
    d.teacher_eps = stage("teacher", d.teacher_eps)
    d.consistency_fn = consistency
    try:
        loss, _ = d.loss_fn(batch, gen)
    finally:
        del d.vae.encode, d.teacher_eps, d.consistency_fn
    _, stages["backward"] = timed(loss.backward)
    grads = d.gradients()
    dead = {"unet": zero_grads(dict(d.student["unet"].named_parameters())),
            "controlnet": zero_grads(dict(
                d.student["controlnet"].named_parameters())),
            "upstream_of_splats": zero_grads(upstream_of_splats(
                d.student["controlnet"]))}
    for p in d.student.parameters():
        p.grad = None
    name = "unet.conv_in.weight"
    ema_old = state.ema_params[name].clone()
    _, stages["update"] = timed(lambda: state.tx.update(
        state.params, grads, state.opt_state))
    del grads
    state.step += 1
    _, stages["ema"] = timed(lambda: d.update_ema(state))
    _, stages["copy"] = timed(lambda: d.load_params(state))
    # ema <- (1 - decay) new + decay old, against the same sum in fp64:
    # the two products and the sum each round once, by at most 2^-24 of
    # their magnitude, so within 3 x 2^-24 of the result where new and old
    # agree in sign (max_ulps counts in units of 2^-24 |result|)
    decay = d.config.ema_decay
    want = ((1 - decay) * state.params[name].double()
            + decay * ema_old.double())
    ulps = ((state.ema_params[name].double() - want).abs()
            / (want.abs() * 2.0 ** -24 + 1e-30)).max().item()
    return stages, loss.item(), dead, dict(tensor=name, max_ulps=ulps,
                                           limit_ulps=3.0)


def distill(gen) -> tuple:
    """The distillation path at the script's defaults at SD-1.5 width:
    TRAIN_STEPS steps, one counted, then one step timed stage by stage.
    Returns (the line's fields, the EMA masters)."""
    unet_cfg = UNetConfig()
    d, state = make_distiller(
        distill_models(unet_cfg, ControlNetConfig(unet=unet_cfg),
                       VAEConfig(), "cuda", gen),
        DISTILL_TRAIN, torch.bfloat16)
    batch = distill_batch(gen, DISTILL_BATCH, RES,
                          unet_cfg.cross_attention_dim, "cuda",
                          torch.bfloat16)
    log("distill_setup", batch=DISTILL_BATCH, res=RES,
        trainable=sum(p.numel() for p in state.params.values()),
        frozen=sum(p.numel() for m in (d.teacher, d.vae)
                   for p in m.parameters()),
        memory_gib=torch.cuda.memory_allocated() / 2 ** 30)
    masters0 = {n: p.clone() for n, p in state.params.items()}
    frozen0 = fingerprint(d.teacher, d.vae)

    torch.cuda.reset_peak_memory_stats()
    step_s, losses, launches = [], [], None
    for i in range(TRAIN_STEPS):
        def step():
            return d.train_step(state, batch, gen)[1]["loss"].item()
        if i == 1:
            loss, s, launches = counted(step)
        else:
            loss, s = timed(step)
        step_s.append(s)
        losses.append(loss)
    stages, loss, dead, ema = staged_distill_step(d, state, batch, gen)
    losses.append(loss)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = [n for n, p in state.params.items()
               if not torch.equal(p, masters0[n])]
    n_params = {k: sum(1 for _ in d.student[k].parameters())
                for k in ("unet", "controlnet")}
    out = dict(batch=DISTILL_BATCH, res=RES, steps=TRAIN_STEPS + 1,
               step_s=step_s,
               samples_per_s=DISTILL_BATCH / statistics.median(step_s[1:]),
               s_per_step=statistics.median(step_s[1:]), stages_s=stages,
               peak_mem_gib=peak, losses=losses, launches=launches,
               masters_changed=f"{len(changed)}/{len(state.params)}",
               zero_grad_tensors={k: len(v) for k, v in dead.items()},
               zero_grad_names={k: v[:5] for k, v in dead.items()},
               ema_check=ema)
    log("distill", **out)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"distill: non-finite loss {losses}")
    check_launches("distill", launches, DISTILL_LAUNCHES)
    if len(changed) < 0.95 * len(state.params):
        raise AssertionError(f"distill: only {out['masters_changed']} "
                             "master tensors changed")
    if not torch.equal(fingerprint(d.teacher, d.vae), frozen0):
        raise AssertionError("distill: the teacher or the VAE changed")
    if not ema["max_ulps"] <= ema["limit_ulps"]:
        raise AssertionError(f"distill: EMA update off: {ema}")
    for k in ("unet", "controlnet"):
        if len(dead[k]) > 0.01 * n_params[k]:
            raise AssertionError(f"distill: {len(dead[k])} of the student "
                                 f"{k}'s tensors got no gradient: "
                                 f"{dead[k][:5]}")
    if dead["upstream_of_splats"]:
        raise AssertionError(f"distill: no gradient upstream of the "
                             f"splats: {dead['upstream_of_splats']}")
    ema_params = state.ema_params
    del d, state, batch, masters0
    return out, ema_params


def distill_decode(ema_params, gen) -> dict:
    """The `distill` phase's EMA masters put into a fresh fused-conv
    pipeline (`train.distill.load_student`), then the K = 4 512 px
    decode of 7 frames."""
    unet_cfg = UNetConfig()
    pipe = DualFlowPipeline.create(
        unet_cfg, ControlNetConfig(unet=unet_cfg), VAEConfig(),
        SamplerConfig(), dtype=torch.bfloat16, device="cuda",
        fused_conv=True)
    fill_params(pipe.vae, gen)
    load_student(pipe.unet, pipe.controlnet, ema_params)
    loaded = torch.equal(pipe.unet.conv_in.weight,
                         ema_params["unet.conv_in.weight"].bfloat16())
    dpipe = DistilledPipeline.from_pipeline(
        pipe, DistillConfig(num_student_steps=DISTILL_STEPS))
    x = make_inputs(gen, FRAMES, RES, unet_cfg.cross_attention_dim, "cuda",
                    torch.bfloat16)

    def go():
        return dpipe.sample(x["latents"], x["text"], x["cond"], x["flow"],
                            generator=gen)

    torch.cuda.reset_peak_memory_stats()
    images, first_s, launches = counted(go)
    check_images("distill_decode", images)
    check_launches("distill_decode", launches,
                   {"attention": None, "splat_sum": None, "silu_conv3x3": 0,
                    **FUSED_VAE_LAUNCHES, **NO_TRAIN_KERNELS})
    _, second_s = timed(go)
    out = dict(frames=FRAMES, res=RES, steps=DISTILL_STEPS,
               ema_loaded=loaded, first_s=first_s, second_s=second_s,
               frames_per_s=FRAMES / second_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches,
               image_mean_abs=images.float().abs().mean().item())
    log("distill_decode", **out)
    if not loaded:
        raise AssertionError("distill_decode: the EMA did not reach the UNet")
    return out


def distill_reference(workdir: str):
    """One distillation step at a tiny config, the card (bf16, kernels)
    against the CPU (fp32, plain versions) on the same weights, batch and
    draws; then `cli.train_distill`'s loop on the card from a tiny
    diffusers root under `workdir`, its EMA restored by `run_codec`'s
    loader and decoded in 2 steps against `DistilledPipeline` on the
    in-memory EMA.  Returns `distill_cli`'s (run directory, state)."""
    cfgs = (UNetConfig.tiny(), ControlNetConfig.tiny(),
            VAEConfig(base_channels=8, channel_mults=(1, 1, 2, 2),
                      layers_per_block=1))
    cpu_models = distill_models(*cfgs, "cpu", torch.Generator().manual_seed(7))
    card_models = train_models(*cfgs, "cuda")
    bf16_models = train_models(*cfgs, "cpu")
    for c, g, b in zip(cpu_models, card_models, bf16_models):
        g.load_state_dict(c.state_dict())
        b.load_state_dict(c.state_dict())
    runs = {}
    # the CPU in fp32 (the reference), the CPU in bf16 through the plain
    # versions (the witness of what bf16 alone costs), the card
    for run, device, dtype, models in (
            ("cpu", "cpu", torch.float32, cpu_models),
            ("cpu_bf16", "cpu", torch.bfloat16, bf16_models),
            ("card", "cuda", torch.bfloat16, card_models)):
        d, state = make_distiller(models, DISTILL_REF_TRAIN, dtype)
        g = torch.Generator().manual_seed(8)
        batch = distill_batch(g, 2, 64, 32, "cpu", torch.float32)
        draws = dict(latent_eps=torch.randn(2, 8, 8, 4, generator=g),
                     idx=torch.randint(0, 49, (2,), generator=g),
                     noise=torch.randn(2, 8, 8, 4, generator=g))
        if dtype == torch.bfloat16:
            batch = {k: v.to(device) if k == "flow"
                     else v.to(device, torch.bfloat16)
                     for k, v in batch.items()}
            draws = {k: v.to(device) for k, v in draws.items()}
        ema0 = {n: p.clone() for n, p in state.ema_params.items()}
        params0 = {n: p.clone() for n, p in state.params.items()}

        def step():
            loss, _ = d.loss_fn(batch, **draws)
            loss.backward()
            grads = {n: g_.float().flatten().cpu()
                     for n, g_ in d.gradients().items()}
            d.update(state)
            return loss.item(), grads

        (loss, grads), _, launches = counted(step)
        move = {n: (state.params[n] - params0[n]).flatten().cpu()
                for n in params0}
        ema_move = {n: (state.ema_params[n] - ema0[n]).flatten().cpu()
                    for n in ema0}
        runs[run] = dict(loss=loss, grads=grads, move=move,
                         ema_move=ema_move, launches=launches)
    cpu, card, bf16 = runs["cpu"], runs["card"], runs["cpu_bf16"]

    def cat(tree, prefix=""):
        return torch.cat([tree[n] for n in sorted(tree)
                          if n.startswith(prefix)])

    decay = DistillConfig().ema_decay
    ema_rule = ((cat(card["ema_move"]) - (1 - decay) * cat(card["move"]))
                .norm() / ((1 - decay) * cat(card["move"]).norm())).item()
    out = dict(loss=card["loss"], loss_cpu=cpu["loss"],
               loss_rel_err=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
               grad_norm=cat(card["grads"]).norm().item(),
               grad_norm_cpu=cat(cpu["grads"]).norm().item(),
               grad_cosine={k: F.cosine_similarity(
                   cat(card["grads"], k + "."), cat(cpu["grads"], k + "."),
                   dim=0).item() for k in ("unet", "controlnet")},
               loss_bf16_cpu=bf16["loss"],
               grad_cosine_bf16_cpu={k: F.cosine_similarity(
                   cat(bf16["grads"], k + "."), cat(cpu["grads"], k + "."),
                   dim=0).item() for k in ("unet", "controlnet")},
               ema_rule_rel_err=ema_rule,
               ema_cosine=F.cosine_similarity(
                   cat(card["ema_move"]), cat(cpu["ema_move"]), dim=0).item(),
               tol=DISTILL_REF_TOL, launches=card["launches"])
    out["grad_norm_rel_err"] = (abs(out["grad_norm"] - out["grad_norm_cpu"])
                                / out["grad_norm_cpu"])
    log("distill_reference", **out)
    check_launches("distill_reference", card["launches"], {
        name: None for name in ("attention", "attention_bwd", "splat_sum",
                                "gn_silu_conv3x3", "downsample_conv3x3")})
    tol = DISTILL_REF_TOL
    if not (out["loss_rel_err"] <= tol["loss_rel"]
            and out["grad_norm_rel_err"] <= tol["grad_norm_rel"]
            and all(out["grad_cosine"][k] >= out["grad_cosine_bf16_cpu"][k]
                    - tol["grad_cosine_below_bf16"]
                    for k in out["grad_cosine"])
            and out["ema_rule_rel_err"] <= tol["ema_rule_rel"]
            and out["ema_cosine"] >= tol["ema_cosine"]):
        raise AssertionError(f"tiny distillation step on the card disagrees "
                             f"with the CPU: {out}")
    return distill_cli(cfgs, workdir)


def distill_cli(cfgs, workdir: str):
    """`cli.train_distill`'s loop (its `build_distiller` and `train`) on
    the card at the tiny config from a diffusers root written here, on a
    synthetic batch (no PIL on this machine): 2 steps at lr 1e-3, a
    checkpoint a step.  Then `run_codec`'s decode options with
    `--distilled_checkpoint` (`load_decoder`: the EMA restored from
    checkpoint-2): its UNet and ControlNet must hold the bf16 EMA, unlike
    the masters and the teacher, and its decode must match
    `DistilledPipeline` over the root's VAE, the in-memory EMA and the
    root's text encoder, on the same seeded draws, K = 2, while the same
    decode from the masters must not.  The root and the run stay under
    `workdir`; returns (run directory, state)."""
    import argparse
    import logging

    from diffcodec_tpu_torch.cli import run_codec, train_distill

    gen = torch.Generator(device="cuda").manual_seed(12)
    root = os.path.join(workdir, "distill_sd")
    run = os.path.join(workdir, "distill_run")
    with torch.device("cuda"):
        modules = {"unet": UNet2DConditionModel(cfgs[0]),
                   "controlnet": DualFlowControlNet(cfgs[1]),
                   "vae": AutoencoderKL(cfgs[2]),
                   "text": CLIPTextEncoder(CLIPTextConfig.tiny())}
    for m in modules.values():
        fill_params(m, gen)
    positive_confidence(modules["controlnet"])
    checkpoints.synthesize_sd_checkpoint_dir(root, modules)
    del modules
    args = train_distill.parse_args([
        "--index_file", "synthetic", "--output_dir", run, "--tiny",
        "--device", "cuda", "--sd_checkpoint_dir", root,
        "--resolution", "64", "--max_train_steps", "2",
        "--checkpointing_steps", "1", "--log_every", "1",
        "--learning_rate", "1e-3"])
    logger = logging.getLogger("chip_smoke.distill_cli")
    d, state, text_encoder, tokenizer = train_distill.build_distiller(
        args, logger)

    @torch.no_grad()
    def embed_text(texts):
        return text_encoder(torch.from_numpy(tokenizer(list(texts)))
                            .cuda())

    rng = np.random.default_rng(13)
    raw = {"image": rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32),
           "cond": rng.uniform(0, 1, (2, 64, 64, 6)).astype(np.float32),
           "flow": (rng.standard_normal((2, 64, 64, 4)) * 3).astype(
               np.float32),
           "text_embeds": embed_text(["a frame", "another frame"])}
    state, cli_s = timed(lambda: train_distill.train(
        args, d, state, lambda: [raw], embed_text, logger))
    saved = [s for s, _ in list_checkpoints(run)]

    p = argparse.ArgumentParser()
    run_codec.add_decode_options(p)
    dargs = p.parse_args(["--tiny", "--sd_checkpoint_dir", root,
                          "--distilled_checkpoint", run,
                          "--student_steps", "2", "--seed", "5"])
    cli_pipe, text, _ = run_codec.load_decoder(dargs, "cuda")
    restored = dict(denoiser(cli_pipe.unet, cli_pipe.controlnet)
                    .named_parameters())
    teacher = dict(d.teacher.named_parameters())
    weights = dict(
        tensors=len(restored),
        not_ema=sum(not torch.equal(
            p, state.ema_params[n].to(p.dtype)) for n, p in
            restored.items()),
        off_masters=sum(not torch.equal(
            p, state.params[n].to(p.dtype)) for n, p in
            restored.items()),
        off_teacher=sum(not torch.equal(p, teacher[n])
                        for n, p in restored.items()))
    from_cli = run_codec.make_sampler(cli_pipe, text, None, 5, "cuda")
    text, _ = DualFlowPipeline.encode_prompt(text_encoder, tokenizer,
                                             [""], [""])

    def in_memory(params):
        pipe = DualFlowPipeline.create(*cfgs, dtype=torch.bfloat16,
                                       device="cuda")
        pipe.vae.load_state_dict(d.vae.state_dict())
        load_student(pipe.unet, pipe.controlnet, params)
        return run_codec.make_sampler(
            DistilledPipeline.from_pipeline(pipe, DistillConfig(
                num_student_steps=2)), text, None, 5, "cuda")

    cond = torch.from_numpy(raw["cond"]).cuda().bfloat16()
    flow = torch.from_numpy(raw["flow"]).cuda().bfloat16()
    got = from_cli(cond, flow).float()
    want = in_memory(state.ema_params)(cond, flow).float()
    again = in_memory(state.ema_params)(cond, flow).float()
    masters = in_memory(state.params)(cond, flow).float()
    diff = (got - want).abs()
    out = dict(checkpoints=saved, steps=state.step, train_s=cli_s,
               restored=weights, decode_max_abs_err=diff.max().item(),
               decode_mean_abs_err=diff.mean().item(),
               repeat_max_abs_err=(again - want).abs().max().item(),
               masters_max_abs_err=(masters - want).abs().max().item(),
               tol=DISTILL_CLI_DECODE_TOL,
               image_mean_abs=want.abs().mean().item())
    log("distill_cli", **out)
    if saved != [1, 2] or state.step != 2:
        raise AssertionError(f"distill_cli: checkpoints {saved}, step "
                             f"{state.step}")
    if (weights["not_ema"]
            or weights["off_masters"] < 0.9 * weights["tensors"]
            or weights["off_teacher"] < 0.5 * weights["tensors"]):
        raise AssertionError(f"distill_cli: the decode options did not "
                             f"restore the EMA: {weights}")
    tol = DISTILL_CLI_DECODE_TOL
    if not (out["decode_max_abs_err"] <= tol["max_abs"]
            and out["decode_mean_abs_err"] <= tol["mean_abs"]):
        raise AssertionError(f"distill_cli: the decode from the checkpoint "
                             f"disagrees with the in-memory EMA's: {out}")
    if not out["masters_max_abs_err"] > tol["max_abs"]:
        raise AssertionError(f"distill_cli: the decode cannot tell the EMA "
                             f"from the masters: {out}")
    return run, state


def check_validation_kernels(gen) -> list:
    """Every kernel at the shapes `cli.train_controlnet`'s validation
    gives it and no earlier phase did: its 20-step CFG decode of a batch
    of 8 (attention at BH = 2 x 8 x 8, no lse) and the fused VAE
    decoder's convs at B = 8.  Its splats (B = 16) are the training
    phase's shapes."""
    b = VAL_BATCH
    return (check_attention(gen, 2 * b * HEADS)
            + check_gn_conv(gen, [(b,) + s[1:] for s in GN_SHAPES
                                  if s[0] == FRAMES])
            + check_upsample(gen, [(b,) + s[1:] for s in UP_SHAPES]))


def png_pixels(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of an 8-bit RGB PNG whose scanlines all use filter
    0, decoded here with zlib alone: the chunks' CRCs checked, the IDAT
    inflated, the filter bytes checked."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG file")
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != int.from_bytes(
                data[pos + 8 + n:pos + 12 + n], "big"):
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        chunks.setdefault(kind, []).append(body)
        pos += 12 + n
    header = chunks[b"IHDR"][0]
    w, h = int.from_bytes(header[:4], "big"), int.from_bytes(header[4:8],
                                                             "big")
    if header[8:] != bytes([8, 2, 0, 0, 0]):
        raise AssertionError(f"{path}: not 8-bit RGB: {header[8:]!r}")
    rows = np.frombuffer(zlib.decompress(b"".join(chunks[b"IDAT"])),
                         np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: a scanline uses a filter")
    return rows[:, 1:].reshape(h, w, 3)


def _cli_batch(gen, B, res, embed_text) -> dict:
    """A dataset batch as `UniDataset` gives it (numpy, fp32): the ground
    truth uniform in [-1, 1], the anchors uniform in [0, 1], flow ~ 4
    N(0, 1) pixels; with `CAPTIONS` embedded as 'text_embeds'."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda").cpu().numpy()
    captions = (CAPTIONS * B)[:B]
    return {"image": rand(B, res, res, 3) * 2 - 1,
            "cond": rand(B, res, res, 6),
            "flow": torch.randn((B, res, res, 4), generator=gen,
                                device="cuda").cpu().numpy() * 4,
            "text": captions, "text_embeds": embed_text(captions)}


class _Samples:
    """An indexable dataset over a numpy batch, without augmentation (the
    latent cache's input)."""
    transform = False

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return len(self.batch["text"])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.batch.items()}


def _instrumented(trainer, validate):
    """Time and count every `train_step` and validation `train` makes,
    and record what `save_checkpoint` writes and the images the
    validation pipeline decodes (instance attributes over the methods;
    the module's `save_checkpoint` swapped, which `train` imports at its
    call).  Returns (record, the validation wrapped, undo)."""
    from diffcodec_tpu_torch.train import checkpoint as ckpt_mod

    rec = dict(step_s=[], launches=[], val_s=[], val_launches=[],
               images=[], saves=[])
    step_fn, save_fn = trainer.train_step, ckpt_mod.save_checkpoint
    sample_fn = validate.pipeline.sample

    def train_step(*a, **kw):
        (out, s, n) = counted(lambda: step_fn(*a, **kw))
        rec["step_s"].append(s)
        rec["launches"].append(n)
        return out

    def sample(*a, **kw):
        images = sample_fn(*a, **kw)
        rec["images"].append(images)
        return images

    def validated(state, step, metrics_logger):
        (out, s, n) = counted(lambda: validate(state, step, metrics_logger))
        rec["val_s"].append(s)
        rec["val_launches"].append(n)
        return out

    def save_checkpoint(ckpt_dir, step, state, total_limit=None):
        if step == 2:  # the masters `export` holds its file to
            rec["masters2"] = {k: v.detach().cpu().clone()
                               for k, v in state["params"].items()}
        (path, s) = timed(lambda: save_fn(ckpt_dir, step, state,
                                          total_limit))
        nbytes = os.path.getsize(os.path.join(path, "state.pt"))
        rec["saves"].append(dict(step=step, s=s, bytes=nbytes))
        return path

    trainer.train_step = train_step
    validate.pipeline.sample = sample
    ckpt_mod.save_checkpoint = save_checkpoint

    def undo():
        del trainer.train_step
        del validate.pipeline.sample
        ckpt_mod.save_checkpoint = save_fn

    return rec, validated, undo


def _train_cli_args(run, *extra):
    from diffcodec_tpu_torch.cli import train_controlnet
    return train_controlnet.parse_args([
        "--index_file", "synthetic", "--output_dir", run,
        "--resolution", str(RES), "--train_batch_size", str(TRAIN_BATCH),
        "--learning_rate", "1e-5", "--mixed_precision", "bf16",
        "--checkpointing_steps", "2", "--validation_steps", "2",
        "--log_every", "1", "--device", "cuda", "--seed", "0", *extra])


def train_cli(gen, workdir: str, train_samples_per_s: float) -> tuple:
    """`cli.train_controlnet`'s `build_trainer` and `train` at SD-1.5
    width on the card (its defaults from `--seed`: the UNet, the fused
    VAE, the CLIP tower and the ControlNet), fed a synthetic batch of 8
    at 512 px through `batches` (no PIL on this machine): AdamW 1e-5,
    bf16 over fp32 masters; checkpoints and validation every 2 steps, 3
    steps; then `--resume_from_checkpoint latest` to step 4, against the
    same step taken by the uninterrupted trainer; then `--latent_cache_dir`
    over 16 samples and one step from the cache.  Returns the line's
    fields and the checkpoint-2 masters (for `export`)."""
    import logging

    from diffcodec_tpu_torch.cli import train_controlnet
    from diffcodec_tpu_torch.cli.train_distill import step_generator
    from diffcodec_tpu_torch.train.latent_cache import (
        LatentCachedDataset, precompute_latent_moments)
    from diffcodec_tpu_torch.train.dataset import iter_dataset_batches
    from diffcodec_tpu_torch.train.validation import to_uint8

    logger = logging.getLogger("chip_smoke.train_cli")
    run = os.path.join(workdir, "controlnet_run")
    args = _train_cli_args(run, "--max_train_steps", str(TRAIN_CLI_STEPS))
    torch.cuda.reset_peak_memory_stats()
    (trainer, state, text_encoder, tokenizer), build_s = timed(
        lambda: train_controlnet.build_trainer(args, logger))

    @torch.no_grad()
    def embed_text(texts):
        return text_encoder(torch.from_numpy(tokenizer(list(texts)))
                            .cuda())

    raw = _cli_batch(gen, TRAIN_BATCH, RES, embed_text)
    val_batch = _cli_batch(gen, VAL_BATCH, RES, embed_text)
    validate = train_controlnet.make_validator(args, trainer, val_batch)
    rec, validated, undo = _instrumented(trainer, validate)
    try:
        state, train_s = timed(lambda: train_controlnet.train(
            args, trainer, state, lambda: [raw], embed_text, logger,
            validated))
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    batch = train_controlnet.device_batch(raw, torch.bfloat16, "cuda")
    with_grad = attention_needing_grad(trainer, rec["launches"][1],
                                       batch["text_embeds"])

    # the 8 panels of step 2 against the pipeline's images
    images = to_uint8(rec["images"][0].float().cpu().numpy())
    panels = sorted(os.listdir(os.path.join(run, "validation")))
    panel_mismatch = []
    for b, name in enumerate(panels):
        px = png_pixels(os.path.join(run, "validation", name))
        if px.shape != (RES, 4 * RES, 3) or not np.array_equal(
                px[:, 2 * RES:3 * RES], images[b]):
            panel_mismatch.append(name)

    # resume: a second trainer from checkpoint-3 against the first one's
    # fourth step, the same draws (step_generator(seed, 3))
    a3 = {n: p.clone() for n, p in state.params.items()}
    args4 = _train_cli_args(run, "--max_train_steps", "4",
                            "--resume_from_checkpoint", "latest",
                            "--checkpointing_steps", "0")
    (resumed, rstate, _, _), resume_build_s = timed(
        lambda: train_controlnet.build_trainer(args4, logger))
    restored = dict(
        step=rstate.step, count=rstate.opt_state["count"],
        params_differ=sum(not torch.equal(rstate.params[n], p)
                          for n, p in state.params.items()),
        moments_differ=sum(
            not torch.equal(rstate.opt_state[k][n], state.opt_state[k][n])
            for k in ("mu", "nu") for n in state.params))
    rstate = train_controlnet.train(args4, resumed, rstate, lambda: [raw],
                                    embed_text, logger)
    saved = [s for s, _ in list_checkpoints(run)]
    disk_free_gb = shutil.disk_usage(run).free / 1e9
    trainer.train_step(state, batch, step_generator(args.seed, 3, "cuda"))
    move = torch.cat([(state.params[n] - a3[n]).flatten()
                      for n in sorted(a3)])
    apart = torch.cat([(rstate.params[n] - state.params[n]).flatten()
                       for n in sorted(a3)])
    resume = dict(restored=restored, steps=[state.step, rstate.step],
                  counts=[state.opt_state["count"],
                          rstate.opt_state["count"]],
                  max_abs_diff=apart.abs().max().item(),
                  rel_to_step=(apart.norm() / move.norm()).item(),
                  tol=TRAIN_CLI_RESUME_REL)
    del resumed, rstate, a3, move, apart
    torch.cuda.empty_cache()

    # the latent cache: 16 samples encoded by the fused encoder in batches
    # of 8, against the same batches' moments on the fly; then one step
    # from the cache
    cache_dir = os.path.join(workdir, "latent_cache")
    a, b = (_cli_batch(gen, TRAIN_BATCH, RES, embed_text) for _ in range(2))
    samples = _Samples({"image": np.concatenate([a["image"], b["image"]]),
                        "cond": np.concatenate([a["cond"], b["cond"]]),
                        "flow": np.concatenate([a["flow"], b["flow"]]),
                        "text": a["text"] + b["text"]})
    n_cached, cache_s = timed(lambda: precompute_latent_moments(
        trainer.vae, samples, cache_dir, batch_size=TRAIN_BATCH))
    cached = LatentCachedDataset(samples, cache_dir)
    cache_err = 0.0
    for s0 in range(0, n_cached, TRAIN_BATCH):
        idx = range(s0, s0 + TRAIN_BATCH)
        imgs = torch.from_numpy(np.stack([samples[i]["image"]
                                          for i in idx])).cuda()
        want = torch.cat(trainer.moments({"image": imgs}), dim=-1).float()
        got = torch.from_numpy(np.stack([cached[i]["latent_moments"]
                                         for i in idx])).cuda()
        cache_err = max(cache_err, compare(
            "latent cache", got, want,
            LATENT_CACHE_ULP * want.abs().max().item(), LATENT_CACHE_ULP))
    cache_batch = next(iter_dataset_batches(cached, TRAIN_BATCH,
                                            text_encoder=embed_text,
                                            shuffle=False))
    step_batch = train_controlnet.device_batch(cache_batch, torch.bfloat16,
                                               "cuda")
    _, cached_s, cached_launches = counted(lambda: trainer.train_step(
        state, step_batch, step_generator(args.seed, state.step, "cuda")))

    saves = [dict(step=r["step"], s=r["s"], gb=r["bytes"] / 1e9,
                  gb_per_s=r["bytes"] / 1e9 / r["s"]) for r in rec["saves"]]
    out = dict(batch=TRAIN_BATCH, res=RES, steps=TRAIN_CLI_STEPS,
               build_s=build_s, train_s=train_s, step_s=rec["step_s"],
               samples_per_s=TRAIN_BATCH / statistics.median(rec["step_s"]),
               train_phase_samples_per_s=train_samples_per_s,
               validation_s=rec["val_s"], checkpoints=saved, saves=saves,
               disk_free_gb=disk_free_gb,
               peak_mem_gib=peak, launches=rec["launches"],
               attention_launches_needing_grad=with_grad,
               validation_launches=rec["val_launches"],
               panels=len(panels), panel_mismatch=panel_mismatch,
               resume_build_s=resume_build_s, resume=resume,
               latent_cache=dict(samples=n_cached, s=cache_s,
                                 max_abs_err=cache_err,
                                 tol_ulp=LATENT_CACHE_ULP,
                                 step_s=cached_s,
                                 step_launches=cached_launches))
    log("train_cli", **out)
    if saved != [2, 3, 4] or state.step != 5:
        raise AssertionError(f"train_cli: checkpoints {saved}, step "
                             f"{state.step}")
    for i, n in enumerate(rec["launches"]):
        check_launches(f"train_cli step {i + 1}", n, {
            **ENCODER_LAUNCHES, "splat_sum": None, "upsample_conv3x3": 0,
            "conv3x3_head": 0, "silu_conv3x3": 0,
            "attention_bwd": with_grad})
    if len(rec["val_launches"]) != 1:
        raise AssertionError(f"train_cli: {len(rec['val_launches'])} "
                             "validations, expected 1 (step 2)")
    check_launches("train_cli validation", rec["val_launches"][0], {
        "attention": VAL_STEPS * 46, "splat_sum": 8, "silu_conv3x3": 0,
        **FUSED_VAE_LAUNCHES, **NO_TRAIN_KERNELS})
    if len(panels) != VAL_BATCH or panel_mismatch:
        raise AssertionError(f"train_cli: panels {panels}, mismatching "
                             f"{panel_mismatch}")
    if (restored["step"] != 3 or restored["count"] != 3
            or restored["params_differ"] or restored["moments_differ"]):
        raise AssertionError(f"train_cli: the resumed state is not the "
                             f"saved one: {restored}")
    if (resume["steps"] != [4, 4] or resume["counts"] != [4, 4]
            or not resume["rel_to_step"] <= TRAIN_CLI_RESUME_REL):
        raise AssertionError(f"train_cli: the resumed step 4 parts from "
                             f"the uninterrupted one: {resume}")
    check_launches("train_cli cached step", cached_launches, {
        "gn_silu_conv3x3": 0, "downsample_conv3x3": 0, "attention": None,
        "attention_bwd": with_grad, "splat_sum": None})
    masters2 = rec["masters2"]
    del trainer, state, text_encoder, rec
    torch.cuda.empty_cache()
    return out, run, masters2


def export(run: str, masters2: dict, distill_run: str, distill_state,
           workdir: str) -> dict:
    """`cli.export_checkpoint` on `train_cli`'s checkpoint-2 (SD-1.5
    width), loaded by `models.weights.load_sd_checkpoint_dir` into a fresh
    DualFlowControlNet on the card: every tensor the step-2 fp32 masters,
    bit for bit; then `--distilled` on `distill_cli`'s tiny checkpoint-2:
    both files the EMA's tensors, bit for bit."""
    from diffcodec_tpu_torch.cli import export_checkpoint
    from diffcodec_tpu_torch.train.checkpoint import restore_checkpoint
    from diffcodec_tpu_torch.utils.safetensors_io import load_file

    path = os.path.join(workdir, "controlnet.safetensors")
    _, write_s = timed(lambda: export_checkpoint.main(
        ["--checkpoint_dir", run, "--step", "2", "--out", path]))
    nbytes = os.path.getsize(path)
    unet_cfg = UNetConfig()
    with torch.device("cuda"):
        fresh = DualFlowControlNet(ControlNetConfig(unet=unet_cfg))
    _, read_s = timed(lambda: checkpoints.load_sd_checkpoint_dir(
        workdir, {"controlnet": fresh}, controlnet_path=path))
    own = dict(fresh.named_parameters())
    differ = [n for n, p in own.items()
              if not torch.equal(p.cpu(), masters2[n])]
    missing = sorted(set(masters2) ^ set(own))

    out_dir = os.path.join(workdir, "student_export")
    export_checkpoint.main(["--distilled", "--tiny", "--checkpoint_dir",
                            distill_run, "--step", "2", "--out", out_dir])
    saved, _ = restore_checkpoint(distill_run, 2)
    files = sorted(os.listdir(out_dir))
    student_differ = []
    for name in ("controlnet", "unet"):
        sd = load_file(os.path.join(out_dir, f"{name}.safetensors"))
        ema = {n[len(name) + 1:]: t for n, t in saved["ema_params"].items()
               if n.startswith(name + ".")}
        if set(sd) != set(ema):
            student_differ.append(f"{name}: names")
        student_differ += [f"{name}.{n}" for n, t in sd.items()
                           if n in ema and not (
                               torch.equal(t, ema[n]) and torch.equal(
                                   t, distill_state.ema_params[
                                       f"{name}.{n}"].cpu()))]
    out = dict(tensors=len(own), bytes=nbytes, write_s=write_s,
               write_gb_per_s=nbytes / 1e9 / write_s, read_s=read_s,
               read_gb_per_s=nbytes / 1e9 / read_s, differ=len(differ),
               missing=missing, student_files=files,
               student_differ=student_differ)
    log("export", **out)
    if differ or missing or student_differ or files != [
            "controlnet.safetensors", "unet.safetensors"]:
        raise AssertionError(f"export: {out}")
    return out


def approx_drift(workdir: str) -> tuple:
    """`cli.approx_drift` at its defaults (512 px, 30 steps, batch 7, CFG
    3.5, FreeU, bf16, SD-1.5 width), its JSON into `workdir`: each mode's
    seconds, frames/s and kernel launches (its `run_mode` wrapped here),
    the drift of each cached mode against exact; the ControlNet and
    UNet-encoder calls and the attention launches asserted from (ci, ei)
    and the 30 steps, 8 splats a decode, the VAE on cuDNN."""
    from diffcodec_tpu_torch.cli import approx_drift as drift_cli

    run_mode, launches = drift_cli.run_mode, []

    def counted_mode(*a, **kw):
        result, _, n = counted(lambda: run_mode(*a, **kw))
        launches.append(n)
        return result

    drift_cli.run_mode = counted_mode
    try:
        record, runs = drift_cli.main(
            ["--out", os.path.join(workdir, "approx_drift.json")])
    finally:
        drift_cli.run_mode = run_mode
    modes = {}
    for (name, ci, ei), n in zip(drift_cli.MODES, launches):
        r = runs[name]
        modes[name] = dict(seconds=r["seconds"],
                           frames_per_s=r["frames_per_s"], calls=r["calls"],
                           launches=n, **record["modes"][name])
    out = dict(operating_point=record["operating_point"], modes=modes)
    log("approx_drift", **out)
    for (name, ci, ei), n in zip(drift_cli.MODES, launches):
        cn, enc = -(-STEPS // ci), -(-STEPS // ei)
        if modes[name]["calls"] != {"controlnet": cn, "unet_encoder": enc}:
            raise AssertionError(f"approx_drift {name}: calls "
                                 f"{modes[name]['calls']}, expected "
                                 f"{cn}, {enc}")
        # attention: the ControlNet's 14 a call, the UNet's down path's 12
        # an encoder call, its mid block's and up path's 20 every step
        check_launches(f"approx_drift {name}", n, {
            "attention": 14 * cn + 12 * enc + 20 * STEPS, "splat_sum": 8,
            "gn_silu_conv3x3": 0, "conv3x3_head": 0, "upsample_conv3x3": 0,
            "silu_conv3x3": 0, **NO_TRAIN_KERNELS})
    exact = record["modes"]["exact"]
    if exact["latent_mse"] != 0.0 or any(
            not math.isfinite(m["latent_rel_rms"])
            for k, m in record["modes"].items() if k != "exact"):
        raise AssertionError(f"approx_drift: {record['modes']}")
    return out, launches[0]



def _cmp_cfg(module=None, data=None):
    """The shipped CMP config (`CMP_SHIPPED`) with `module` and `data`
    keys replaced, parsed by `train.cmp_config`."""
    raw = json.loads(json.dumps(CMP_SHIPPED))
    raw["model"]["module"].update(module or {})
    raw["data"].update(data or {})
    return cmp_config.parse_cmp_config(raw)


def _cmp_batch(cfg, n: int, crop: int, seed: int) -> dict:
    """n synthetic samples as `cli.train_cmp` makes them (its bank and
    the config's sparse sampler), numpy."""
    rng = np.random.default_rng(seed)
    imgs, flows = train_cmp._synthetic_bank(n, crop, rng)

    def sample_sparse(flow):
        sparse, mask = flow_sampler(
            flow, strategy=tuple(cfg.data.sample_strategy),
            bg_ratio=cfg.data.sample_bg_ratio, nms_ks=cfg.data.nms_ks,
            max_num_guide=cfg.data.max_num_guide, rng=rng)
        return np.concatenate([sparse, mask[..., :2].astype(np.float32)],
                              axis=-1)

    return train_cmp.make_batch(imgs, flows, np.arange(n), sample_sparse)


def _cmp_steps(cfg, batch, steps: int, device="cuda"):
    """`steps` training steps of the config's CMP (from seed 0) on one
    batch: (the trainer, step seconds, the losses, the launches of the
    second step)."""
    trainer = train_cmp.build(cfg, 0, device)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    step_s, losses, launches = [], [], None
    for i in range(steps):
        def step():
            return trainer.train_step(b, torch.Generator(
                device=device).manual_seed(i)).item()
        if i == 1:
            loss, s, launches = counted(step)
        else:
            loss, s = timed(step)
        step_s.append(s)
        losses.append(loss)
    return trainer, step_s, losses, launches


def _cmp_reference(cfg) -> dict:
    """One step of the shipped config at CMP_REF_CROP from the same
    weights and batch: on the CPU, on the card with cuDNN's TF32 off (the
    reading held to CMP_TRAIN_TOL) and on the card as it runs (TF32
    convs).  Each reading: the loss's relative difference, the running
    statistics' and the parameters' distance from the CPU's, relative to
    the CPU step's move of them."""
    batch = _cmp_batch(cfg, cfg.data.batch_size, CMP_REF_CROP, 7)
    cpu = train_cmp.build(cfg, 0, "cpu")
    p0 = {n: p.detach().clone() for n, p in cpu.params().items()}
    s0 = {n: b.clone() for n, b in cpu.batch_stats().items()}
    loss = cpu.train_step({k: torch.from_numpy(v) for k, v in batch.items()}
                          ).item()

    def rel(got, want, start):
        num = sum(((got[n].cpu() - want[n]) ** 2).sum() for n in want)
        den = sum(((want[n] - start[n]) ** 2).sum() for n in want)
        return (num / den).sqrt().item()

    readings = {}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for name, allow in (("fp32", False), ("tf32", True)):
            torch.backends.cudnn.allow_tf32 = allow
            card = train_cmp.build(cfg, 0, "cuda")
            got = card.train_step({k: torch.from_numpy(v).cuda()
                                   for k, v in batch.items()}).item()
            readings[name] = dict(
                loss_rel=abs(got - loss) / abs(loss),
                stats_rel_move=rel(card.batch_stats(), cpu.batch_stats(),
                                   s0),
                params_rel_move=rel(card.params(), cpu.params(), p0))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return dict(crop=CMP_REF_CROP, batch=cfg.data.batch_size, loss=loss,
                **readings)


def cmp_train_phase(workdir: str) -> dict:
    """The CMP trainer on the card: the shipped config at full width
    (CMP_TRAIN_STEPS steps, samples/s of the median of the last 5, peak
    memory, launches), the card's step against the CPU's
    (`_cmp_reference`), `quantize_flow`'s bins against the CPU's, one
    timed step of each other variant, then `cli.train_cmp` from a JSON
    config: saved, resumed bit-identically, its counter continued."""
    cfg = _cmp_cfg()
    B, crop = cfg.data.batch_size, cfg.data.crop_size[0]
    batch = _cmp_batch(cfg, B, crop, 3)
    torch.cuda.reset_peak_memory_stats()
    trainer, step_s, losses, launches = _cmp_steps(cfg, batch,
                                                   CMP_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in trainer.params().values())
    del trainer
    torch.cuda.empty_cache()

    sweep = torch.linspace(-51.0, 51.0, 400001)
    edges = (torch.arange(100, dtype=torch.float32)
             * torch.tensor(100 / 99, dtype=torch.float32) - 50.0)
    sweep = torch.cat([sweep, edges, torch.nextafter(edges, edges + 1),
                       torch.nextafter(edges, edges - 1)])
    flow = sweep.reshape(1, 1, -1, 1).repeat(1, 1, 1, 2)
    bins_differ = int((cmp_train_mod.quantize_flow(flow.cuda()).cpu()
                       != cmp_train_mod.quantize_flow(flow)).sum())

    variants = {}
    for name, (module, vb) in CMP_VARIANTS.items():
        vcfg = _cmp_cfg(module, {"batch_size": vb})
        vbatch = _cmp_batch(vcfg, vb, crop, 4)
        tr, vs, vl, vn = _cmp_steps(vcfg, vbatch, 2)
        variants[name] = dict(batch=vb, crop=crop, step_s=vs[1],
                              samples_per_s=vb / vs[1], losses=vl,
                              launches=vn)
        del tr
        torch.cuda.empty_cache()
    reference = _cmp_reference(cfg)
    cli = _cmp_cli(workdir)
    out = dict(config="resnet50 + skip, 198 logits", batch=B, crop=crop,
               params=n_params, steps=CMP_TRAIN_STEPS, step_s=step_s,
               samples_per_s=B / statistics.median(step_s[1:]),
               peak_mem_gib=peak, losses=losses, launches=launches,
               quantize_bins_differ=bins_differ, variants=variants,
               vs_cpu=reference, tol=CMP_TRAIN_TOL, cli=cli)
    log("cmp_train", **out)
    if not all(map(math.isfinite, losses + [
            x for v in variants.values() for x in v["losses"]])):
        raise AssertionError("cmp_train: a non-finite loss")
    for path, n in [("cmp_train", launches)] + [
            (k, v["launches"]) for k, v in variants.items()]:
        check_launches(path, n, {k: 0 for k in n})
    if bins_differ:
        raise AssertionError(f"cmp_train: {bins_differ} quantize_flow bins "
                             "differ between the card and the CPU")
    r = reference["fp32"]
    if not all(r[k] <= CMP_TRAIN_TOL[k] for k in CMP_TRAIN_TOL):
        raise AssertionError(f"cmp_train: the card's fp32 step disagrees "
                             f"with the CPU's: {reference}")
    return out


def _cmp_cli(workdir: str) -> dict:
    """`cli.train_cmp` from the shipped config written as JSON (no PyYAML
    on this machine): --synthetic 8 --crop 128 to iter 2 with a
    checkpoint each step, then --resume latest to iter 3.  Asserts the
    restored state bit-identical to checkpoint-2 and the counter
    continued."""
    import contextlib
    import io

    from diffcodec_tpu_torch.train.checkpoint import _map_tensors

    run = os.path.join(workdir, "cmp_run")
    path = os.path.join(workdir, "cmp_config.json")
    with open(path, "w") as f:
        json.dump(CMP_SHIPPED, f)
    common = ["--config", path, "--output_dir", run, "--synthetic", "8",
              "--crop", "128", "--save_freq", "1", "--device", "cuda"]
    restored = []
    load = cmp_train_mod.CMPTrainer.load_state_dict

    def snapshot(state):
        return {"params": dict(state["params"]),
                "batch_stats": dict(state["batch_stats"]),
                "trace": dict(state["opt_state"]["trace"]),
                "count": state["opt_state"]["count"]}

    def load_and_keep(self, state):
        load(self, state)
        restored.append(snapshot(_map_tensors(
            self.state_dict(), lambda t: t.detach().cpu().clone())))
        return self

    texts = []
    for extra in (["--total_iter", "2"],
                  ["--total_iter", "3", "--resume", "latest"]):
        out = io.StringIO()
        cmp_train_mod.CMPTrainer.load_state_dict = load_and_keep
        try:
            with contextlib.redirect_stdout(out):
                train_cmp.main(common + extra)
        finally:
            cmp_train_mod.CMPTrainer.load_state_dict = load
        texts.append(out.getvalue())
        if extra[-1] == "2":
            saved = snapshot(restore_checkpoint(run, 2)[0])
    (state,) = restored
    differ = [f"{k}.{n}" for k in ("params", "batch_stats", "trace")
              for n, t in saved[k].items() if not torch.equal(state[k][n], t)]
    iters = [line.split()[1] for t in texts for line in t.splitlines()
             if line.startswith("iter ")]
    out = dict(iters=iters, resumed="resumed from checkpoint-2" in texts[1],
               restored_count=state["count"], saved_count=saved["count"],
               restored_differ=len(differ),
               checkpoints=[s for s, _ in list_checkpoints(run)])
    if (differ or not out["resumed"] or iters != ["2/2", "3/3"]
            or state["count"] != 2 or out["checkpoints"] != [1, 2, 3]):
        raise AssertionError(f"cmp_train cli: {out} {differ[:5]}")
    return out


def mesh_phase() -> dict:
    """The mesh on the card: this script's `mesh_worker` under torchrun as
    a one-rank NCCL group on 127.0.0.1 and a free port."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "mesh.json")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node=1", "--master_addr=127.0.0.1",
             f"--master_port={port}", os.path.abspath(__file__),
             "--mesh-worker", out], capture_output=True, text=True,
            timeout=MESH_TIMEOUT_S)
        seconds = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"mesh: the worker failed "
                                 f"({proc.returncode}):\n"
                                 f"{proc.stdout[-4000:]}\n"
                                 f"{proc.stderr[-8000:]}")
        with open(out) as f:
            result = json.load(f)
    result["seconds"] = seconds
    log("mesh", **result)
    return result


def _mesh_trainer(saved=None, mesh=None):
    """`train`'s models and batch (seeded alike each call, batch 8 at
    512 px) in a trainer: its state loaded from `saved` where given, then
    put on `mesh` where given."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    unet_cfg = UNetConfig()
    models = train_models(unet_cfg, ControlNetConfig(unet=unet_cfg),
                          VAEConfig(), "cuda")
    for m in models:
        fill_params(m, gen)
    positive_confidence(models[1])
    trainer, state = make_trainer(*models, TrainConfig(), torch.bfloat16)
    batch = train_batch(gen, TRAIN_BATCH, RES, unet_cfg.cross_attention_dim,
                        "cuda", torch.bfloat16)
    if saved is not None:
        state.load_state_dict(saved)
        trainer.load_params(state.params)
    if mesh is not None:
        state = trainer.shard_state(mesh, state)
    return trainer, state, batch


def mesh_worker(out_path: str) -> int:
    """The `mesh` phase's work, in a torchrun process: `make_mesh` (1 x 1,
    NCCL), a sharded full-width ControlNet step against the unsharded one
    from the same state on the same draws (to MESH_STEP_REL of the step's
    move: the splat's and the attention backward's fp32 atomics),
    `train_controlnet --fsdp 1` through the mesh path on synthetic batches
    (no PIL here), then the dry run's five paths at one rank; launches of
    each."""
    import logging

    from diffcodec_tpu_torch.cli import train_controlnet
    from diffcodec_tpu_torch.config import MeshConfig
    from diffcodec_tpu_torch.parallel import dryrun
    from diffcodec_tpu_torch.parallel.mesh import join_mesh, make_mesh
    import torch.distributed as dist

    _kernels.lib()
    mesh = make_mesh(MeshConfig(), "cuda")
    out = dict(mesh=mesh.shape, backend=dist.get_backend(),
               world=dist.get_world_size())
    # step 2 of one trainer, and of a second one on the mesh from the
    # first's state after step 1 (as train_cli holds resume: a first Adam
    # step moves every element by +-lr, and the atomics flip the sign of
    # the ones whose gradient is ~0)
    from diffcodec_tpu_torch.cli.train_distill import step_generator
    from diffcodec_tpu_torch.train.checkpoint import _map_tensors

    trainer, state, batch = _mesh_trainer()
    trainer.train_step(state, batch, step_generator(0, 0, "cuda"))
    saved = _map_tensors(state.state_dict(), lambda t: t.cpu().clone())
    _, m1 = trainer.train_step(state, batch, step_generator(0, 1, "cuda"))
    one = {n: p.clone() for n, p in state.params.items()}
    del trainer, state
    torch.cuda.empty_cache()
    trainer, state, batch = _mesh_trainer(saved, mesh)
    (state, m2), _, launches = counted(lambda: trainer.train_step(
        state, batch, step_generator(0, 1, "cuda")))
    sharded = state.state_dict()["params"]
    move = torch.cat([(one[n] - saved["params"][n].cuda()).flatten()
                      for n in sorted(one)])
    apart = torch.cat([(sharded[n] - one[n]).flatten() for n in sorted(one)])
    out["step"] = dict(batch=TRAIN_BATCH, res=RES, step=2,
                       loss=[m1["loss"].item(), m2["loss"].item()],
                       rel_to_step=(apart.norm() / move.norm()).item(),
                       max_abs_diff=apart.abs().max().item(),
                       tol=MESH_STEP_REL, launches=launches)
    del trainer, state, saved, one, sharded, move, apart
    torch.cuda.empty_cache()

    logger = logging.getLogger("chip_smoke.mesh")
    with tempfile.TemporaryDirectory() as workdir:
        run = os.path.join(workdir, "run")
        args = _train_cli_args(run, "--max_train_steps", "2", "--fsdp", "1",
                               "--validation_steps", "0")
        trainer, state, text_encoder, tokenizer = \
            train_controlnet.build_trainer(args, logger)
        state = trainer.shard_state(join_mesh(args.fsdp, args.device),
                                    state)

        @torch.no_grad()
        def embed_text(texts):
            return text_encoder(torch.from_numpy(tokenizer(list(texts)))
                                .cuda())

        gen = torch.Generator(device="cuda").manual_seed(43)
        raw = _cli_batch(gen, TRAIN_BATCH, RES, embed_text)
        state, _, cli_launches = counted(lambda: train_controlnet.train(
            args, trainer, state, lambda: [raw], embed_text, logger))
        out["cli"] = dict(steps=state.step, launches=cli_launches,
                          checkpoints=[s for s, _ in list_checkpoints(run)])
    del trainer, state, text_encoder
    torch.cuda.empty_cache()
    out["dryrun"] = dryrun.run(mesh, "cuda")
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def check_mesh(result: dict):
    """The mesh phase's assertions, on the worker's numbers."""
    step, cli, dr = result["step"], result["cli"], result["dryrun"]
    if result["mesh"] != {"data": 1, "fsdp": 1} or result["backend"] != \
            "nccl":
        raise AssertionError(f"mesh: {result['mesh']} {result['backend']}")
    if not step["rel_to_step"] <= MESH_STEP_REL or not all(
            map(math.isfinite, step["loss"])):
        raise AssertionError(f"mesh: the sharded step is not the "
                             f"unsharded one: {step}")
    check_launches("mesh step", step["launches"], {
        **ENCODER_LAUNCHES, "splat_sum": None, "attention": None,
        "attention_bwd": None, "upsample_conv3x3": 0, "conv3x3_head": 0,
        "silu_conv3x3": 0})
    if cli["steps"] != 2 or cli["checkpoints"] != [2]:
        raise AssertionError(f"mesh: train_controlnet --fsdp 1: {cli}")
    check_launches("mesh cli", cli["launches"], {
        "attention_bwd": None, "downsample_conv3x3": None})
    expected = {"train": {"attention": None, "attention_bwd": None,
                          "splat_sum": None},
                "decode": {"attention": None, "splat_sum": None,
                           **NO_TRAIN_KERNELS},
                "distill": {"attention": None, "attention_bwd": None,
                            "splat_sum": None},
                "tiled": {"attention": None, "splat_sum": None,
                          **NO_TRAIN_KERNELS},
                "sparse": {"attention": None, "splat_sum": None,
                           **NO_TRAIN_KERNELS}}
    for path, want in expected.items():
        check_launches(f"mesh dryrun {path}", dr[path]["launches"], want)


def summary(rows, paths, name, source, replaces, main_path, heaviest=None,
            **extra):
    """One kernel's entry of the `kernels` line: its heaviest shape's
    numbers (the largest bound, among the rows `heaviest` takes where it
    is given), its worst error over every shape (each shape's limit is on
    its own `kernel` line), and its launches in `main_path`'s run and in
    every decode's."""
    mine = [r for r in rows if r["kernel"] == name]
    top = max((r for r in mine if heaviest is None or heaviest(r)),
              key=lambda r: r["bound_ms"])
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=paths[main_path][name], launches_in=main_path,
                launches_by_path={p: n[name] for p, n in paths.items()},
                max_abs_err=max(r["max_abs_err"] for r in mine),
                shape=top["shape"], ms=top["ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"],
                **({"flow": top["flow"]} if "flow" in top else {}),
                **extra)


def main() -> int:
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    _kernels.lib()
    log("build", seconds=_kernels.LIBRARY.build_seconds,
        compiled=_kernels.LIBRARY.compiled, library=_kernels.LIBRARY.path)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = check_attention(gen) + check_splat(gen) + check_conv(gen)
    rows += check_tiled_kernels(gen)
    dec, pipe, x, final = decode(gen)
    fused_out, fused = decode_fusedconv(pipe, x, final)
    distilled = decode_distilled(fused, x, gen)
    del pipe, final
    torch.cuda.empty_cache()
    _, cmp_model = cmp_phase()
    tiled = tiled_exact(fused, gen)
    codec_out, decoded, frames = codec(fused, cmp_model, gen)
    ckpt, aux = checkpoint(fused, x, cmp_model, gen)
    del fused, cmp_model
    torch.cuda.empty_cache()
    evaluate(decoded, frames, aux)
    del aux, decoded, frames
    torch.cuda.empty_cache()
    reference_check()
    tiled_reference()
    fullwidth()
    deep_launches = fulldepth()
    torch.cuda.empty_cache()

    rows += (check_attention_train(gen) + check_downsample(gen)
             + check_gn_conv(gen, ENCODER_GN_SHAPES)
             + check_splat(gen, 2 * TRAIN_BATCH))
    trained = train(gen)
    torch.cuda.empty_cache()
    train_reference()

    ddpm_shapes = [(DDPM_RES, c) for _, c in RESIDUE_SPLAT_SHAPES]
    rows += (check_splat(gen, 2 * TRAIN_BATCH, RESIDUE_SPLAT_SHAPES)
             + check_splat(gen, TRAIN_BATCH, RESIDUE_SPLAT_SHAPES)
             + check_splat(gen, 2 * DDPM_BATCH, ddpm_shapes)
             + check_splat(gen, DDPM_BATCH, ddpm_shapes))
    torch.cuda.empty_cache()
    residual = train_residual(gen)
    torch.cuda.empty_cache()
    residual_reference()
    ddpm = residual_ddpm(gen)
    torch.cuda.empty_cache()

    rows += check_distill_kernels(gen)
    torch.cuda.empty_cache()
    distilled_train, ema_params = distill(gen)
    torch.cuda.empty_cache()
    distilled_decode = distill_decode(ema_params, gen)
    del ema_params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        distill_run, distill_state = distill_reference(work)
        torch.cuda.empty_cache()
        rows += check_validation_kernels(gen)
        torch.cuda.empty_cache()
        cli_out, run, masters2 = train_cli(gen, work,
                                           trained["samples_per_s"])
        export(run, masters2, distill_run, distill_state, work)
        del masters2, distill_state
        torch.cuda.empty_cache()
        _, drift_launches = approx_drift(work)
        torch.cuda.empty_cache()
        cmp_trained = cmp_train_phase(work)
        torch.cuda.empty_cache()
    meshed = mesh_phase()
    check_mesh(meshed)

    paths = {"decode": dec["launches"],
             "decode_fusedconv": fused_out["launches"],
             "decode_distilled": distilled["launches"],
             "tiled_exact": tiled["launches"],
             "codec": codec_out["launches"],
             "checkpoint": ckpt["decode"]["launches"],
             "train": trained["launches"],
             "train_residual": residual["launches"],
             "residual_ddpm": ddpm["launches"],
             "distill": distilled_train["launches"],
             "distill_decode": distilled_decode["launches"],
             "train_cli": cli_out["launches"][1],
             "train_cli_validation": cli_out["validation_launches"][0],
             "approx_drift": drift_launches,
             "fulldepth": deep_launches,
             "cmp_train": cmp_trained["launches"],
             "mesh": meshed["step"]["launches"],
             "mesh_cli": meshed["cli"]["launches"],
             **{f"dryrun_{k}": v["launches"]
                for k, v in meshed["dryrun"].items() if k != "mesh"}}
    cu = "diffcodec_tpu_torch/csrc/"
    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    kernels = [
        summary(rows, paths, "attention", cu + "attention.cu",
                "diffcodec_tpu/ops/attention.py:94", "decode",
                # the same function's other TPU kernel (stock Pallas flash)
                also_replaces="diffcodec_tpu/models/layers.py:195",
                note="attention_fwd_kernel: persistent Hopper kernel "
                     "(TMA loads of Q and a K/V ring on mbarriers, three "
                     "wgmma consumer warpgroups at D <= 64 and two above, "
                     "ping-pong, S of tile j before P V of tile j - 1, "
                     "ex2.approx); serves every self- and cross-attention "
                     "call, with lse where a gradient is wanted"),
        summary(rows, paths, "attention_bwd", cu + "attention.cu",
                flash + ":941", "train", also_replaces=flash + ":1287",
                note="one kernel for dQ, dK and dV; ms is the wrapper "
                     "attention_bwd, whose one C call also runs the delta "
                     "and dQ-zeroing pass and the dQ cast; backward_ms is "
                     "attention_backward, the same plus dout.contiguous()"),
        summary(rows, paths, "splat_sum", cu + "splat.cu",
                "diffcodec_tpu/ops/softsplat_pallas.py:112", "decode",
                # the C >= 16 kernel's heaviest shape (the residual
                # shapes' bounds are larger; the small channels' shapes
                # are on their own `kernel` lines)
                heaviest=lambda r: r["shape"][-1] >= 16,
                note="splat_sum_kernel (C >= 16): a warp a pixel, each "
                     "corner's row in v4 reductions (red.global.add.v4.f32) "
                     "over its 16-byte-aligned body and scalar ones over "
                     "its unaligned head and tail; C = 3 on rows padded "
                     "to 4 floats; splat_tile_kernel (C = 3, 4 from 256 x "
                     "256 an image and 2^21 pixels a launch: the residue "
                     "transform's [16, 512, 512, c], the DDPM's [32, 256, "
                     "256, c]): a block a 32 x 32 tile, its corners sorted "
                     "by destination in shared memory (integer atomics), "
                     "one v4 reduction a destination row; splat_rows_kernel"
                     " (C = 3, 4 below, the decode's occlusion splats): a "
                     "thread a pixel, lane pairs, corners shared with the "
                     "next lane merged; splat_small_kernel (C = 1, 2 and "
                     "5-15, no path's): 8 lanes a pixel, a scalar reduction"
                     " a channel and corner"),
        summary(rows, paths, "gn_silu_conv3x3", cu + "conv3x3.cu",
                "diffcodec_tpu/ops/conv_pallas.py:211", "decode_fusedconv",
                note="conv3x3_hopper where O > 8 (its launches include the "
                     "out-head's, which conv3x3_head lists)"),
        summary(rows, paths, "conv3x3_head", cu + "conv3x3.cu",
                "diffcodec_tpu/ops/conv_pallas.py:211", "decode_fusedconv",
                note="conv3x3_head: dc_conv3x3 where O <= 8, the VAE's "
                     "128 -> 3 out-head, project-then-stencil (the Hopper "
                     "counterpart of conv_pallas.py:424 "
                     "gn_silu_conv3x3_projected): a 12 x 16 tile's halo by "
                     "TMA in chunks of 64 channels, activated in place, "
                     "projected onto 32 columns (9 taps x 3 channels) by "
                     "wgmma, the 9 taps summed from fp32 projections in "
                     "shared memory; 3 blocks an SM"),
        summary(rows, paths, "upsample_conv3x3", cu + "conv3x3.cu",
                "diffcodec_tpu/ops/conv_pallas.py:531", "decode_fusedconv",
                note="conv3x3_hopper in its upsample mode at every O: a "
                     "tile is one output phase of 16 x 16 input positions "
                     "by 128 output channels, read from the stride-1 halo "
                     "by 4 collapsed taps a chunk"),
        summary(rows, paths, "downsample_conv3x3", cu + "conv3x3.cu",
                "diffcodec_tpu/ops/conv_pallas.py:703", "train"),
        summary(rows, paths, "silu_conv3x3", cu + "conv3x3.cu",
                "diffcodec_tpu/ops/conv_pallas.py:96", "decode_fusedconv",
                also_replaces="scripts/conv_kernel_experiment.py:100",
                note="gn_silu_conv3x3's kernel with the affine compiled "
                     "out; no decode path calls it (the JAX package never "
                     "launched it at 512 px either), so it is held here "
                     "against its plain version only"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
