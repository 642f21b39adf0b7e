#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printed as one JSON line with the elapsed seconds `t`:
  device     the card, torch and CUDA versions (exits non-zero without CUDA)
  build      nvcc builds the kernels of `diffcodec_tpu_torch/csrc/`
  kernel     each kernel against its plain PyTorch version at every shape
             the decodes give it: max abs error and tolerance, the kernel's,
             the plain version's and, where one PyTorch call computes the
             same function (or, for the convs, its conv part), that call's
             time (CUDA events, median of per-call times), and the bound
  decode     the port's main path: `DualFlowPipeline.sample` at SD-1.5
             full width, 7 frames (one GOP-8) at 512 x 512, 30 UniPC steps
             with CFG 3.5, ControlNet scale 1.35 and FreeU, bf16, seeded
             random weights; launch counts are zeroed just before and read
             just after
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
  reference  the same pipeline at a tiny config on the card (bf16, kernels)
             against the CPU (fp32, plain versions) on the same weights,
             with the VAE unfused and fused
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
             ControlNet's gradients
Then a {"kernels": [...]} line, the `nvidia-smi` name and power limit, and
last {"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from diffcodec_tpu_torch import _kernels
from diffcodec_tpu_torch.config import (ControlNetConfig, DistillConfig,
                                        SamplerConfig, SchedulerConfig,
                                        TrainConfig, UNetConfig, VAEConfig)
from diffcodec_tpu_torch.ops import conv
from diffcodec_tpu_torch.ops.attention import (attention, attention_backward,
                                               attention_bwd,
                                               attention_forward,
                                               attention_reference)
from diffcodec_tpu_torch.ops.softsplat import splat_sum, splat_sum_reference
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL, decode_from_latents
from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from diffcodec_tpu_torch.train.trainer import (ControlNetTrainer, Optimizer,
                                               TrainState)

T0 = time.perf_counter()
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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
# relative rounding through a dozen layers
TRAIN_REF_TOL = dict(loss_rel=0.02, grad_norm_rel=0.05, grad_cosine=0.98)


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


def check_attention(gen) -> list:
    rows = []
    for Lq, Lk, D in ATTN_SHAPES:
        BH = BATCH * HEADS
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


def check_splat(gen, batch: int = BATCH) -> list:
    """The splat at the extractor's shapes for `batch` splats (2 flow
    directions per sample)."""
    rows = []
    for R, C in SPLAT_SHAPES:
        vals = torch.randn(batch, R, R, C, device="cuda", generator=gen)
        flow = torch.randn(batch, R, R, 2, device="cuda", generator=gen) * 3
        flow[0, 1, :4, 0] = float("nan")        # dropped pixels
        flow[1, :, -1, 0] = R + 2.0             # lands out of frame
        flow[2, 0, :, 1] = -1e9
        err = compare(f"splat_sum {[batch, R, R, C]}", splat_sum(vals, flow),
                      splat_sum_reference(vals, flow), **SPLAT_TOL)
        n = batch * R * R
        # a multiply and an add per corner and channel, fp32; vals and
        # flow read, out written
        b_ms, b_by = bound(4 * 2 * n * C, 4 * n * (2 * C + 2),
                           PEAK_FP32_FLOPS)
        row = dict(kernel="splat_sum", shape=[batch, R, R, C],
                   max_abs_err=err, tol=SPLAT_TOL,
                   ms=time_ms(lambda: splat_sum(vals, flow), 20),
                   plain_ms=time_ms(lambda: splat_sum_reference(vals, flow),
                                    20),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log("kernel", **row)
        rows.append(row)
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


def check_conv(gen) -> list:
    """Each conv kernel at every shape the fused decoder gives it."""
    rows = check_gn_conv(gen, GN_SHAPES)
    for B, H, W, C, O in UP_SHAPES:
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
    counters = {"attention": attention,
                "attention_bwd": attention_bwd,
                "splat_sum": splat_sum,
                "gn_silu_conv3x3": conv.gn_silu_conv3x3,
                "conv3x3_head": conv.projected_head,
                "silu_conv3x3": conv.silu_conv3x3,
                "upsample_conv3x3": conv.upsample_conv3x3,
                "downsample_conv3x3": conv.downsample_conv3x3}
    for c in counters.values():
        c.launches = 0
    result, seconds = timed(fn)
    return result, seconds, {k: c.launches for k, c in counters.items()}


def check_images(label, images, frames=FRAMES, res=RES):
    if tuple(images.shape) != (frames, res, res, 3):
        raise AssertionError(f"{label}: shape {tuple(images.shape)}")
    if not torch.isfinite(images).all():
        raise AssertionError(f"{label}: non-finite values")


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

    _, second_s = timed(lambda: run(pipe, x))
    # the pyramid alone, the denoise loop (pyramid included), the VAE
    with torch.no_grad():
        _, pyramid_s = timed(lambda: pipe.controlnet.extract_pyramid(
            x["cond"], x["flow"]))
    final, denoise_s = timed(lambda: pipe.denoise(
        x["latents"], x["text"], x["uncond"], x["cond"], x["flow"]))
    with torch.no_grad():
        _, vae_s = timed(lambda: decode_from_latents(pipe.vae, final))
    out = dict(frames=FRAMES, res=RES, steps=STEPS, first_s=first_s,
               second_s=second_s, frames_per_s=FRAMES / second_s,
               stages_s=dict(pyramid=pyramid_s, denoise=denoise_s,
                             vae=vae_s),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches,
               image_mean_abs=images.float().abs().mean().item(),
               image_std=images.float().std().item())
    log("decode", **out)
    return out, pipe, x, final


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


def attention_bwd_bound(BH, Lq, Lk, D):
    """(ms, 'operations' | 'bytes') of the attention backward as a
    function, (q, k, v, out, dout, lse) -> (dq, dk, dv): S, dP, dV, dK and
    dQ (5 products) and rowsum(dout * out); q, k, v, out and dout read in
    bf16 and lse in fp32, dq, dk and dv written in bf16, each once."""
    return bound(10.0 * BH * Lq * Lk * D + 2.0 * BH * Lq * D,
                 2 * BH * D * (3 * Lq + 2 * Lk) + 4 * BH * Lq
                 + 2 * BH * D * (Lq + 2 * Lk),
                 PEAK_BF16_FLOPS)


def check_attention_train(gen) -> list:
    """The attention kernels at every shape of a batch-8 training step:
    the forward with its log-sum-exp, and the backward kernel against
    autograd of the plain version (dQ, dK and dV)."""
    rows = []
    sdpa = F.scaled_dot_product_attention
    for Lq, Lk, D in ATTN_SHAPES:
        BH, scale = TRAIN_BH, D ** -0.5
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


def check_downsample(gen) -> list:
    """The stride-2 conv at the encoder's shapes, with both paddings;
    cuDNN's stride-2 conv of the input already padded beside it."""
    rows = []
    for B, H, W, C, O in DOWN_SHAPES:
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


def make_trainer(unet, controlnet, vae, cfg: TrainConfig, dtype):
    """(trainer, state) over fp32 models: the ControlNet's fp32 masters in
    the TrainState, the models cast to `dtype` (the ControlNet as the
    working copy, the UNet and the VAE frozen)."""
    state = TrainState.create(dict(controlnet.named_parameters()),
                              Optimizer(cfg))
    trainer = ControlNetTrainer(
        unet=unet.to(dtype).eval(), controlnet=controlnet.to(dtype),
        vae=vae.to(dtype).eval(),
        schedule=NoiseSchedule.create(SchedulerConfig()), config=cfg)
    return trainer, state


def train_models(unet_cfg, cn_cfg, vae_cfg, device):
    """fp32 UNet, ControlNet and fused-conv VAE on `device`."""
    with torch.device(device):
        return (UNet2DConditionModel(unet_cfg), DualFlowControlNet(cn_cfg),
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


@torch.no_grad()
def positive_confidence(controlnet):
    """Set each level's confidence head (the last bias of `metric_net`, one
    scalar) to 1.  With random weights the extractor's features are small,
    so a level's confidence takes that bias's sign at every pixel: negative
    for half the levels, where `soft_fuse` clamps it to 0 and the level
    passes no gradient back to the extractor at all, whatever the kernels
    do.  A trained extractor's confidences are positive."""
    for warper in controlnet.feature_extractor.wrapper:
        warper.metric_net[2].bias.fill_(1.0)


def upstream_of_splats(controlnet):
    """The feature extractor's parameters that feed the splats: the
    pre-extractors, the per-scale extractors and the metric nets."""
    return {n: p for n, p in
            controlnet.feature_extractor.named_parameters()
            if n.startswith(("first_pre", "last_pre", "extractors_",
                             "wrapper."))}


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
    dead = [n for n, p in upstream.items()
            if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    _, update_s = timed(lambda: trainer.update(state))
    losses.append(loss.item())

    # the frozen UNet's down path and mid block do not depend on the
    # ControlNet (its mid residual is added after the mid block), so their
    # attention calls need no gradient (JAX's VJP drops them too)
    unet = trainer.unet

    def independent_of_controlnet():
        t = torch.zeros(TRAIN_BATCH, dtype=torch.long, device="cuda")
        h, _ = unet.encode(torch.zeros(TRAIN_BATCH, RES // 8, RES // 8, 4,
                                       device="cuda"), t,
                           batch["text_embeds"])
        unet.mid_block(h, unet.time_emb(t, TRAIN_BATCH),
                       batch["text_embeds"].to(unet.dtype))

    with torch.no_grad():
        _, _, frozen_launches = counted(independent_of_controlnet)
    with_grad = launches["attention"] - frozen_launches["attention"]
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
    (bf16, kernels) against the CPU (fp32, plain versions)."""
    cfgs = (UNetConfig.tiny(), ControlNetConfig.tiny(),
            VAEConfig(base_channels=8, channel_mults=(1, 1, 2, 2),
                      layers_per_block=1))
    cpu_models = train_models(*cfgs, "cpu")
    card_models = train_models(*cfgs, "cuda")
    for c, g in zip(cpu_models, card_models):
        fill_params(c, torch.Generator().manual_seed(7))
        if isinstance(c, DualFlowControlNet):
            positive_confidence(c)
        g.load_state_dict(c.state_dict())
    cfg = TrainConfig()
    cpu, _ = make_trainer(*cpu_models, cfg, torch.float32)
    card, _ = make_trainer(*card_models, cfg, torch.bfloat16)
    g = torch.Generator().manual_seed(8)
    batch = train_batch(g, 2, 64, 32, "cpu", torch.float32)
    draws = dict(noise=torch.randn(2, 8, 8, 4, generator=g),
                 timesteps=torch.randint(0, 1000, (2,), generator=g),
                 latent_eps=torch.randn(2, 8, 8, 4, generator=g))

    def grads(trainer, batch, draws):
        loss, _ = trainer.loss_fn(batch, **draws)
        loss.backward()
        gr = trainer.gradients()
        return loss.item(), torch.cat([gr[n].flatten().cpu() for n in
                                       sorted(gr)])

    want_loss, want = grads(cpu, batch, draws)
    card_batch = {k: v.cuda() if k == "flow" else v.cuda().bfloat16()
                  for k, v in batch.items()}
    (got_loss, got), _, launches = counted(lambda: grads(
        card, card_batch, {k: v.cuda() for k, v in draws.items()}))
    out = dict(loss=got_loss, loss_cpu=want_loss,
               loss_rel_err=abs(got_loss - want_loss) / abs(want_loss),
               grad_norm=got.norm().item(), grad_norm_cpu=want.norm().item(),
               grad_norm_rel_err=abs(got.norm().item() - want.norm().item())
               / want.norm().item(),
               grad_cosine=F.cosine_similarity(got, want, dim=0).item(),
               tol=TRAIN_REF_TOL, launches=launches)
    log("train_reference", **out)
    check_launches("train_reference", launches, {
        name: None for name in ("attention", "attention_bwd", "splat_sum",
                                "gn_silu_conv3x3", "downsample_conv3x3")})
    if not (out["loss_rel_err"] <= TRAIN_REF_TOL["loss_rel"]
            and out["grad_norm_rel_err"] <= TRAIN_REF_TOL["grad_norm_rel"]
            and out["grad_cosine"] >= TRAIN_REF_TOL["grad_cosine"]):
        raise AssertionError(f"tiny training step on the card disagrees "
                             f"with the CPU: {out}")


def summary(rows, paths, name, source, replaces, main_path, **extra):
    """One kernel's entry of the `kernels` line: its heaviest shape's
    numbers (the largest bound), its worst error over every shape (each
    shape's limit is on its own `kernel` line), and its launches in
    `main_path`'s run and in every decode's."""
    mine = [r for r in rows if r["kernel"] == name]
    top = max(mine, key=lambda r: r["bound_ms"])
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=paths[main_path][name], launches_in=main_path,
                launches_by_path={p: n[name] for p, n in paths.items()},
                max_abs_err=max(r["max_abs_err"] for r in mine),
                shape=top["shape"], ms=top["ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"],
                **extra)


def main() -> int:
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
    dec, pipe, x, final = decode(gen)
    fused_out, fused = decode_fusedconv(pipe, x, final)
    distilled = decode_distilled(fused, x, gen)
    del pipe, fused, final
    torch.cuda.empty_cache()
    reference_check()

    rows += (check_attention_train(gen) + check_downsample(gen)
             + check_gn_conv(gen, ENCODER_GN_SHAPES)
             + check_splat(gen, 2 * TRAIN_BATCH))
    trained = train(gen)
    torch.cuda.empty_cache()
    train_reference()

    paths = {"decode": dec["launches"],
             "decode_fusedconv": fused_out["launches"],
             "decode_distilled": distilled["launches"],
             "train": trained["launches"]}
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
                note="splat_sum_kernel (C >= 16): a warp a pixel, each "
                     "corner's row in v4 reductions (red.global.add.v4.f32) "
                     "over its 16-byte-aligned body and scalar ones over "
                     "its unaligned head and tail; splat_small_kernel "
                     "(C < 16): PR 4's scalar reductions"),
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
