#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Phases, each printed as one JSON line with the elapsed seconds `t`:
  device     the card, torch and CUDA versions (exits non-zero without CUDA)
  build      nvcc builds the kernels of `diffcodec_tpu_torch/csrc/`
  kernel     each kernel against its plain PyTorch version at every shape
             the decode gives it: max abs error and tolerance, the kernel's,
             the plain version's and, where one PyTorch call computes the
             same function, that call's time (CUDA events), and the bound
  decode     the port's main path: `DualFlowPipeline.sample` at SD-1.5
             full width, 7 frames (one GOP-8) at 512 x 512, 30 UniPC steps
             with CFG 3.5, ControlNet scale 1.35 and FreeU, bf16, seeded
             random weights; launch counts are zeroed just before and read
             just after
  reference  the same pipeline at a tiny config on the card (bf16, kernels)
             against the CPU (fp32, plain versions) on the same weights
Then a {"kernels": [...]} line, the `nvidia-smi` name and power limit, and
last {"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from diffcodec_tpu_torch import _kernels
from diffcodec_tpu_torch.config import (ControlNetConfig, SamplerConfig,
                                        UNetConfig, VAEConfig)
from diffcodec_tpu_torch.ops.attention import attention, attention_reference
from diffcodec_tpu_torch.ops.softsplat import splat_sum, splat_sum_reference
from diffcodec_tpu_torch.models.vae import decode_from_latents
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline

T0 = time.perf_counter()
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate
# outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak_flops: float):
    """Least time the card could take: (ms, 'operations' | 'bytes'), each
    input read once and each output written once."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_attention(gen) -> list:
    rows = []
    for Lq, Lk, D in ATTN_SHAPES:
        BH = BATCH * HEADS
        q, k, v = (torch.randn(BH, L, D, device="cuda", generator=gen)
                   .bfloat16() for L in (Lq, Lk, Lk))
        scale = D ** -0.5
        got = attention(q, k, v, scale)
        want = attention_reference(q, k, v, scale)
        label = f"attention {[BH, Lq, Lk, D]}"
        tol = dict(atol=ATTN_ULP * want.float().abs().max().item(),
                   rtol=ATTN_ULP, rel_norm=ATTN_REL_NORM)
        err = compare(label, got, want, tol["atol"], tol["rtol"])
        rel_norm = ((got.float() - want.float()).norm()
                    / want.float().norm()).item()
        if not rel_norm <= tol["rel_norm"]:
            raise AssertionError(f"{label}: ||error|| / ||plain|| = "
                                 f"{rel_norm} > {tol['rel_norm']}")
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


def check_splat(gen) -> list:
    rows = []
    for R, C in SPLAT_SHAPES:
        vals = torch.randn(BATCH, R, R, C, device="cuda", generator=gen)
        flow = torch.randn(BATCH, R, R, 2, device="cuda", generator=gen) * 3
        flow[0, 1, :4, 0] = float("nan")        # dropped pixels
        flow[1, :, -1, 0] = R + 2.0             # lands out of frame
        flow[2, 0, :, 1] = -1e9
        err = compare(f"splat_sum {[BATCH, R, R, C]}", splat_sum(vals, flow),
                      splat_sum_reference(vals, flow), **SPLAT_TOL)
        n = BATCH * R * R
        # a multiply and an add per corner and channel, fp32; vals and
        # flow read, out written
        b_ms, b_by = bound(4 * 2 * n * C, 4 * n * (2 * C + 2),
                           PEAK_FP32_FLOPS)
        row = dict(kernel="splat_sum", shape=[BATCH, R, R, C],
                   max_abs_err=err, tol=SPLAT_TOL,
                   ms=time_ms(lambda: splat_sum(vals, flow), 20),
                   plain_ms=time_ms(lambda: splat_sum_reference(vals, flow),
                                    20),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log("kernel", **row)
        rows.append(row)
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


def decode(gen) -> dict:
    """The main path once with launch counts, once more for the
    steady-state time, then its stages timed apart."""
    pipe, x = build_decode(gen)
    n_params = sum(p.numel() for m in (pipe.unet, pipe.controlnet, pipe.vae)
                   for p in m.parameters())
    log("decode_setup", params=n_params)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    attention.launches = 0
    splat_sum.launches = 0
    images, first_s = timed(lambda: run(pipe, x))
    launches = {"attention": attention.launches,
                "splat_sum": splat_sum.launches}
    if tuple(images.shape) != (FRAMES, RES, RES, 3):
        raise AssertionError(f"decode shape {tuple(images.shape)}")
    if not torch.isfinite(images).all():
        raise AssertionError("decode produced non-finite values")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the decode")

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
    return out


def reference_check():
    """Tiny pipeline: card (bf16, kernels) against CPU (fp32, plain)."""
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
    want = run(cpu, x)
    before = (attention.launches, splat_sum.launches)
    # the initial noise stays fp32, as the pipeline carries it
    x_card = {k: v.cuda() if k == "latents" else v.cuda().bfloat16()
              for k, v in x.items()}
    got = run(card, x_card)
    torch.cuda.synchronize()
    if (attention.launches == before[0]
            or splat_sum.launches == before[1]):
        raise AssertionError("the tiny decode on the card did not launch "
                             "both kernels")
    diff = (got.float().cpu() - want).abs()
    # bf16 (8-bit mantissa) through the networks and 3 UniPC steps against
    # fp32 on the CPU
    tol = dict(max_abs=0.25, mean_abs=0.02)
    out = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
               tol=tol, want_mean_abs=want.abs().mean().item())
    log("reference", **out)
    if not (out["max_abs_err"] <= tol["max_abs"]
            and out["mean_abs_err"] <= tol["mean_abs"]):
        raise AssertionError(f"tiny decode on the card disagrees with the "
                             f"CPU: {out}")


def summary(rows, launches, name, source, replaces):
    mine = [r for r in rows if r["kernel"] == name]
    top = mine[0]  # the heaviest shape of the decode comes first
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches[name],
                # the worst over every shape; each shape's limit is on its
                # own `kernel` line
                max_abs_err=max(r["max_abs_err"] for r in mine),
                shape=top["shape"], ms=top["ms"],
                plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"])


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
    rows = check_attention(gen) + check_splat(gen)
    dec = decode(gen)
    reference_check()

    kernels = [
        dict(summary(rows, dec["launches"], "attention",
                     "diffcodec_tpu_torch/csrc/attention.cu",
                     "diffcodec_tpu/ops/attention.py:94"),
             # the same function's other TPU kernel (stock Pallas flash)
             also_replaces="diffcodec_tpu/models/layers.py:195"),
        summary(rows, dec["launches"], "splat_sum",
                "diffcodec_tpu_torch/csrc/splat.cu",
                "diffcodec_tpu/ops/softsplat_pallas.py:112"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
