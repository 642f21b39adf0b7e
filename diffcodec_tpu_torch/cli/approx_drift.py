"""Quantify the output drift of the opt-in approximate decode modes.

Counterpart: `scripts/approx_drift.py` (its `MODES`, operating point and
JSON keys; `--small` and `--batch` in place of its `BENCH_SMALL` and
`BENCH_BATCH` environment variables, and `--device`).  The reference
pipeline recomputes the ControlNet and the full UNet at every step
(its `pipeline.py:308-385`); the caching knobs
(`SamplerConfig.controlnet_interval` / `unet_encoder_interval`) trade
exactness for speed.  This bounds that approximation: the 512 px, 30-step
operating point (CFG 3.5, ControlNet scale 1.35, FreeU, bf16) decoded from
identical initial latents, weights and conditioning in every mode, and
exact-against-cached deltas recorded:

  * latent MSE and relative RMS error of the final pre-VAE latents
  * pixel PSNR (outputs mapped to [0, 1]) and the largest pixel delta

Every weight is redrawn ~ N(0, 0.02^2) from a fixed seed: PyTorch's
initialisation, like flax's, zeroes the ControlNet's zero-convs, which
makes the injected residuals 0 at every timestep, so caching a constant
would be a no-op and the drift would read as bf16 noise alone.  The
numbers bound the mechanical divergence of the cached loop, not RD cost on
real content.

  python -m diffcodec_tpu_torch.cli.approx_drift --out drift.json \\
      [--small] [--batch 7] [--device cuda]

Writes `--out` (required; the JAX package's committed record
`artifacts/approx_drift.json` is not touched) and prints each mode's
seconds, frames/s and ControlNet and UNet-encoder calls to stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

MODES = [("exact", 1, 1), ("cnint2", 2, 1), ("cnint3", 3, 1),
         ("encint2", 1, 2), ("encint3", 1, 3), ("cnint2_encint2", 2, 2),
         ("cnint3_encint3", 3, 3)]
WEIGHT_STD = 0.02
WEIGHT_SEED, INPUT_SEED = 0, 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="the JSON record")
    ap.add_argument("--small", action="store_true",
                    help="tiny UNet and ControlNet (the full VAE) at 128 px "
                         "and 5 steps")
    ap.add_argument("--batch", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(small: bool, device, dtype=None):
    """The pipeline (SD-1.5 width, or tiny UNet and ControlNet with the
    full VAE) on `device` in `dtype` (default bf16), every weight redrawn
    ~ N(0, WEIGHT_STD^2) from a generator seeded WEIGHT_SEED."""
    import torch

    from diffcodec_tpu_torch.config import (ControlNetConfig, UNetConfig,
                                            VAEConfig)
    from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline

    unet_cfg = UNetConfig.tiny() if small else UNetConfig()
    cn_cfg = (ControlNetConfig.tiny() if small
              else ControlNetConfig(unet=unet_cfg))
    pipe = DualFlowPipeline.create(unet_cfg, cn_cfg, VAEConfig(),
                                   dtype=dtype or torch.bfloat16,
                                   device=device)
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    with torch.no_grad():
        for m in (pipe.controlnet, pipe.unet, pipe.vae):
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=gen, device=device)
                        * WEIGHT_STD)
    return pipe


def make_inputs(pipe, batch: int, res: int):
    """The seeded conditioning and initial latents of every mode: text
    embeddings ~ 0.02 N(0, 1) and zero uncond embeddings (77 tokens),
    anchors uniform in [0, 1], flow ~ 4 N(0, 1) pixels, fp32 latents."""
    import torch

    p = next(pipe.unet.parameters())
    device, dtype = p.device, p.dtype
    gen = torch.Generator(device=device).manual_seed(INPUT_SEED)
    D = pipe.unet.cfg.cross_attention_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    text = (randn(batch, 77, D) * 0.02).to(dtype)
    return dict(text=text, uncond=torch.zeros_like(text),
                cond=torch.rand((batch, res, res, 6), generator=gen,
                                device=device).to(dtype),
                flow=(randn(batch, res, res, 4) * 4.0).to(dtype),
                latents=randn(batch, res // 8, res // 8, 4))


def run_mode(pipe, inputs, steps: int, cn_interval: int, enc_interval: int):
    """(final latents fp32, images in [-1, 1] fp32, calls): one decode at
    the operating point with the two intervals, and the ControlNet
    (`backbone`) and UNet-encoder (`encode`) calls it made."""
    import dataclasses

    import torch

    from diffcodec_tpu_torch.config import SamplerConfig
    from diffcodec_tpu_torch.models.vae import decode_from_latents

    mode = dataclasses.replace(pipe, sampler=SamplerConfig(
        num_inference_steps=steps, guidance_scale=3.5,
        controlnet_conditioning_scale=1.35, controlnet_interval=cn_interval,
        unet_encoder_interval=enc_interval, freeu=True))
    calls = {"controlnet": 0, "unet_encoder": 0}

    def counting(module, method, key):
        inner = getattr(module, method)

        def wrapper(*a, **kw):
            calls[key] += 1
            return inner(*a, **kw)
        setattr(module, method, wrapper)
        return lambda: delattr(module, method)

    undo = [counting(pipe.controlnet, "backbone", "controlnet"),
            counting(pipe.unet, "encode", "unet_encoder")]
    try:
        with torch.no_grad():
            final = mode.denoise(inputs["latents"], inputs["text"],
                                 inputs["uncond"], inputs["cond"],
                                 inputs["flow"])
            images = decode_from_latents(pipe.vae, final).clamp(-1.0, 1.0)
    finally:
        for u in undo:
            u()
    return final.float(), images.float(), calls


def drift(ref_lat, ref_img, lat, img) -> dict:
    """The JAX script's record of one cached mode against exact."""
    lmse = float(((lat - ref_lat) ** 2).mean())
    lrel = math.sqrt(lmse / float((ref_lat ** 2).mean()))
    d = (img - ref_img) / 2.0
    pmse = float((d ** 2).mean())
    psnr = 10.0 * math.log10(1.0 / max(pmse, 1e-12))
    return {"latent_mse": round(lmse, 6),
            "latent_rel_rms": round(lrel, 5),
            "pixel_mse_01": round(pmse, 8),
            "pixel_psnr_db": round(psnr, 2),
            "pixel_max_abs_01": round(float(d.abs().max()), 4)}


def main(argv=None):
    """Returns (the JSON record, {mode: seconds, frames_per_s, calls})."""
    args = parse_args(argv)
    import torch

    H = 128 if args.small else 512
    steps = 5 if args.small else 30
    B = args.batch
    pipe = build(args.small, args.device)
    inputs = make_inputs(pipe, B, H)

    results, runs = {}, {}
    ref_lat = ref_img = None
    for suffix, ci, ei in MODES:
        if args.device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat, img, calls = run_mode(pipe, inputs, steps, ci, ei)
        if args.device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[suffix] = {"seconds": dt, "frames_per_s": B / dt,
                        "calls": calls}
        if suffix == "exact":
            ref_lat, ref_img = lat, img
            results[suffix] = {"latent_mse": 0.0, "pixel_psnr_db": None,
                               "note": "reference output"}
        else:
            results[suffix] = drift(ref_lat, ref_img, lat, img)
        print(f"{suffix}: {results[suffix]} ({dt:.2f}s, {B / dt:.3f} "
              f"frames/s, {calls})", file=sys.stderr)

    out = {
        "operating_point": {"resolution": H, "steps": steps, "batch": B,
                            "guidance_scale": 3.5, "freeu": True,
                            "dtype": "bfloat16",
                            "weights": "fixed-seed random init"},
        "metric_defs": {
            "latent_mse": "mean squared error on final pre-VAE latents",
            "latent_rel_rms": "RMS latent error / RMS exact latent",
            "pixel_psnr_db": "PSNR of decoded output vs exact, [0,1] range",
        },
        "interpretation": (
            "a mechanical bound, not an RD statement: the drift of each "
            "cached mode from the exact decode of the same seeded random "
            "weights (std 0.02) and inputs, on "
            + str(args.device) + " with the port's kernels.  Residual and "
            "encoder smoothness across timesteps depends on the weights, so "
            "rerun this with pretrained weights (cli/approx_drift.py, fixed "
            "seeds)."),
        "modes": results,
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out["modes"], indent=2))
    print("wrote", args.out)
    return out, runs


if __name__ == "__main__":
    main()
