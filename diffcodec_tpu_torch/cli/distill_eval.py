"""Quality gate for a distilled student: the K-step student against the
30-step CFG teacher.

Counterpart: `scripts/distill_eval.py` (the same options, with
`--device`): the same seeded conditioning and initial latents decoded
by the teacher (`DualFlowPipeline`, `--steps` UniPC steps, CFG 3.5,
ControlNet scale 1.35, FreeU) and by the student (`DistilledPipeline`, K
consistency steps, no CFG) at each K of `--k_values`, recording the pixel
PSNR between the two (images mapped to [0, 1]) and the largest pixel
difference, written as JSON to `--out`:

  python -m diffcodec_tpu_torch.cli.distill_eval \\
      --distilled_checkpoint runs/distill --sd_checkpoint_dir SD15 \\
      --controlnet_checkpoint CN.safetensors --out distill_eval.json

Without `--distilled_checkpoint` the student is the teacher's own weights
(the warm start, an undistilled student): the numbers then bound the
K-step sampler's mechanical gap.  Seeded random weights stand in for a
missing `--sd_checkpoint_dir`.
"""

from __future__ import annotations

import argparse
import json
import math
import os

# the conditioning's, the latents' and the student's re-noise draws: fixed,
# as the JAX script's keys
SEED = 0


def psnr01(a, b) -> float:
    """PSNR in dB of images in [-1, 1], mapped to [0, 1]."""
    mse = float(((a.float() - b.float()) ** 2).mean()) / 4.0
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--distilled_checkpoint", default="",
                    help="output dir of a cli.train_distill run (its EMA "
                         "weights); empty = the undistilled warm start")
    ap.add_argument("--sd_checkpoint_dir", default="")
    ap.add_argument("--controlnet_checkpoint", default="")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--steps", type=int, default=30,
                    help="teacher UniPC steps")
    ap.add_argument("--k_values", default="1,2,4,8")
    ap.add_argument("--small", action="store_true",
                    help="tiny models at 128 px (harness smoke)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="distill_eval.json")
    args = ap.parse_args(argv)

    import torch

    from diffcodec_tpu_torch.cli.run_codec import build_pipeline
    from diffcodec_tpu_torch.config import DistillConfig, SamplerConfig
    from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
    from diffcodec_tpu_torch.train.checkpoint import restore_checkpoint
    from diffcodec_tpu_torch.train.distill import load_student

    device = args.device
    B, H = args.batch, (128 if args.small else args.height)
    # the teacher's operating point; no prompt: the conditioning is seeded
    pipe, _ = build_pipeline(
        args.small, SamplerConfig(num_inference_steps=args.steps,
                                  guidance_scale=3.5,
                                  controlnet_conditioning_scale=1.35),
        device, args.sd_checkpoint_dir, args.controlnet_checkpoint)
    dtype = pipe.unet.dtype
    D = pipe.unet.cfg.cross_attention_dim

    gen = torch.Generator(device=device).manual_seed(SEED)
    text = (torch.randn((B, 77, D), generator=gen, device=device)
            * 0.02).to(dtype)
    uncond = torch.zeros_like(text)
    cond = torch.rand((B, H, H, 6), generator=gen, device=device).to(dtype)
    flow = (torch.randn((B, H, H, 4), generator=gen, device=device)
            * 4.0).to(dtype)
    latents = torch.randn((B, H // 8, H // 8, 4), generator=gen,
                          device=device)
    ref = pipe.sample(latents, text, uncond, cond, flow).float()

    student_step = 0
    if args.distilled_checkpoint:
        saved, student_step = restore_checkpoint(args.distilled_checkpoint)
        if saved is None:
            raise SystemExit(f"no checkpoints in "
                             f"{args.distilled_checkpoint}")
        load_student(pipe.unet, pipe.controlnet, saved["ema_params"])

    results = {"student_checkpoint_step": int(student_step),
               "teacher_steps": args.steps, "height": H, "batch": B,
               "distilled": bool(args.distilled_checkpoint), "per_k": {}}
    for K in [int(k) for k in args.k_values.split(",")]:
        dpipe = DistilledPipeline.from_pipeline(
            pipe, DistillConfig(num_student_steps=K))
        out = dpipe.sample(latents, text, cond, flow, generator=torch.
                           Generator(device=device).manual_seed(SEED))
        rec = {"psnr_vs_teacher_db": round(psnr01(out, ref), 3),
               "max_abs_pixel_delta": round(float((out.float() - ref)
                                                  .abs().max()), 4)}
        results["per_k"][f"K{K}"] = rec
        print(f"K={K}: {rec}", flush=True)

    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
