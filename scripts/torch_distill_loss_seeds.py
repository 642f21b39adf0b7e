#!/usr/bin/env python3
"""Is the port's bf16 distillation loss biased on the card, or is its
distance from the fp32 loss chance?

    python3 scripts/torch_distill_loss_seeds.py [--seeds N] [--res R]
                                                [--out PATH]

For each of N seeds, `chip_smoke.distill_fulldepth`'s inputs drawn anew
(seed 0 is the phase's own: SD-1.5 whole, a teacher and a student seeded
apart, batch 2 at 128 px, DistillConfig's defaults), the loss of one
distillation step (its forward: the CFG teacher, the student's and the
target's consistency functions) on the CPU in fp32 and in bf16 through
the plain versions and on the card in bf16 through the kernels, with its
terms (`chip_smoke.distill_loss_terms`).  The loss is the terms' mean, so
a bf16 run's distance from the fp32 loss is the mean of its terms'
errors: per seed, each bf16 run's signed distance in standard errors of
that mean (the sd of its own terms' errors over sqrt(N)), in standard
errors of the CPU's bf16 (the scale `chip_smoke.mean_limit` holds the
phase's loss to, at MEAN_SIGMAS x e_scale of them) and relative to the
loss; then over the seeds the mean and the rms of each.  Rounding that
cancels by chance reads a mean near 0 and an rms near 1 in the first
unit; a bias reads a mean away from 0.  Needs one CUDA device; the full
result goes to --out, by default chiprun_out/distill_loss_seeds.json.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from diffcodec_tpu_torch import _kernels  # noqa: E402


def loss_terms(models: dict, x: dict, device, dtype) -> tuple:
    """(loss, terms on the CPU) of one distillation step's forward on
    `device` in `dtype`, from copies of the fp32 teacher `models` with the
    student's and the EMA target's weights models['student']."""
    copies = [copy.deepcopy(models[k]).to(device)
              for k in ("unet", "controlnet", "vae")]
    d, state = cs.make_distiller(copies, cs.DISTILL_REF_TRAIN, dtype)
    del copies
    with torch.no_grad():
        for n, p in state.params.items():
            p.copy_(models["student"][n])
            state.ema_params[n].copy_(models["student"][n])
    d.load_params(state)
    batch = {k: v.to(device) if k in ("image", "flow") else v.to(device, dtype)
             for k, v in x["batch"].items()}
    with torch.no_grad():
        loss, terms = cs.distill_loss_terms(d, batch, {
            k: v.to(device) for k, v in x["draws"].items()})
    return loss.item(), terms


def one_seed(seed: int, res: int, batch: int) -> dict:
    models, x = cs.distill_fulldepth_inputs(res, batch, seed)
    runs = {name: loss_terms(models, x, dev, dtype) for name, dev, dtype in (
        ("cpu_fp32", "cpu", torch.float32),
        ("cpu_bf16", "cpu", torch.bfloat16),
        ("card", "cuda", torch.bfloat16))}
    del models
    torch.cuda.empty_cache()
    l32, t32 = runs["cpu_fp32"]
    t32 = t32.double().flatten()
    n = t32.numel()
    ref_se = float((runs["cpu_bf16"][1].double().flatten() - t32).std()
                   ) / math.sqrt(n)
    out = dict(seed=seed, terms=n, loss_fp32=l32, ref_se=ref_se,
               mean_limit=cs.mean_limit(runs["cpu_fp32"][1],
                                        runs["cpu_bf16"][1]))
    for name in ("cpu_bf16", "card"):
        loss, terms = runs[name]
        own_se = float((terms.double().flatten() - t32).std()) / math.sqrt(n)
        out[name] = dict(loss=loss, rel=(loss - l32) / abs(l32),
                         z_own=(loss - l32) / own_se,
                         z_ref=(loss - l32) / ref_se,
                         within=abs(loss - l32) <= out["mean_limit"])
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--res", type=int, default=cs.DISTILL_FULLDEPTH_RES)
    p.add_argument("--batch", type=int, default=cs.DISTILL_FULLDEPTH_BATCH)
    p.add_argument("--out", default="chiprun_out/distill_loss_seeds.json")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _kernels.lib()
    rows = []
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        rows.append(one_seed(seed, args.res, args.batch))
        rows[-1]["seconds"] = time.perf_counter() - t0
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for name in ("cpu_bf16", "card"):
        for key in ("z_own", "z_ref", "rel"):
            v = [r[name][key] for r in rows]
            summary[f"{name}_{key}"] = dict(
                mean=sum(v) / len(v),
                rms=math.sqrt(sum(a * a for a in v) / len(v)))
    result = dict(nvidia_smi=smi, res=args.res, batch=args.batch,
                  mean_sigmas=cs.MEAN_SIGMAS, rule=cs.FULLWIDTH_RULE,
                  seeds=rows, summary=summary)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(dict(nvidia_smi=smi, summary=summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
