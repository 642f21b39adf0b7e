#!/usr/bin/env python3
"""Where the PyTorch port's decode (or a training step) spends its time
on the card.

    python3 scripts/profile_torch_decode.py [--point P] [--steps N]
                                            [--out PATH]

Builds one of `chip_smoke.py`'s points with its `build_*` functions
(SD-1.5 full width, seeded random weights): `decode` (default;
`build_decode`, 7 frames at 512 x 512, 30 UniPC steps with CFG and
FreeU, bf16),
`tiled_exact` (`build_tiled_exact`: one 1080p frame in 15 tiles, 7 a call,
the same exact pipeline with the fused VAE), `codec` (`build_codec`: a
synthetic 1080p GOP-8 through the sparse mode, 14 CMP calls and the
distilled K = 4 pipeline over 105 tiles, 15 a call), `train_residual`
(`build_train_residual`: one iteration of the residual ControlNet's
training from captions, batch 8 at 512 px, bf16) or `residual_ddpm`
(`build_residual_ddpm`: one step of the residual pixel DDPM, batch 16 at
256 px, fp32); runs it twice to warm up, then again under
`torch.profiler`, and reports for the profiled run: its wall time,
the device time summed over kernels (one stream, so the sum is the busy
time) and the idle share, and the device time by kernel group (attention
kernels, splat kernel, conv kernels, convolutions, matrix products,
normalisation, elementwise, other) and by kernel name.  Needs one CUDA
device.  The full result (top kernels included) goes to --out, by default
chiprun_out/profile_torch_<point>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import dataclasses
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (DDPM_BATCH, DDPM_RES, FRAMES,  # noqa: E402
                        RES, STEPS, TRAIN_BATCH, build_cmp, build_codec,
                        build_decode, build_residual_ddpm,
                        build_tiled_exact, build_train_residual,
                        fused_vae_of, run)

# substrings of CUDA kernel names -> group (first match wins)
GROUPS = [
    ("attention kernels", ("attention_fwd_kernel", "attention_bwd_kernel")),
    ("splat kernel", ("splat_sum_kernel", "splat_small_kernel")),
    ("conv3x3 kernels", ("conv3x3_hopper", "conv3x3_head")),
    ("convolution", ("conv", "implicit", "xmma_fprop", "cudnn", "sm90_xmma",
                     "nchwToNhwc", "nhwcToNchw")),
    ("matrix product", ("gemm", "cutlass", "cublas", "nvjet", "sm90_")),
    ("normalisation", ("norm", "welford", "reduce", "var_mean")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy",
                     "cat", "silu", "gelu", "fill")),
]


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def build_point(point: str, steps: int, gen, workdir: str):
    """(the call to profile, its frames and resolution)."""
    if point == "train_residual":
        return (build_train_residual(gen).iteration,
                dict(frames=TRAIN_BATCH, res=RES))
    if point == "residual_ddpm":
        return build_residual_ddpm(gen)[3], dict(frames=DDPM_BATCH,
                                                 res=DDPM_RES)
    pipe, x = build_decode(gen, steps)
    if point == "decode":
        return (lambda: run(pipe, x)), dict(frames=FRAMES, res=RES)
    fused = dataclasses.replace(pipe, vae=fused_vae_of(pipe.vae))
    if point == "tiled_exact":
        return build_tiled_exact(fused, gen)[0], dict(frames=1,
                                                      res=[1080, 1920])
    return (build_codec(fused, build_cmp()[1], gen, workdir).go,
            dict(frames=9, res=[1080, 1920]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--point", choices=("decode", "tiled_exact", "codec",
                                        "train_residual", "residual_ddpm"),
                    default="decode")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA device", file=sys.stderr)
        return 1
    out_path = args.out or f"chiprun_out/profile_torch_{args.point}.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as workdir:
        go, shape = build_point(args.point, args.steps, gen, workdir)
        go()
        go()
        torch.cuda.synchronize()

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t

    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e6
    busy_s = sum(v[1] for v in kernels.values())
    groups = {}
    for name, (n, s) in kernels.items():
        g = groups.setdefault(group_of(name), [0, 0.0])
        g[0] += n
        g[1] += s
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:25]
    result = dict(
        device=smi, point=args.point, steps=args.steps, **shape,
        wall_s=wall_s, device_busy_s=busy_s,
        idle_share=max(0.0, 1.0 - busy_s / wall_s),
        launches=sum(v[0] for v in kernels.values()),
        groups={g: dict(launches=n, seconds=s, share_of_busy=s / busy_s)
                for g, (n, s) in sorted(groups.items(),
                                        key=lambda kv: -kv[1][1])},
        top_kernels=[dict(name=name[:120], launches=n, seconds=s)
                     for name, (n, s) in top])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in
                      ("device", "point", "wall_s", "device_busy_s",
                       "idle_share",
                       "launches", "groups")}), flush=True)
    for row in result["top_kernels"][:15]:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
