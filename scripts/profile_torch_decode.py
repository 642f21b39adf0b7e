#!/usr/bin/env python3
"""Where the PyTorch port's decode spends its time on the card.

    python3 scripts/profile_torch_decode.py [--steps N] [--out PATH]

Builds the decode of `chip_smoke.py` through its `build_decode` (SD-1.5
full width, 7 frames at 512 x 512, CFG, FreeU, bf16, seeded random
weights), runs it once to warm up, then runs it again under
`torch.profiler` and reports, for the profiled decode: its wall time, the device time summed over kernels (one stream, so
the sum is the busy time) and the idle share, and the device time by kernel
group (attention kernel, splat kernel, convolutions, matrix products,
normalisation, elementwise, other) and by kernel name.  Needs one CUDA
device.  The full result (top kernels included) goes to --out, by
default chiprun_out/profile_torch_decode.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (FRAMES, RES, STEPS, build_decode,  # noqa: E402
                        run)

# substrings of CUDA kernel names -> group (first match wins)
GROUPS = [
    ("attention kernel", ("attention_fwd_kernel",)),
    ("splat kernel", ("splat_sum_kernel",)),
    ("conv3x3 kernel", ("conv3x3_kernel",)),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--out", default="chiprun_out/profile_torch_decode.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_decode: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    pipe, x = build_decode(torch.Generator(device="cuda").manual_seed(0),
                           args.steps)
    run(pipe, x)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(pipe, x)
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
        device=smi, steps=args.steps, frames=FRAMES, res=RES,
        wall_s=wall_s, device_busy_s=busy_s,
        idle_share=max(0.0, 1.0 - busy_s / wall_s),
        launches=sum(v[0] for v in kernels.values()),
        groups={g: dict(launches=n, seconds=s, share_of_busy=s / busy_s)
                for g, (n, s) in sorted(groups.items(),
                                        key=lambda kv: -kv[1][1])},
        top_kernels=[dict(name=name[:120], launches=n, seconds=s)
                     for name, (n, s) in top])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in
                      ("device", "wall_s", "device_busy_s", "idle_share",
                       "launches", "groups")}), flush=True)
    for row in result["top_kernels"][:15]:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
