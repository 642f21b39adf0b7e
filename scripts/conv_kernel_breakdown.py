#!/usr/bin/env python3
"""Where the 3x3 conv kernel's time goes on the card.

    python3 scripts/conv_kernel_breakdown.py [--out PATH]

Builds `diffcodec_tpu_torch/csrc/conv3x3.cu` six times, with the main
loop's chunk copies, its activation (the GroupNorm-affine + SiLU prologue)
and its products switched off in the combinations below (the source is
edited in memory; the build fails loudly if the loop no longer reads as
expected), and times each build's `dc_conv3x3` (prologue 2) at the fused
decoder's heaviest shapes with CUDA events (median of per-call times).  A
build with a part switched off computes garbage: only its time is read.
Times that add up across parts mean the parts do not overlap.  Needs one
CUDA device and nvcc; the result also goes to --out, by default
chiprun_out/conv_kernel_breakdown.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import time_ms  # noqa: E402
from diffcodec_tpu_torch import _kernels  # noqa: E402
from diffcodec_tpu_torch.ops import conv  # noqa: E402

# part -> (a line of the main loop, the line that switches it off)
PARTS = {
    "copies": (
        "    if (j + 2 < n_chunks) copy_chunk((j + 2) * kBK, stage(j + 2));",
        "    if (false) copy_chunk((j + 2) * kBK, stage(j + 2));"),
    "activation": (
        "    if (j + 1 < n_chunks) activate((j + 1) * kBK, stage(j + 1));",
        "    if (false) activate((j + 1) * kBK, stage(j + 1));"),
    "products": ("    for (int tap = 0; tap < TAPS; ++tap) {",
                 "    for (int tap = 0; tap < 0; ++tap) {"),
}
VARIANTS = [(), ("activation",), ("copies",), ("copies", "activation"),
            ("products",), ("products", "activation")]
SHAPES = [(7, 512, 512, 256, 128), (7, 256, 256, 256, 256),
          (7, 512, 512, 128, 3)]


def build(off, src, out_dir):
    """Start nvcc on the source with `off` switched off: (process, library
    path)."""
    for part in off:
        line, repl = PARTS[part]
        if src.count(line) != 1:
            raise RuntimeError(f"conv3x3.cu no longer has the line {line!r}")
        src = src.replace(line, repl)
    name = "_".join(off) or "all"
    cu = os.path.join(out_dir, f"conv_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"conv_{name}.so")
    return subprocess.Popen([_kernels.LIBRARY._nvcc(), *_kernels.NVCC_FLAGS,
                             "-o", lib, cu]), lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/conv_kernel_breakdown.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_kernel_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with open(os.path.join(_kernels.CSRC_DIR, "conv3x3.cu")) as f:
        src = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        builds = [(off, *build(off, src, tmp)) for off in VARIANTS]
        libs = []
        for off, proc, path in builds:  # one nvcc per variant, in parallel
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for {off}")
            lib = ctypes.CDLL(path)
            lib.dc_conv3x3.argtypes = _kernels._SIGNATURES["dc_conv3x3"]
            libs.append((off, lib))
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = []
        for B, H, W, C, O in SHAPES:
            x = torch.randn(B, H, W, C, device="cuda", generator=gen)
            x = x.bfloat16()
            sc = torch.rand(B, C, device="cuda", generator=gen) + 0.5
            sh = torch.randn(B, C, device="cuda", generator=gen)
            w = (torch.randn(O, C, 3, 3, device="cuda", generator=gen)
                 * (9 * C) ** -0.5).bfloat16()
            taps = conv.chunk_taps(conv.conv3x3_taps(w)[None])
            bias = torch.zeros(O, device="cuda")
            out = torch.empty(B, H, W, O, device="cuda", dtype=torch.bfloat16)
            for off, lib in libs:
                def call(lib=lib):
                    code = lib.dc_conv3x3(
                        x.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                        taps.data_ptr(), bias.data_ptr(), None,
                        out.data_ptr(), B, H, W, C, O, 2,
                        torch.cuda.current_stream().cuda_stream)
                    _kernels.check(code, "dc_conv3x3")
                row = dict(shape=[B, H, W, C, O],
                           off=list(off), ms=time_ms(call, 10))
                print(json.dumps(row), flush=True)
                rows.append(row)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, rows=rows), f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
