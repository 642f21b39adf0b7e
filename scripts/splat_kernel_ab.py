#!/usr/bin/env python3
"""The splat kernel of this tree against an older `splat.cu`, in turns, and
what its design choices are worth.

    python3 scripts/splat_kernel_ab.py OLD_CU [--ablate] [--reps 20]
        [--out PATH]

Builds OLD_CU (for example a parent commit's
`diffcodec_tpu_torch/csrc/splat.cu`, written out with `git show`) into a
library of its own beside this tree's library, and with --ablate this
tree's `splat.cu` once more for each entry of ABLATIONS (the source edited
in memory, as `conv_kernel_breakdown.py` edits the conv; a CPU test applies
every edit to the current source), one nvcc each, all started together.
Times each library's `dc_splat_sum` alone (`chip_smoke.time_ms`, CUDA
events, median of per-call times, into a buffer zeroed once) at every
shape of `chip_smoke.SPLAT_SHAPES`, at B = 14 (a decode's splats) and 16 (a
training step's), with two kinds of flow: `chip_smoke.check_splat`'s (3
N(0, 1) pixels, with a NaN, an off-frame and a -1e9 row) and a local one
(0.5 N(0, 1) pixels, as the pyramid's flows are at 64 px and below), in the
order old, new, new, old, then each ablated build.  Every output is checked
against `splat_sum_reference` (atol and rtol 1e-5, as `chip_smoke.py`
checks the splat); rows carry the bound (`chip_smoke.check_splat`'s
formula).  First it reports registers and spills (`nvcc -Xptxas -v`) and
the reduction instructions in the SASS (`cuobjdump -sass`) of this tree's
and OLD_CU's kernel.  Needs one CUDA device and nvcc; writes every row to
--out (default chiprun_out/splat_kernel_ab.json) and prints the card's
name and power limit last.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import chip_smoke as cs  # noqa: E402
from conv_kernel_ab import sass_functions, sass_report  # noqa: E402
from conv_kernel_breakdown import edited, start_edited_build  # noqa: E402
from diffcodec_tpu_torch import _kernels  # noqa: E402
from diffcodec_tpu_torch.ops.softsplat import splat_sum_reference  # noqa: E402

# ablation -> ([(text of splat.cu, what replaces it)], whether the build
# still computes the splat: its output is checked where it does)
ABLATIONS = {
    # one scalar reduction a channel and corner, the first design's
    # operations
    "scalar": ([("constexpr bool kV4 = true;",
                 "constexpr bool kV4 = false;")], True),
    # 16 lanes a pixel below 512 channels (this design's first form)
    "lanes_16": ([("  const int lanes = C < kSmallC ? (C <= 4 ? 4 : 8) : 32;",
                   "  const int lanes = C < kSmallC ? (C <= 4 ? 4 : 8) : "
                   "C < 512 ? 16 : 32;")], True),
    # the source values not read (each v4 adds the corner weight): what the
    # reads of vals through L1 cost
    "no_loads": ([("      red_add_v4(dst + c, src[c] * wq, src[c + 1] * wq, "
                   "src[c + 2] * wq,\n"
                   "                 src[c + 3] * wq);",
                   "      red_add_v4(dst + c, wq, wq, wq, wq);")], False),
}
BATCHES = (cs.BATCH, 2 * cs.TRAIN_BATCH)
FLOWS = {"wide": 3.0, "local": 0.5}


def load(path):
    lib = ctypes.CDLL(path)
    lib.dc_splat_sum.argtypes = _kernels._SIGNATURES["dc_splat_sum"]
    lib.dc_splat_sum.restype = ctypes.c_int
    return lib


def reductions(src, out_dir):
    """{"ptxas": {kernel: {registers, stack, spills}}, "reductions":
    {kernel: {opcode: count}}} of `src`, from ptxas -v and the SASS of its
    cubin."""
    ptxas = sass_report(src, out_dir, prefix="splat")
    cubin = os.path.join(out_dir,
                         os.path.basename(src).replace(".cu", ".cubin"))
    ops = {name: dict(collections.Counter(
        re.findall(r"\b((?:RED|ATOM)[\w.]*)", text)))
        for name, text in sass_functions(cubin).items()}
    return dict(ptxas=ptxas, reductions=ops)


def inputs(gen, B, R, C, scale):
    vals = torch.randn(B, R, R, C, device="cuda", generator=gen)
    flow = torch.randn(B, R, R, 2, device="cuda", generator=gen) * scale
    flow[0, 1, :4, 0] = float("nan")        # dropped pixels
    flow[1, :, -1, 0] = R + 2.0             # lands out of frame
    flow[2, 0, :, 1] = -1e9
    return vals, flow


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_cu")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/splat_kernel_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("splat_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    new_cu = os.path.join(_kernels.CSRC_DIR, "splat.cu")
    with open(new_cu) as f:
        src = f.read()
    with open(args.old_cu) as f:
        old_src = f.read()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {"old": start_edited_build(old_src, tmp, "old")}
        if args.ablate:
            for name, (edits, _) in ABLATIONS.items():
                procs[name] = start_edited_build(
                    edited(src, edits, f"splat.cu, {name}"), tmp, name)
        build = {}
        for label, path in (("new", new_cu), ("old", args.old_cu)):
            d = os.path.join(tmp, f"sass_{label}")
            os.makedirs(d)
            build[label] = reductions(path, d)
            print(json.dumps(dict(build=label, **build[label])), flush=True)
        libs = {"new": _kernels.lib()}
        for name, (proc, path) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{err}")
            libs[name] = load(path)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        for B in BATCHES:
            for R, C in cs.SPLAT_SHAPES:
                for kind, scale in FLOWS.items():
                    vals, flow = inputs(gen, B, R, C, scale)
                    want = splat_sum_reference(vals, flow)
                    out = torch.zeros_like(vals)

                    def call(lib):
                        _kernels.check(lib.dc_splat_sum(
                            vals.data_ptr(), flow.data_ptr(), out.data_ptr(),
                            B, R, R, C, stream()), "dc_splat_sum")
                    errs, ms = {}, collections.defaultdict(list)
                    for name, lib in libs.items():
                        if not ABLATIONS.get(name, (None, True))[1]:
                            continue
                        out.zero_()
                        call(lib)
                        errs[name] = cs.compare(
                            f"{name} {[B, R, R, C]} {kind}", out, want,
                            **cs.SPLAT_TOL)
                    order = ["old", "new", "new", "old"] + [
                        n for n in libs if n not in ("old", "new")]
                    for name in order:
                        ms[name].append(cs.time_ms(
                            lambda lib=libs[name]: call(lib), args.reps))
                    n = B * R * R
                    b_ms, b_by = cs.bound(4 * 2 * n * C, 4 * n * (2 * C + 2),
                                          cs.PEAK_FP32_FLOPS)
                    row = dict(shape=[B, R, R, C], flow=kind,
                               old_ms=ms.pop("old"), new_ms=ms.pop("new"),
                               ablations=dict(ms), max_abs_err=errs,
                               bound_ms=b_ms, bound_by=b_by)
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                    del vals, flow, want, out
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, old=args.old_cu, build=build,
                       ablations={n: e for n, (e, _) in ABLATIONS.items()}
                       if args.ablate else {},
                       rows=rows), f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
