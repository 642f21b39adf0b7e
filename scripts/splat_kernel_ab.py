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
every edit to the current source), one nvcc each, all started together; an
ablated build that fails is reported and left out.
Times each library's `dc_splat_sum` alone (`chip_smoke.time_ms`, CUDA
events, median of per-call times, into a buffer zeroed once, as wide as the
library's `dc_splat_row` where it has one) at every shape of
`chip_smoke.SPLAT_SHAPES` at B = 14 (a decode's splats) and 16 (a training
step's), at the residual shapes (`chip_smoke.RESIDUE_SPLAT_SHAPES` at B = 8
and 16, the DDPM's 256 px at B = 16 and 32), under three kinds of flow
(`chip_smoke.splat_inputs`): `wide` (3 N(0, 1) pixels, as
`chip_smoke.check_splat`), `local` (0.5 N(0, 1), as the pyramid's flows are
at 64 px and below) and `smooth` (`chip_smoke.smooth_flow`, as RAFT's), each
with a NaN, an off-frame and a -1e9 row, in the order old, new, new, old,
then each ablated build.  Every output is checked against
`splat_sum_reference` (atol and rtol 1e-5, as `chip_smoke.py` checks the
splat); rows carry `chip_smoke.splat_bounds`: the bound on bytes and
operations, and `l2_bound_ms`, the time one L2 reduction a corner would
take at the rate measured at C = 161.  First it reports registers and
spills (`nvcc -Xptxas -v`), the reduction instructions in the SASS
(`cuobjdump -sass`) of this tree's and OLD_CU's kernels, and whether each
kernel both define compiles to the same SASS.  Needs one CUDA device and
nvcc; writes every row to
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
    # C >= 16: one scalar reduction a channel and corner, the first
    # design's operations
    "scalar": ([("constexpr bool kV4 = true;",
                 "constexpr bool kV4 = false;")], True),
    # C >= 16: 16 lanes a pixel below 512 channels (this design's first
    # form)
    "lanes_16": ([("    const int lanes = C < kSmallC ? 8 : 32;",
                   "    const int lanes = C < kSmallC ? 8 : C < 512 ? 16 : "
                   "32;")], True),
    # C >= 16: the source values not read (each v4 adds the corner
    # weight): what the reads of vals through L1 cost
    "no_loads": ([("      red_add_v4(dst + c, src[c] * wq, src[c + 1] * wq, "
                   "src[c + 2] * wq,\n"
                   "                 src[c + 3] * wq);",
                   "      red_add_v4(dst + c, wq, wq, wq, wq);")], False),
    # C = 3, 4: splat_rows_kernel at every size (no tiles)
    "no_tiles": ([("constexpr bool kTiles = true;",
                   "constexpr bool kTiles = false;")], True),
    # the rows kernel: one scalar reduction a channel and corner
    "small_scalar": ([("constexpr bool kSmallV4 = true;",
                       "constexpr bool kSmallV4 = false;")], True),
    # the rows kernel: each lane sends its own pixel's four corners
    "small_no_pairs": ([("constexpr bool kPairs = true;",
                         "constexpr bool kPairs = false;")], True),
    # the rows kernel: every corner its own reduction, shared ones too
    "small_no_merge": ([("constexpr bool kMerge = true;",
                         "constexpr bool kMerge = false;")], True),
    # C = 3: rows of 3 floats (12-byte rows: a v2 and a scalar reduction
    # a corner)
    "small_unpadded": ([("constexpr bool kPad = true;",
                         "constexpr bool kPad = false;")], True),
}
FLOWS = ("wide", "local", "smooth")


def shapes() -> list:
    """[(B, R, C)]: the decode's and the training step's, and the residual
    stage's."""
    out = [(B, R, C) for B in (cs.BATCH, 2 * cs.TRAIN_BATCH)
           for R, C in cs.SPLAT_SHAPES]
    out += [(B, R, C) for B in (cs.TRAIN_BATCH, 2 * cs.TRAIN_BATCH)
            for R, C in cs.RESIDUE_SPLAT_SHAPES]
    out += [(B, cs.DDPM_RES, C) for B in (cs.DDPM_BATCH, 2 * cs.DDPM_BATCH)
            for _, C in cs.RESIDUE_SPLAT_SHAPES]
    return out


def load(path):
    lib = ctypes.CDLL(path)
    lib.dc_splat_sum.argtypes = _kernels._SIGNATURES["dc_splat_sum"]
    lib.dc_splat_sum.restype = ctypes.c_int
    if hasattr(lib, "dc_splat_row"):
        lib.dc_splat_row.argtypes = _kernels._SIGNATURES["dc_splat_row"]
        lib.dc_splat_row.restype = ctypes.c_int
    return lib


def row_width(lib, C: int) -> int:
    """The output's row width the library adds into (C before it padded
    rows)."""
    return lib.dc_splat_row(C) if hasattr(lib, "dc_splat_row") else C


def sass(old_cu, new_cu, tmp) -> dict:
    """ptxas's registers and spills of both sources' kernels, the
    reduction opcodes in each one's SASS, and whether each kernel both
    define compiles to the same SASS (the names without the digest of
    their file that the anonymous namespace carries)."""
    out, funcs = {}, {}
    for label, src in (("new", new_cu), ("old", old_cu)):
        d = os.path.join(tmp, f"sass_{label}")
        os.makedirs(d)
        ptxas = sass_report(src, d, prefix="splat")
        cubin = os.path.join(d, os.path.basename(src).replace(".cu",
                                                              ".cubin"))
        funcs[label] = {re.sub(r"_cu_[0-9a-f]+", "_cu", n):
                        "\n".join(" ".join(line.split())
                                  for line in text.splitlines())
                        for n, text in sass_functions(cubin).items()}
        out[label] = dict(ptxas=ptxas, reductions={
            name: dict(collections.Counter(
                re.findall(r"\b((?:RED|ATOM)[\w.]*)", text)))
            for name, text in funcs[label].items()})
    out["same_sass"] = {n: funcs["new"][n] == funcs["old"][n]
                        for n in sorted(funcs["new"]) if n in funcs["old"]}
    out["sass_diff"] = {
        n: [(a, b) for a, b in zip(funcs["new"][n].splitlines(),
                                   funcs["old"][n].splitlines())
            if a != b][:8] for n, same in out["same_sass"].items()
        if not same}
    return out


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
        builds = ABLATIONS if args.ablate else {}
        for name, (edits, _) in builds.items():
            procs[name] = start_edited_build(
                edited(src, edits, f"splat.cu, {name}"), tmp, name)
        build = sass(args.old_cu, new_cu, tmp)
        print(json.dumps(dict(build=build)), flush=True)
        libs, failed = {"new": _kernels.lib()}, {}
        for name, (proc, path) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                if name == "old":
                    raise RuntimeError(f"nvcc failed for {name}:\n{err}")
                failed[name] = err[-2000:]
                print(json.dumps(dict(build_failed=name, nvcc=err[-2000:])),
                      flush=True)
                continue
            libs[name] = load(path)
        gen = torch.Generator(device="cuda").manual_seed(0)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        for B, R, C in shapes():
            for kind in FLOWS:
                vals, flow = cs.splat_inputs(gen, B, R, C, kind)
                want = splat_sum_reference(vals, flow)
                outs = {name: torch.zeros(B, R, R, row_width(lib, C),
                                          device="cuda")
                        for name, lib in libs.items()}

                def call(name):
                    _kernels.check(libs[name].dc_splat_sum(
                        vals.data_ptr(), flow.data_ptr(),
                        outs[name].data_ptr(), B, R, R, C, stream()),
                        "dc_splat_sum")
                errs, ms = {}, collections.defaultdict(list)
                for name in libs:
                    if not builds.get(name, (None, True))[1]:
                        continue
                    outs[name].zero_()
                    call(name)
                    errs[name] = cs.compare(
                        f"{name} {[B, R, R, C]} {kind}",
                        outs[name][..., :C], want, **cs.SPLAT_TOL)
                order = ["old", "new", "new", "old"] + [
                    n for n in libs if n not in ("old", "new")]
                for name in order:
                    ms[name].append(cs.time_ms(lambda n=name: call(n),
                                               args.reps))
                row = dict(shape=[B, R, R, C], flow=kind,
                           old_ms=ms.pop("old"), new_ms=ms.pop("new"),
                           ablations=dict(ms), max_abs_err=errs,
                           **cs.splat_bounds(flow, C))
                print(json.dumps(row), flush=True)
                rows.append(row)
                del vals, flow, want, outs
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, old=args.old_cu, build=build,
                       ablations={n: e for n, (e, _) in builds.items()},
                       build_failed=failed, rows=rows), f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
