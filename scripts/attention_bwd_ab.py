#!/usr/bin/env python3
"""The attention backward of this tree against an older two-kernel one, in
turns.

    python3 scripts/attention_bwd_ab.py OLD_CU [--ablate] [--ablate-d 40]
        [--reps 10] [--out PATH]

OLD_CU is an `attention.cu` whose backward is the two mma.sync kernels
`dc_attention_bwd_dkv` and `dc_attention_bwd_dq` (written out with `git
show e32d270:diffcodec_tpu_torch/csrc/attention.cu`).  It is built into a
library of its own with this tree's nvcc flags, beside this tree's library,
and the two backwards are timed on the same inputs, like for like, at every
training shape `chip_smoke.py` checks (`ATTN_SHAPES` at batch 8) in the
order old, new, new, old, with `chip_smoke.time_ms` (CUDA events, median of
per-call times): old = what the older `attention_backward` ran (delta =
rowsum(dout * out) by torch, then the dK/dV and the dQ kernel), new = this
tree's one C call (the delta and zeroing pass, the kernel, the dQ cast),
each on output buffers allocated once.  Beside them: SDPA's backward, the
bound and max |new - old| of each gradient.

First it reports, for each kernel of this tree's `attention.cu` and of
OLD_CU, what `nvcc -Xptxas -v` says (registers, stack, spills) and how many
HGMMA (wgmma) instructions `cuobjdump -sass` finds in it.

With --ablate it also builds this tree's `attention.cu` with parts of the
backward kernel, or the passes around it, switched off (ABLATIONS: text
edits of the source in memory, as `conv_kernel_breakdown.py` makes them; a
CPU test applies each to the current source; the results are then wrong),
each with the one head width --ablate-d (default 40) instantiated, and
times each build against the whole one at the shapes of that width, to say
what bounds the kernel.

All nvcc builds start together.  Needs one CUDA device and nvcc; writes
every row to --out (default chiprun_out/attention_bwd_ab.json) and prints
the card's name and power limit last.
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
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from conv_kernel_ab import sass_report  # noqa: E402
from conv_kernel_breakdown import edited, start_edited_build  # noqa: E402
from diffcodec_tpu_torch import _kernels  # noqa: E402
from diffcodec_tpu_torch.ops.attention import attention_forward  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the older source's backward entry points
OLD_SIGNATURES = {
    "dc_attention_bwd_dkv": [_P] * 8 + [_I] * 4 + [_F, _P],
    "dc_attention_bwd_dq": [_P] * 7 + [_I] * 4 + [_F, _P],
}
NEW_SIGNATURES = {"dc_attention_bwd":
                  _kernels._SIGNATURES["dc_attention_bwd"]}
# part switched off -> [(text of attention.cu, what replaces it)]
ABLATIONS = {
    "no exponentials": [
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "  y = x;")],
    "no dQ reduction": [
        ("    if (tw == 0) {\n      const int rows = Lq - q0 < BQ",
         "    if (false) {\n      const int rows = Lq - q0 < BQ")],
    # neither the hand-over of dS^T nor the dQ product and its reduction
    "no dQ tile": [
        ("    if (wg != b && it >= 2) {", "    if (false) {"),
        ("    if (lane == 0) mbar_arrive(&empty[s]);  // stage s read by "
         "this warp\n",
         "    if (lane == 0) mbar_arrive(&empty[s]);  // stage s read by "
         "this warp\n    continue;\n")],
    "no products": [
        (call, "if (false) " + call) for call in (
            "wgmma_ss<BQ, 0, 0>(st,", "wgmma_ss<BQ, 0, 0>(dpt,",
            "wgmma_rs<D, 1>(dv_acc,", "wgmma_rs<D, 1>(dk_acc,",
            "wgmma_ss<D, 1, 1>(acc,", "wgmma_ss<BQ, 1, 1>(\n")],
    # the passes around the kernel, in the same C call
    "no delta pass": [("  attention_bwd_prep_kernel<D8><<<",
                       "  if (false) attention_bwd_prep_kernel<D8><<<")],
    "no dQ cast": [("  attention_bwd_cast_kernel<<<",
                    "  if (false) attention_bwd_cast_kernel<<<")],
}


def one_width(d):
    """The edit that instantiates the backward for head width `d` only
    (ptxas 12.9 crashed on some ablated builds, more of them at D = 80 and
    160); the other widths return cudaErrorNotSupported."""
    call = "    return launch_bwd<decltype(d8)::value>("
    return [(call, f"    if constexpr (8 * decltype(d8)::value != {d}) "
                   "return (int)cudaErrorNotSupported;\n"
                   f"    else{call[3:]}")]


def start_build(src, so):
    """An nvcc of `src` alone into the shared library `so`, started."""
    cmd = [_kernels.LIBRARY._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def load(proc, so, signatures):
    """The built library, with the argument types of `signatures`."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so}:\n{err}")
    lib = ctypes.CDLL(so)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def new_call(lib, q, k, v, out, dout, lse, scale):
    """This tree's backward (one C call of `lib`: delta and zeroing, the
    kernel, the dQ cast) on buffers allocated once; returns (call, (dq, dk,
    dv))."""
    BH, Lq, D = q.shape
    delta = torch.empty(BH, Lq, device="cuda")
    dq_acc = torch.empty(BH, Lq, D, device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _kernels.check(lib.dc_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, Lq, k.shape[1], D, float(scale), stream), "dc_attention_bwd")
    return call, (dq, dk, dv)


def old_call(lib, q, k, v, out, dout, lse, scale):
    """The older `attention_backward`: delta by torch, then its dK/dV and
    dQ kernels, on output buffers allocated once; returns (call, (dq, dk,
    dv))."""
    BH, Lq, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream
    args = (BH, Lq, k.shape[1], D, float(scale), stream)

    def call():
        delta = (dout.float() * out.float()).sum(-1)
        _kernels.check(lib.dc_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *args), "dc_attention_bwd_dkv")
        _kernels.check(lib.dc_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args),
            "dc_attention_bwd_dq")
    return call, (dq, dk, dv)


def inputs(gen, Lq, Lk, D):
    BH, scale = cs.TRAIN_BH, D ** -0.5
    q, k, v, dout = (torch.randn(BH, L, D, device="cuda", generator=gen)
                     .bfloat16() for L in (Lq, Lk, Lk, Lq))
    out, lse = attention_forward(q, k, v, scale, with_lse=True)
    return q, k, v, out, dout, lse, scale


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_cu")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--ablate-d", type=int, default=40)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/attention_bwd_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_bwd_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    src = os.path.join(_kernels.CSRC_DIR, "attention.cu")
    with open(src) as f:
        text = f.read()
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = dict(device=smi, old=args.old_cu, rows=[], ablations=[])
    with tempfile.TemporaryDirectory() as tmp:
        # every build at once: the old source and the ablated builds (this
        # tree's library builds meanwhile, or is already built)
        old_so = os.path.join(tmp, "old.so")
        old_proc = start_build(args.old_cu, old_so)
        builds = {}
        for i, (name, edits) in enumerate(
                ABLATIONS.items() if args.ablate else ()):
            edits = edits + one_width(args.ablate_d)
            builds[name] = start_edited_build(
                edited(text, edits, f"attention.cu, {name}"), tmp,
                f"ablate{i}")
        new = _kernels.lib()
        old = load(old_proc, old_so, OLD_SIGNATURES)
        ablated = {}
        for name, (proc, so) in builds.items():
            try:
                ablated[name] = load(proc, so, NEW_SIGNATURES)
            except RuntimeError as e:  # ptxas has crashed on some of them
                note = dict(ablation=name, build_failed=str(e)[-300:])
                print(json.dumps(note), flush=True)
                result["ablations"].append(note)
        kernel = "attention_[a-z_]*kernel"  # the kernels' names
        result["build"] = sass_report(src, tmp, prefix=kernel)
        result["old_build"] = sass_report(args.old_cu, tmp, prefix=kernel)
        for label in ("build", "old_build"):
            for name, info in result[label].items():
                print(json.dumps(dict(build=label, kernel=name, **info)),
                      flush=True)

        for Lq, Lk, D in cs.ATTN_SHAPES:
            q, k, v, out, dout, lse, scale = inputs(gen, Lq, Lk, D)
            BH = q.shape[0]
            shape = [BH, Lq, Lk, D]
            fn_old, got_old = old_call(old, q, k, v, out, dout, lse, scale)
            fn_new, got_new = new_call(new, q, k, v, out, dout, lse, scale)
            fn_old()
            fn_new()
            err = {f"d{n}": (a.float() - b.float()).abs().max().item()
                   for n, a, b in zip("qkv", got_new, got_old)}
            ms = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                fn = fn_old if which == "old" else fn_new
                ms[which].append(cs.time_ms(fn, args.reps))
            sq = [t.detach()[None].requires_grad_() for t in (q, k, v)]
            s_out = F.scaled_dot_product_attention(*sq, scale=scale)
            library_ms = cs.time_ms(lambda: torch.autograd.grad(
                s_out, sq, dout[None], retain_graph=True), args.reps)
            del s_out, sq
            b_ms, b_by = cs.attention_bwd_bound(BH, Lq, Lk, D)
            row = dict(shape=shape, old_ms=ms["old"], new_ms=ms["new"],
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_new_vs_old=err)
            print(json.dumps(row), flush=True)
            result["rows"].append(row)
            if ablated and D == args.ablate_d:
                times = {"all": [cs.time_ms(fn_new, args.reps)]}
                for name, lib in ablated.items():
                    times[name] = cs.time_ms(new_call(
                        lib, q, k, v, out, dout, lse, scale)[0], args.reps)
                times["all"].append(cs.time_ms(fn_new, args.reps))
                row = dict(shape=shape, ms=times)
                print(json.dumps(row), flush=True)
                result["ablations"].append(row)
            del q, k, v, out, dout, lse, fn_old, got_old, fn_new, got_new
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
