#!/usr/bin/env python3
"""The attention forward of this tree against an older one, in turns.

    python3 scripts/attention_fwd_ab.py OLD_CU [--ablate] [--ablate-d 40]
        [--reps 10] [--out PATH]

OLD_CU is an older `attention.cu` with the same C entry `dc_attention_fwd`
(the mma.sync forward: `git show
557bcd2:diffcodec_tpu_torch/csrc/attention.cu`, written beside that
commit's `hopper.cuh`, which it includes).  It is built into a library of
its own with this tree's nvcc flags, beside this tree's library, and the
two forwards are timed on the same inputs at every shape `chip_smoke.py`
checks (`ATTN_SHAPES`): the 8 decode shapes (BH = 112, no lse) and the 8
training shapes (BH = 64, with lse), in the order old, new, new, old, with
`chip_smoke.time_ms` (CUDA events, median of per-call times), each on
output buffers allocated once.  Beside them: SDPA, the bound and max
|new - old| of the output (and of lse).

First it reports, for each kernel of this tree's `attention.cu` and of
OLD_CU, what `nvcc -Xptxas -v` says (registers, stack, spills) and how many
HGMMA (wgmma) instructions `cuobjdump -sass` finds in it, and whether each
kernel that both define, other than the forward, compiles to the same SASS
in both; where OLD_CU's directory also holds a `conv3x3.cu`, the same for
the conv kernels of that file and of this tree's (so a change to the
shared `hopper.cuh` that moves another kernel shows).

With --ablate it also builds this tree's `attention.cu` with parts of the
forward kernel switched off (ABLATIONS; the results are then wrong) and
with one design choice undone or its alternative tried (CHOICES; the
results stay right), by text edits of the source in memory, as
`conv_kernel_breakdown.py` makes them (a CPU test applies each to the
current source), each with the one head width --ablate-d (default 40)
instantiated, and times each build against the whole one at the shapes of
that width, to say what bounds the kernel and what each choice is worth.

All nvcc builds start together.  Needs one CUDA device and nvcc; writes
every row to --out (default chiprun_out/attention_fwd_ab.json) and prints
the card's name and power limit last.
"""

from __future__ import annotations

import argparse
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

import attention_bwd_ab  # noqa: E402
import chip_smoke as cs  # noqa: E402
from conv_kernel_ab import same_sass  # noqa: E402
from conv_kernel_breakdown import edited, start_edited_build  # noqa: E402
from diffcodec_tpu_torch import _kernels  # noqa: E402

SIGNATURES = {"dc_attention_fwd": _kernels._SIGNATURES["dc_attention_fwd"]}
_PV = "    wgmma_rs<D, 1>(o, pa[kv], desc_advance(d_v, kv * 2048), 1);"
_S = "    wgmma_ss<T::BK, 0, 0>("
_TILE = ("      mbar_wait(&full[(kv + it) % T::STAGES], "
         "((kv + it) / T::STAGES) & 1);\n")
# part switched off -> [(text of attention.cu, what replaces it)]
ABLATIONS = {
    "no exponentials": [
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "  y = x;")],
    "no P.V product": [(_PV, "    if (false)" + _PV[3:])],
    "no products": [(_PV, "    if (false)" + _PV[3:]),
                    (_S, "    if (false)" + _S[3:])],
    "no ping-pong": [("constexpr bool kFwdPingPong = true;",
                      "constexpr bool kFwdPingPong = false;")],
    "no intra-warpgroup overlap": [
        ("constexpr bool kFwdIntraOverlap = true;",
         "constexpr bool kFwdIntraOverlap = false;")],
    "two consumer warpgroups": [("constexpr int kFwdNarrowConsumers = 3;",
                                 "constexpr int kFwdNarrowConsumers = 2;")],
    # the K and V stream alone: past the first tile the consumers release
    # each stage once it has landed, and compute nothing
    "loads only": [
        ("constexpr bool kFwdPingPong = true;",
         "constexpr bool kFwdPingPong = false;"),
        (_TILE, _TILE + "      release(&empty[(kv + it - 1) % T::STAGES]);\n"
                "      continue;\n")],
}
_PACK = """// P rounded to bf16 (to nearest, ties up) on the integer pipe
__device__ __forceinline__ uint32_t pack_int(float lo, float hi) {
  const uint32_t a = __float_as_uint(lo) + 0x8000u;
  const uint32_t b = __float_as_uint(hi) + 0x8000u;
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0x7632;\\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

"""
_FRAGS = ("// the A fragments (k-steps of 16 columns) of an m64nN fp32 "
          "accumulator")
_EXP2 = """// 2^x for x <= 0 on the FMA pipe (x clamped at -126; a degree-4 fit
// on [-0.5, 0.5], 2.7e-6 relative error)
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: round(x) in its low bits
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(fmaf(0.00957009568810463f, f,
      0.05591786652803421f), f, 0.240247443318367f), f,
      0.6931217908859253f), f, 0.9999992847442627f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

"""
_SOFTMAX = "// The online softmax of a tile of S"
_EXPL = "        x = fast_exp2(fmaf(x, scale_log2, -m[h]));"
_PACKA = ("    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);\n"
          "    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);\n"
          "    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);\n"
          "    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);\n")
# design choice -> the edits that undo it, or try the alternative
CHOICES = {
    # boxes of 64 columns, the columns past D zero-filled by TMA
    "64-column K and V boxes": [
        ("  static constexpr int KV_TX = BK * D * 2;",
         "  static constexpr int KV_TX = BK * NC * 64 * 2;"),
        ("encode_bld(enc, &maps.k_tail, k, T::D, lk, bh, T::BK, T::TAIL)",
         "encode_bld(enc, &maps.k_tail, k, T::D, lk, bh, T::BK)"),
        ("encode_bld(enc, &maps.v_tail, v, T::D, lk, bh, T::BK, T::TAIL)",
         "encode_bld(enc, &maps.v_tail, v, T::D, lk, bh, T::BK)")],
    "one Q buffer": [("  static constexpr int QBUF = NC == 1 ? 2 : 1;",
                      "  static constexpr int QBUF = 1;")],
    "80-key tiles": [("  static constexpr int BK = D > 80 ? 64 : 128;",
                      "  static constexpr int BK = D > 80 ? 64 : 80;")],
    # P to bf16 by integer adds and a byte permute instead of
    # cvt.rn.bf16x2.f32, which shares the SFU pipe with ex2.approx (the
    # backward's pack_a too: ablated builds time the forward only)
    "P packed on the integer pipe": [
        (_FRAGS, _PACK + _FRAGS),
        (_PACKA, _PACKA.replace("pack_bf16", "pack_int"))],
    # a quarter of the exponentials by a polynomial on the FMA pipe
    "a quarter of exp2 on the FMA pipe": [
        (_SOFTMAX, _EXP2 + _SOFTMAX),
        (_EXPL, "        x = fmaf(x, scale_log2, -m[h]);\n"
                "        x = e && h ? exp2_fma(x) : fast_exp2(x);")],
}


def one_width(d):
    """The edits that instantiate the forward and the backward for head
    width `d` only (fewer instantiations build faster; ptxas 12.9 crashed
    on some ablated builds of the backward); the other widths return
    cudaErrorNotSupported."""
    call = "    return launch_fwd<decltype(d8)::value>("
    return [(call, f"    if constexpr (8 * decltype(d8)::value != {d}) "
                   "return (int)cudaErrorNotSupported;\n"
                   f"    else{call[3:]}")] + attention_bwd_ab.one_width(d)


def forward_call(lib, q, k, v, with_lse, scale):
    """`lib`'s dc_attention_fwd on buffers allocated once: (call, (o,
    lse or None))."""
    BH, Lq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(BH, Lq, device="cuda") if with_lse else None
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _kernels.check(lib.dc_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), BH, Lq, k.shape[1], D,
            float(scale), stream), "dc_attention_fwd")
    return call, (out, lse)


def shapes():
    """(BH, Lq, Lk, D, with_lse): the decode's, then training's."""
    for BH, with_lse in ((cs.BATCH * cs.HEADS, False), (cs.TRAIN_BH, True)):
        for Lq, Lk, D in cs.ATTN_SHAPES:
            yield BH, Lq, Lk, D, with_lse


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_cu")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--ablate-d", type=int, default=40)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/attention_fwd_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_fwd_ab: needs a CUDA device", file=sys.stderr)
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
        old_proc = attention_bwd_ab.start_build(args.old_cu, old_so)
        builds = {}
        for i, (name, edits) in enumerate(
                {**ABLATIONS, **CHOICES}.items() if args.ablate else ()):
            builds[name] = start_edited_build(
                edited(text, edits + one_width(args.ablate_d),
                       f"attention.cu, {name}"), tmp, f"ablate{i}")
        new = _kernels.lib()
        old = attention_bwd_ab.load(old_proc, old_so, SIGNATURES)
        ablated = {}
        for name, (proc, so) in builds.items():
            try:
                ablated[name] = attention_bwd_ab.load(proc, so, SIGNATURES)
            except RuntimeError as e:  # ptxas has crashed on some builds
                note = dict(ablation=name, build_failed=str(e)[-300:])
                print(json.dumps(note), flush=True)
                result["ablations"].append(note)
        pairs = [(args.old_cu, src, "attention_[a-z_]*kernel")]
        old_conv = os.path.join(os.path.dirname(args.old_cu), "conv3x3.cu")
        if os.path.isfile(old_conv):
            pairs.append((old_conv, os.path.join(_kernels.CSRC_DIR,
                                                 "conv3x3.cu"), "conv3x3_"))
        for old_src, new_src, prefix in pairs:
            rep, old_rep, same = same_sass(old_src, new_src, tmp, prefix)
            base = os.path.basename(new_src)
            for label, r in (("build", rep), ("old_build", old_rep)):
                for name, info in r.items():
                    row = dict(build=label, file=base, kernel=name, **info)
                    print(json.dumps(row), flush=True)
                    result.setdefault(label, []).append(row)
            row = dict(file=base, same_sass_as_old=same)
            print(json.dumps(row), flush=True)
            result.setdefault("sass", []).append(row)

        for BH, Lq, Lk, D, with_lse in shapes():
            scale = D ** -0.5
            q, k, v = (torch.randn(BH, L, D, device="cuda", generator=gen)
                       .bfloat16() for L in (Lq, Lk, Lk))
            shape = [BH, Lq, Lk, D]
            fn_old, got_old = forward_call(old, q, k, v, with_lse, scale)
            fn_new, got_new = forward_call(new, q, k, v, with_lse, scale)
            fn_old()
            fn_new()
            err = {"o": (got_new[0].float() - got_old[0].float()).abs()
                   .max().item()}
            if with_lse:
                err["lse"] = (got_new[1] - got_old[1]).abs().max().item()
            ms = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                fn = fn_old if which == "old" else fn_new
                ms[which].append(cs.time_ms(fn, args.reps))
            library_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale), args.reps)
            b_ms, b_by = cs.bound(
                4.0 * BH * Lq * Lk * D,
                2 * 2 * BH * D * (Lq + Lk) + (4 * BH * Lq if with_lse else 0),
                cs.PEAK_BF16_FLOPS)
            row = dict(shape=shape, with_lse=with_lse, old_ms=ms["old"],
                       new_ms=ms["new"], library_ms=library_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       max_abs_new_vs_old=err)
            print(json.dumps(row), flush=True)
            result["rows"].append(row)
            if ablated and D == args.ablate_d:
                times = {"all": [cs.time_ms(fn_new, args.reps)]}
                for name, lib in ablated.items():
                    times[name] = cs.time_ms(forward_call(
                        lib, q, k, v, with_lse, scale)[0], args.reps)
                times["all"].append(cs.time_ms(fn_new, args.reps))
                row = dict(shape=shape, with_lse=with_lse, ms=times)
                print(json.dumps(row), flush=True)
                result["ablations"].append(row)
            del q, k, v, fn_old, got_old, fn_new, got_new
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
