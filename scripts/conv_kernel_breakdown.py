#!/usr/bin/env python3
"""Where the 3x3 conv kernels' time goes on the card, and what each design
choice of the Hopper loop and of the project-then-stencil head is worth.

    python3 scripts/conv_kernel_breakdown.py [--only NAME ...]
        [--shapes all|head] [--out PATH]

Builds `diffcodec_tpu_torch/csrc/conv3x3.cu` as it is and once for each
entry of BUILDS below (`--only` keeps the builds named), the source edited
in memory (the build fails loudly if the source no longer reads as
expected, and a CPU test applies every edit to the current source), one
nvcc per build, all started together:
  * parts switched off, alone and in pairs: the TMA copies (the producer
    arrives on the stage's barrier without copying), the activation warps'
    work, the consumers' wgmma products (their ldmatrix goes with them:
    nothing reads the registers), and the epilogue's stores.  Such a build
    computes garbage: only its time is read; times that add up across
    parts mean the parts do not overlap;
  * the same for the head kernel (`conv3x3_head`, dc_conv3x3 where
    O <= 8; builds named head_*): its copies, its activation, its wgmma
    products, its stencil (the 9-tap sums; the stores stay);
  * one design choice undone each: its output is checked too.
Each build's `dc_conv3x3` (prologue 2), `dc_downsample_conv3x3` or
`dc_upsample_conv3x3` is timed with CUDA events (`chip_smoke.time_ms`,
twice) at SHAPES (`--shapes head`: the out-head's alone), and checked
against an fp32 reference of the same function: the count of elements
off by more than 0.05 + 0.02 |reference|.
Needs one CUDA device and nvcc; writes every row to --out (default
chiprun_out/conv_kernel_breakdown.json) and prints the card's name and
power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import time_ms  # noqa: E402
from diffcodec_tpu_torch import _kernels  # noqa: E402
from diffcodec_tpu_torch.ops import conv  # noqa: E402

# part -> [(text of conv3x3.cu, what switches it off)]
PARTS = {
    "copies": [
        ("        mbar_expect_tx(&hfull[s], T::PLANES * T::BOX_BYTES);\n",
         "        mbar_arrive(&hfull[s]);\n        return;\n"),
        ("          mbar_expect_tx(&wfull[ws], kWBytes);\n"
         "          tma_load_3d(",
         "          mbar_arrive(&wfull[ws]);\n"
         "          if (false) tma_load_3d(")],
    "activation": [
        ("      for (int row = t >> 3; row < T::PH * T::PW; row += kRowStep) {",
         "      for (int row = t >> 3; row < 0; row += kRowStep) {")],
    "products": [
        ("              wgmma_rs<kBN, 0>(acc[mt], afr[h][mt][k2],",
         "              if (false) wgmma_rs<kBN, 0>(acc[mt], afr[h][mt][k2],")],
    # the epilogue's 16-byte stores (O % 8 == 0), and the work that feeds
    # them; where the tile is staged, the store warps' stores
    "epilogue": [
        ("            if (!inside || n >= O) continue;",
         "            if (true) continue;"),
        ("              if (y < Ho && xx < Wo) {",
         "              if (false) {")],
}
# the head kernel's parts -> [(text of conv3x3.cu, what switches it off)]
HEAD_PARTS = {
    # the TMA copies: the thread arrives on the stage's barrier without
    # copying (the stage keeps what it held)
    "head_copies": [
        ("    mbar_expect_tx(bar, kPBoxBytes + kPWBytes);\n"
         "    tma_load_4d(st, &xmap, bar, k * kCK, ix0, iy0, b);\n"
         "    tma_load_3d(st + kPHaloBytes, &wmap, bar, 0, 0, g * n_chunks + "
         "k);\n",
         "    mbar_arrive(bar);\n")],
    "head_activation": [
        ("  for (int p = t >> 3; p < kPPix; p += kPThreads / 8) {",
         "  for (int p = t >> 3; p < 0; p += kPThreads / 8) {")],
    # the wgmma products
    "head_products": [
        ("        wgmma_ss<kPN, 0, 0>(acc[m], desc_advance(da, 32 * ks),",
         "        if (false) wgmma_ss<kPN, 0, 0>(acc[m], "
         "desc_advance(da, 32 * ks),")],
    # the 9-tap sums of the stencil (the bias, residual and stores stay)
    "head_stencil": [
        ("    for (int tap = 0; tap < 9; ++tap) {\n"
         "      v += z[",
         "    for (int tap = 0; tap < 0; ++tap) {\n"
         "      v += z[")],
}
# the upsample's phase in the tile walk, next to the output-channel tile
_PHASE = ("  t.p = S == 0 ? tile & 3 : 0;\n"
          "  if (S == 0) tile >>= 2;\n")
# design choice undone -> [(text of conv3x3.cu, what replaces it)]
CHOICES = {
    # two halo stages and eight weight stages at stride 1, not three and
    # six
    "two_halo_stages": [
        ("static constexpr int HS = S == 2 || STAGED ? 2 : 3;",
         "static constexpr int HS = 2;"),
        ("static constexpr int WS = S == 2 || STAGED ? 4 : 6;",
         "static constexpr int WS = S == 2 || STAGED ? 4 : 8;")],
    # the upsample's epilogue storing from the consumers' registers, as at
    # stride 1 and 2, with three halo and six weight stages in the shared
    # memory the stage took
    "unstaged_epilogue": [
        ("static constexpr bool STAGED = S == 0;",
         "static constexpr bool STAGED = false;")],
    # tiles numbered with the column fastest, the output-channel tile third
    # (stride 1 and 2; the upsample's phase stays next to the channel tile)
    "column_fastest": [
        ("  t.n0 = (tile % tiles_n) * kBN;\n"
         "  tile /= tiles_n;\n" + _PHASE +
         "  t.tx0 = (tile % tiles_w) * T::TW;\n"
         "  tile /= tiles_w;\n"
         "  t.ty0 = (tile % tiles_h) * T::TH;\n"
         "  t.b = tile / tiles_h;",
         _PHASE +
         "  t.tx0 = (tile % tiles_w) * T::TW;\n"
         "  tile /= tiles_w;\n"
         "  t.ty0 = (tile % tiles_h) * T::TH;\n"
         "  tile /= tiles_h;\n"
         "  t.n0 = (tile % tiles_n) * kBN;\n"
         "  t.b = tile / tiles_n;")],
    # the upsample's phase fastest in the tile walk, before the channel tile
    "phase_fastest": [
        ("  t.n0 = (tile % tiles_n) * kBN;\n"
         "  tile /= tiles_n;\n" + _PHASE,
         _PHASE + "  t.n0 = (tile % tiles_n) * kBN;\n"
         "  tile /= tiles_n;\n")],
    # the upsample's phase after the tile row: each image's four phases one
    # after the other, each reading the image's input again
    "phase_per_image": [
        (_PHASE, ""),
        ("  t.b = tile / tiles_h;",
         "  tile /= tiles_h;\n"
         "  t.p = S == 0 ? tile & 3 : 0;\n"
         "  t.b = S == 0 ? tile >> 2 : tile;")],
    # the epilogue's 4-byte stores of channel pairs, no quad transpose (and
    # no stage: its store warps stand down)
    "pair_stores": [
        ("    if ((O & 7) == 0) {", "    if (false) {"),
        ("      if (warp < 4 || (O & 7) != 0) return;",
         "      if (true) return;")],
    # no L2 prefetch of the residual rows
    "no_residual_prefetch": [
        ("      if (RES && k == k0 + n_chunks - 1) {", "      if (false) {")],
    # the head's SiLU by the Hopper loop's __expf and division (two SFU
    # operations an element) instead of tanh.approx (one)
    "head_exp_silu": [
        ("    prologue_tanh<PRO>(val, sc, sh);",
         "    prologue<PRO>(val, sc, sh);")],
    # the head's in-image test on every halo pixel, also where the whole
    # halo lies inside the image
    "head_checked_halo": [
        ("        activate_halo<PRO, false>(st, t, sc, sh, iy0, ix0, H, W);",
         "        activate_halo<PRO, true>(st, t, sc, sh, iy0, ix0, H, W);")],
}
OFF = [("activation",), ("copies",), ("copies", "activation"),
       ("products",), ("products", "activation"), ("epilogue",)]
HEAD_OFF = [("head_copies",), ("head_activation",), ("head_products",),
            ("head_stencil",), ("head_activation", "head_products"),
            ("head_activation", "head_products", "head_stencil")]
# name -> (edits, whether the build computes the function)
BUILDS = {"as_is": ([], True)}
BUILDS.update({"off_" + "_".join(off): (
    list(itertools.chain.from_iterable(PARTS[p] for p in off)), False)
    for off in OFF})
BUILDS.update({"head_off_" + "_".join(p[5:] for p in off): (
    list(itertools.chain.from_iterable(HEAD_PARTS[p] for p in off)), False)
    for off in HEAD_OFF})
BUILDS.update({name: (edits, True) for name, edits in CHOICES.items()})
# (B, H, W, C, O, stride, residual); stride 0: the upsample (H, W its
# input's), at the decoder's two heaviest upsamplers
SHAPES = [(7, 512, 512, 128, 3, 1, False),    # the out-head (conv3x3_head)
          (7, 512, 512, 256, 128, 1, False),
          (7, 512, 512, 128, 128, 1, True),
          (7, 128, 128, 512, 512, 1, False),
          (8, 512, 512, 128, 128, 2, False),
          (8, 256, 256, 256, 256, 2, False),
          (7, 256, 256, 256, 256, 0, False),
          (7, 128, 128, 512, 512, 0, False)]


def edited(src, edits, what):
    """`src` with each (old, new) of `edits` applied in turn; raises
    unless each old text occurs exactly once in what it is applied to."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{what}: the source has {src.count(old)} "
                               f"copies of {old!r}, not 1")
        src = src.replace(old, new)
    return src


def start_edited_build(src, out_dir, name):
    """Start one nvcc of the edited source `src`, written to
    `out_dir`/`name`.cu (the headers found in csrc/), into a shared library:
    (process, library path)."""
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"{name}.so")
    return subprocess.Popen([_kernels.LIBRARY._nvcc(), *_kernels.NVCC_FLAGS,
                             "-I", _kernels.CSRC_DIR, "-o", lib,
                             cu], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), lib


def build(name, edits, src, out_dir):
    """Start nvcc on the source with `edits`: (process, library path)."""
    return start_edited_build(edited(src, edits, f"conv3x3.cu, {name}"),
                              out_dir, name)


def inputs(gen, B, H, W, C, O, stride, residual):
    """x, scale, shift, chunked taps, bias, residual and the fp32
    reference of the function (GN affine + SiLU + conv at stride 1, the
    encoder's bottom/right-padded conv at stride 2, the conv of the
    nearest-2x upsampled x at stride 0)."""
    x = torch.randn(B, H, W, C, device="cuda", generator=gen).bfloat16()
    sc = torch.randn(B, C, device="cuda", generator=gen) * 0.25 + 1
    sh = torch.randn(B, C, device="cuda", generator=gen)
    w = (torch.randn(O, C, 3, 3, device="cuda", generator=gen)
         * (9 * C) ** -0.5).bfloat16()
    bias = torch.zeros(O, device="cuda")
    res = None
    if stride == 1:
        act = F.silu((x.float() * sc[:, None, None] + sh[:, None, None])
                     .bfloat16().float())
        want = F.conv2d(act.permute(0, 3, 1, 2), w.float(), padding=1)
        del act
    elif stride == 2:
        want = F.conv2d(F.pad(x.float(), (0, 0, 0, 1, 0, 1))
                        .permute(0, 3, 1, 2), w.float(), stride=2)
    else:
        up = (x.float()[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
              .reshape(B, 2 * H, 2 * W, C))
        want = F.conv2d(up.permute(0, 3, 1, 2), w.float(), padding=1)
        del up
    want = want.permute(0, 2, 3, 1)
    if residual:
        res = torch.randn(want.shape, device="cuda",
                          generator=gen).bfloat16()
        want = want + res.float()
    if stride == 1:
        taps = conv.conv3x3_weights(w)
    else:
        taps = conv.chunk_taps(conv.collapse_upsample_taps(w) if stride == 0
                               else conv.conv3x3_taps(w)[None],
                               conv.CONV_CHUNK)
    return x, sc, sh, taps, bias, res, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/conv_kernel_breakdown.json")
    ap.add_argument("--only", nargs="+", default=None)
    ap.add_argument("--shapes", choices=("all", "head"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_kernel_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with open(os.path.join(_kernels.CSRC_DIR, "conv3x3.cu")) as f:
        src = f.read()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: build(name, edits, src, tmp)
                 for name, (edits, _) in BUILDS.items()
                 if not args.only or name in args.only or name == "as_is"}
        libs = {}
        for name, (proc, path) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{err}")
            lib = ctypes.CDLL(path)
            for fn in ("dc_conv3x3", "dc_downsample_conv3x3",
                       "dc_upsample_conv3x3"):
                getattr(lib, fn).argtypes = _kernels._SIGNATURES[fn]
            libs[name] = lib
        gen = torch.Generator(device="cuda").manual_seed(0)
        shapes = [sh for sh in SHAPES if args.shapes == "all"
                  or sh[4] <= conv.HEAD_MAX_O]
        for B, H, W, C, O, stride, residual in shapes:
            x, sc, sh, taps, bias, res, want = inputs(
                gen, B, H, W, C, O, stride, residual)
            out = torch.empty(want.shape, device="cuda",
                              dtype=torch.bfloat16)
            row = dict(shape=[B, H, W, C, O], stride=stride,
                       residual=residual)
            for name, lib in libs.items():
                def call(lib=lib):
                    stream = torch.cuda.current_stream().cuda_stream
                    if stride == 1:
                        code = lib.dc_conv3x3(
                            x.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                            taps.data_ptr(), bias.data_ptr(),
                            None if res is None else res.data_ptr(),
                            out.data_ptr(), B, H, W, C, O, 2, stream)
                    elif stride == 0:
                        code = lib.dc_upsample_conv3x3(
                            x.data_ptr(), taps.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), B, H, W, C, O, stream)
                    else:
                        code = lib.dc_downsample_conv3x3(
                            x.data_ptr(), taps.data_ptr(), bias.data_ptr(),
                            out.data_ptr(), B, H, W, C, O, 0, stream)
                    _kernels.check(code, name)
                bad = None
                if BUILDS[name][1]:
                    out.zero_()
                    call()
                    err = (out.float() - want).abs()
                    bad = int((err > 0.05 + 0.02 * want.abs()).sum())
                row[name] = dict(ms=[time_ms(call, 10), time_ms(call, 10)],
                                 bad=bad)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del x, sc, sh, taps, bias, res, want, out
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, builds={n: e for n, (e, _) in
                                           BUILDS.items()}, rows=rows),
                  f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
