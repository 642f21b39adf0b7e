#!/usr/bin/env python3
"""Where the 3x3 conv kernel's time goes on the card, and what each design
choice of its Hopper loop is worth.

    python3 scripts/conv_kernel_breakdown.py [--out PATH]

Builds `diffcodec_tpu_torch/csrc/conv3x3.cu` as it is and once for each
entry of BUILDS below (the source is edited in memory; the build fails
loudly if the source no longer reads as expected), one nvcc per build, all
started together:
  * parts switched off, alone and in pairs: the TMA copies (the producer
    arrives on the stage's barrier without copying), the activation warps'
    work, and the consumers' wgmma products (their ldmatrix goes with
    them: nothing reads the registers).  Such a build computes garbage:
    only its time is read; times that add up across parts mean the parts
    do not overlap;
  * one design choice undone each: its output is checked too.
Each build's `dc_conv3x3` (prologue 2) or `dc_downsample_conv3x3` is timed
with CUDA events (`chip_smoke.time_ms`, twice) at SHAPES, and checked
against an fp32 reference of the same function: the count of elements off
by more than 0.05 + 0.02 |reference|.  Needs one CUDA device and nvcc;
writes every row to --out (default chiprun_out/conv_kernel_breakdown.json)
and prints the card's name and power limit last.
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
        ("            wgmma_m64n128k16(acc[mt], afr[h][mt][k2],",
         "            if (false) wgmma_m64n128k16(acc[mt], afr[h][mt][k2],")],
}
# design choice undone -> [(text of conv3x3.cu, what replaces it)]
CHOICES = {
    # two halo stages and eight weight stages at stride 1, not three and six
    "two_halo_stages": [
        ("static constexpr int HS = S == 1 ? 3 : 2;",
         "static constexpr int HS = 2;"),
        ("static constexpr int WS = S == 1 ? 6 : 4;",
         "static constexpr int WS = S == 1 ? 8 : 4;")],
    # tiles numbered with the column fastest, the output-channel tile third
    "column_fastest": [
        ("  t.n0 = (tile % tiles_n) * kBN;\n"
         "  tile /= tiles_n;\n"
         "  t.tx0 = (tile % tiles_w) * T::TW;\n"
         "  tile /= tiles_w;\n"
         "  t.ty0 = (tile % tiles_h) * T::TH;\n"
         "  t.b = tile / tiles_h;",
         "  t.tx0 = (tile % tiles_w) * T::TW;\n"
         "  tile /= tiles_w;\n"
         "  t.ty0 = (tile % tiles_h) * T::TH;\n"
         "  tile /= tiles_h;\n"
         "  t.n0 = (tile % tiles_n) * kBN;\n"
         "  t.b = tile / tiles_n;")],
    # the epilogue's 4-byte stores of channel pairs, no quad transpose
    "pair_stores": [("    if ((O & 7) == 0) {", "    if (false) {")],
    # no L2 prefetch of the residual rows
    "no_residual_prefetch": [
        ("      if (RES && k == k0 + n_chunks - 1) {", "      if (false) {")],
}
OFF = [("activation",), ("copies",), ("copies", "activation"),
       ("products",), ("products", "activation")]
# name -> (edits, whether the build computes the function)
BUILDS = {"as_is": ([], True)}
BUILDS.update({"off_" + "_".join(off): (
    list(itertools.chain.from_iterable(PARTS[p] for p in off)), False)
    for off in OFF})
BUILDS.update({name: (edits, True) for name, edits in CHOICES.items()})
# (B, H, W, C, O, stride, residual)
SHAPES = [(7, 512, 512, 256, 128, 1, False),
          (7, 512, 512, 128, 128, 1, True),
          (7, 128, 128, 512, 512, 1, False),
          (8, 512, 512, 128, 128, 2, False),
          (8, 256, 256, 256, 256, 2, False)]


def build(name, edits, src, out_dir):
    """Start nvcc on the source with `edits`: (process, library path)."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: conv3x3.cu no longer has {old!r}")
        src = src.replace(old, new)
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"{name}.so")
    return subprocess.Popen([_kernels.LIBRARY._nvcc(), *_kernels.NVCC_FLAGS,
                             "-o", lib, cu]), lib


def inputs(gen, B, H, W, C, O, stride, residual):
    """x, scale, shift, chunked taps, bias, residual and the fp32
    reference of the function (GN affine + SiLU + conv at stride 1, the
    encoder's bottom/right-padded conv at stride 2)."""
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
    else:
        want = F.conv2d(F.pad(x.float(), (0, 0, 0, 1, 0, 1))
                        .permute(0, 3, 1, 2), w.float(), stride=2)
    want = want.permute(0, 2, 3, 1)
    if residual:
        res = torch.randn(want.shape, device="cuda",
                          generator=gen).bfloat16()
        want = want + res.float()
    taps = conv.chunk_taps(conv.conv3x3_taps(w)[None], conv.CONV_CHUNK)
    return x, sc, sh, taps, bias, res, want


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
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: build(name, edits, src, tmp)
                 for name, (edits, _) in BUILDS.items()}
        libs = {}
        for name, (proc, path) in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for {name}")
            lib = ctypes.CDLL(path)
            for fn in ("dc_conv3x3", "dc_downsample_conv3x3"):
                getattr(lib, fn).argtypes = _kernels._SIGNATURES[fn]
            libs[name] = lib
        gen = torch.Generator(device="cuda").manual_seed(0)
        for B, H, W, C, O, stride, residual in SHAPES:
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
