#!/usr/bin/env python3
"""The 3x3 conv kernels of this tree against an older `conv3x3.cu`, in turns.

    python3 scripts/conv_kernel_ab.py OLD_CU [--old-chunk 64]
        [--old-up-chunk 16] [--reps 10] [--out PATH]

Builds OLD_CU (for example a parent commit's
`diffcodec_tpu_torch/csrc/conv3x3.cu`, written out with `git show` beside
that commit's `hopper.cuh`, which it includes) into a library of its own
with this tree's nvcc flags, beside this tree's library, and times both
libraries' C entry points on the same inputs at every shape
`chip_smoke.py` checks (the fused decoder's and the encoder's GN+SiLU+conv
launches, the three stride-2 convs with both paddings, the upsamplers, the
SiLU+conv) in the order old, new, new, old, with `chip_smoke.time_ms`
(CUDA events, median of per-call times).  Each library gets the weights
in its own layout: chunks of `conv.CONV_CHUNK` input channels for this
tree's, and for the old one chunks of `--old-chunk` (64 since the Hopper
loop, 16 before it) and, for the upsample, of `--old-up-chunk` (16 while
the upsample ran on the mma.sync loop).  Beside them: cuDNN's conv of the input already activated,
upsampled or padded (`F.conv2d`), the bound, and max |new - old|.  First
it reports, for each kernel of this tree's `conv3x3.cu` and of OLD_CU,
what `nvcc -Xptxas -v` says (registers, stack, spills), how many HGMMA
(wgmma) instructions `cuobjdump -sass` finds in it, and whether each
kernel that both define compiles to the same SASS in both.  Needs one
CUDA device and nvcc; writes every row to --out (default
chiprun_out/conv_kernel_ab.json) and prints the card's name and power
limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from diffcodec_tpu_torch import _kernels  # noqa: E402
from diffcodec_tpu_torch.ops import conv  # noqa: E402


def load(path):
    lib = ctypes.CDLL(path)
    for name, argtypes in _kernels._SIGNATURES.items():
        if name.startswith("dc_") and "conv3x3" in name:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def build_old(src, out_dir):
    so = os.path.join(out_dir, "libold_conv3x3.so")
    cmd = [_kernels.LIBRARY._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return so


def sass_report(src, out_dir, prefix="conv3x3_"):
    """{kernel: {registers, stack, spill_stores, spill_loads, hgmma}} of
    the kernels in `src`, from ptxas -v and cuobjdump -sass of its cubin;
    the names of those whose name starts with `prefix` are shortened."""
    nvcc = _kernels.LIBRARY._nvcc()
    flags = [f for f in _kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = os.path.join(out_dir,
                         os.path.basename(src).replace(".cu", ".cubin"))
    proc = subprocess.run([nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o",
                           cubin, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -cubin failed:\n{proc.stderr}")

    def short(mangled):  # conv3x3_hopper<Li2ELb1ELi1E>, template args raw
        m = re.search(rf"({prefix}\w*?)I(\w*?)EEv", mangled)
        return f"{m.group(1)}<{m.group(2)}E>" if m else mangled

    report, name = {}, None
    for line in proc.stdout.splitlines() + proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = short(m.group(1))
            report[name] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
        capture_output=True, text=True, check=True).stdout
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = short(m.group(1))
            report.setdefault(name, {})["hgmma"] = 0
        elif name and "HGMMA" in line:
            report[name]["hgmma"] += 1
    return report


def sass_functions(cubin):
    """{function name: its SASS text} of a cubin, from cuobjdump -sass."""
    nvcc = _kernels.LIBRARY._nvcc()
    text = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
        capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            # the anonymous namespace's name carries a digest of the file
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                          m.group(1))
            funcs[name] = []
        elif name:
            funcs[name].append(line.strip())
    return {n: "\n".join(body) for n, body in funcs.items()}


def same_sass(old_src, new_src, tmp, prefix):
    """(ptxas/HGMMA report of new_src, of old_src, {kernel: same SASS})
    for the kernels both define, each source compiled to its own cubin."""
    out = {}
    for label, src in (("new", new_src), ("old", old_src)):
        d = os.path.join(tmp, f"{label}_{os.path.basename(src)}")
        os.makedirs(d, exist_ok=True)
        report = sass_report(src, d, prefix=prefix)
        cubin = os.path.join(d, os.path.basename(src).replace(".cu",
                                                              ".cubin"))
        out[label] = (report, sass_functions(cubin))
    new_f, old_f = out["new"][1], out["old"][1]
    same = {n: new_f[n] == old_f[n] for n in sorted(new_f) if n in old_f}
    return out["new"][0], out["old"][0], same


def cases(gen):
    """(kind, shape, call(lib, taps), taps before chunking, library call,
    flops, bytes), one case at a time, its inputs alive only while it is
    timed."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for B, H, W, C, O, residual in cs.GN_SHAPES + cs.ENCODER_GN_SHAPES:
        a = cs._conv_inputs(gen, B, H, W, C, O)
        x, sc, sh, w, b = (a[k] for k in ("x", "scale", "shift", "weight",
                                          "bias"))
        res = (torch.randn(B, H, W, O, device="cuda", generator=gen)
               .bfloat16() if residual else None)
        act = F.silu((x.float() * sc[:, None, None, :]
                      + sh[:, None, None, :]).bfloat16()).permute(0, 3, 1, 2)
        out = torch.empty(B, H, W, O, device="cuda", dtype=torch.bfloat16)
        b32 = b.float()

        def call(lib, taps, x=x, sc=sc, sh=sh, res=res, out=out, b32=b32,
                 shape=(B, H, W, C, O)):
            _kernels.check(lib.dc_conv3x3(
                x.data_ptr(), sc.data_ptr(), sh.data_ptr(), taps.data_ptr(),
                b32.data_ptr(), None if res is None else res.data_ptr(),
                out.data_ptr(), *shape, 2, stream()), "dc_conv3x3")
            return out
        yield ("gn_silu_conv3x3", (B, H, W, C, O, residual), call,
               conv.conv3x3_taps(w)[None], lambda act=act, w=w, b=b:
               F.conv2d(act, w, b, padding=1), 18.0 * B * H * W * C * O,
               2 * (B * H * W * C + B * H * W * O * (2 if residual else 1)
                    + 9 * C * O) + 4 * (2 * B * C + O))
    for B, H, W, C, O in cs.DOWN_SHAPES:
        for pad in (0, 1):
            a = cs._conv_inputs(gen, B, H, W, C, O)
            x, w, b = a["x"], a["weight"], a["bias"]
            Ho, Wo = (H + pad - 2) // 2 + 1, (W + pad - 2) // 2 + 1
            xp = F.pad(x, (0, 0, pad, 1, pad, 1)).permute(0, 3, 1, 2)
            out = torch.empty(B, Ho, Wo, O, device="cuda",
                              dtype=torch.bfloat16)
            b32 = b.float()

            def call(lib, taps, x=x, out=out, b32=b32, pad=pad,
                     shape=(B, H, W, C, O)):
                _kernels.check(lib.dc_downsample_conv3x3(
                    x.data_ptr(), taps.data_ptr(), b32.data_ptr(),
                    out.data_ptr(), *shape, pad, stream()),
                    "dc_downsample_conv3x3")
                return out
            yield ("downsample_conv3x3", (B, H, W, C, O, pad == 0), call,
                   conv.conv3x3_taps(w)[None], lambda xp=xp, w=w, b=b:
                   F.conv2d(xp, w, b, stride=2),
                   18.0 * B * Ho * Wo * C * O,
                   2 * (B * H * W * C + B * Ho * Wo * O + 9 * C * O) + 4 * O)
    for B, H, W, C, O in cs.UP_SHAPES:
        a = cs._conv_inputs(gen, B, H, W, C, O)
        x, w, b = a["x"], a["weight"], a["bias"]
        up = (x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
              .reshape(B, 2 * H, 2 * W, C).permute(0, 3, 1, 2))
        out = torch.empty(B, 2 * H, 2 * W, O, device="cuda",
                          dtype=torch.bfloat16)
        b32 = b.float()

        def call(lib, taps, x=x, out=out, b32=b32, shape=(B, H, W, C, O)):
            _kernels.check(lib.dc_upsample_conv3x3(
                x.data_ptr(), taps.data_ptr(), b32.data_ptr(),
                out.data_ptr(), *shape, stream()), "dc_upsample_conv3x3")
            return out
        yield ("upsample_conv3x3", (B, H, W, C, O), call,
               conv.collapse_upsample_taps(w), lambda up=up, w=w, b=b:
               F.conv2d(up, w, b, padding=1), 32.0 * B * H * W * C * O,
               2 * (B * H * W * C + 4 * B * H * W * O + 9 * C * O) + 4 * O)
    for B, H, W, C, O in cs.SILU_SHAPES:
        a = cs._conv_inputs(gen, B, H, W, C, O)
        x, w, b = a["x"], a["weight"], a["bias"]
        act = F.silu(x).permute(0, 3, 1, 2)
        out = torch.empty(B, H, W, O, device="cuda", dtype=torch.bfloat16)
        b32 = b.float()

        def call(lib, taps, x=x, out=out, b32=b32, shape=(B, H, W, C, O)):
            _kernels.check(lib.dc_conv3x3(
                x.data_ptr(), None, None, taps.data_ptr(), b32.data_ptr(),
                None, out.data_ptr(), *shape, 1, stream()), "dc_conv3x3")
            return out
        yield ("silu_conv3x3", (B, H, W, C, O), call,
               conv.conv3x3_taps(w)[None], lambda act=act, w=w, b=b:
               F.conv2d(act, w, b, padding=1), 18.0 * B * H * W * C * O,
               2 * (B * H * W * (C + O) + 9 * C * O) + 4 * O)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_cu")
    ap.add_argument("--old-chunk", type=int, default=conv.CONV_CHUNK)
    ap.add_argument("--old-up-chunk", type=int, default=16)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/conv_kernel_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    new = _kernels.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        sass, old_sass, same = same_sass(
            args.old_cu, os.path.join(_kernels.CSRC_DIR, "conv3x3.cu"), tmp,
            "conv3x3_")
        for label, rep in (("new", sass), ("old", old_sass)):
            for name, info in rep.items():
                print(json.dumps(dict(build=label, kernel=name, **info)),
                      flush=True)
        print(json.dumps(dict(same_sass_as_old=same)), flush=True)
        old = load(build_old(args.old_cu, tmp))
        for kind, shape, call, taps, library, flops, nbytes in cases(gen):
            t_new = conv.chunk_taps(taps, conv.CONV_CHUNK)
            t_old = conv.chunk_taps(taps, args.old_up_chunk
                                    if kind == "upsample_conv3x3"
                                    else args.old_chunk)
            err = (call(new, t_new).float()
                   - call(old, t_old).float()).abs().max().item()
            ms = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                lib, t = (old, t_old) if which == "old" else (new, t_new)
                ms[which].append(cs.time_ms(lambda: call(lib, t), args.reps))
            b_ms, b_by = cs.bound(flops, nbytes, cs.PEAK_BF16_FLOPS)
            row = dict(kernel=kind, shape=list(shape), old_ms=ms["old"],
                       new_ms=ms["new"],
                       library_ms=cs.time_ms(library, args.reps),
                       bound_ms=b_ms, bound_by=b_by,
                       max_abs_new_vs_old=err)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del call, taps, library, t_new, t_old
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, old=args.old_cu, build=sass,
                       old_build=old_sass, same_sass_as_old=same,
                       rows=rows), f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
