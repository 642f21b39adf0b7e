"""Build and load the port's CUDA kernels.

Every `.cu` file under `csrc/` is compiled by `nvcc` into one shared
library with a plain C interface, at first use, and loaded with `ctypes`
(`csrc/hopper.cuh` holds the Hopper primitives they share):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/torch_kernels/<hash>/libdiffcodec_kernels.so \
        csrc/*.cu

The sources include CUDA's headers only, never PyTorch's, so the build takes
seconds.  The library links the CUDA runtime alone: the one driver call it
makes, `cuTensorMapEncodeTiled` (the TMA descriptors of the conv and the
attention backward), is fetched at run time through
`cudaGetDriverEntryPoint`, so no `-lcuda`.  `<hash>` is a digest of the
sources, the headers and the flags, so an edited source or header builds
anew and an unchanged one loads the library already built.
A missing `nvcc`, a failed build or a failed load raises with the
compiler's output; nothing falls back.

Each C function takes its pointers and the CUDA stream as `void*` and
returns the `cudaError_t` of its launch; `check` turns a non-zero code into
an exception.

`PlainBackward` gives a kernel wrapper its gradient: the forward is the
kernel (its plain version on a CPU tensor), the backward autograd's of the
plain version, recomputed from the saved inputs; the JAX package's
`custom_vjp`s around its Pallas kernels do the same.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_NAME = "libdiffcodec_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C name -> argument types (every pointer and the stream are c_void_p, so
# ctypes never cuts a 64-bit address to 32 bits)
_F = ctypes.c_float
_SIGNATURES = {
    "dc_attention_fwd": [_P] * 5 + [_I] * 4 + [_F, _P],
    "dc_attention_bwd": [_P] * 11 + [_I] * 4 + [_F, _P],
    "dc_splat_sum": [_P, _P, _P, _I, _I, _I, _I, _P],
    "dc_splat_row": [_I],
    "dc_conv3x3": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dc_upsample_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dc_downsample_conv3x3": [_P] * 4 + [_I] * 6 + [_P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, failed, or its library did not load."""


class _Library:
    """The loaded library, built once per process on first use."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds = None  # nvcc + load, or load alone
        self.compiled = False      # whether this process ran nvcc
        self.path = None

    def sources(self):
        """Every `.cu` (compiled) and `.cuh` (included) file of csrc/: the
        build directory's digest covers both, so an edited header builds
        anew."""
        return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                      if f.endswith((".cu", ".cuh")))

    def _nvcc(self):
        candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                      for v in ("CUDA_HOME", "CUDA_PATH") if v in os.environ]
        candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
        for c in candidates:
            if c and os.path.isfile(c) and os.access(c, os.X_OK):
                return c
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
            "/usr/local/cuda/bin); the port's CUDA kernels cannot be built")

    def _digest(self, sources):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in sources:
            h.update(os.path.basename(s).encode())
            with open(s, "rb") as f:
                h.update(f.read())
        return h.hexdigest()[:16]

    def _build(self):
        sources = self.sources()
        out_dir = os.path.join(BUILD_ROOT, self._digest(sources))
        path = os.path.join(out_dir, LIB_NAME)
        t0 = time.perf_counter()
        self.compiled = not os.path.isfile(path)
        if self.compiled:
            nvcc = self._nvcc()
            os.makedirs(out_dir, exist_ok=True)
            # build under a private name and rename: concurrent builders
            # never load a half-written library
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   *(s for s in sources if s.endswith(".cu"))]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self.path = path
        return lib

    def get(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._build()
            return self._lib


LIBRARY = _Library()


def lib():
    """The loaded kernel library (built on first call)."""
    return LIBRARY.get()


def check(code: int, name: str):
    """Raise if a launch returned a non-zero cudaError_t."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{code}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a C pointer value."""
    return torch.cuda.current_stream(device).cuda_stream


class PlainBackward(torch.autograd.Function):
    """y = fast(*args), with the gradient of plain(*args).

    `args` are tensors or None; the backward recomputes `plain` on the
    saved inputs under autograd and returns its vector-Jacobian product
    for every input that needs a gradient."""

    @staticmethod
    def forward(ctx, fast, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return fast(*args)

    @staticmethod
    def backward(ctx, grad):
        args = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(n) if a is not None else None
                      for a, n in zip(args, needs)]
            out = ctx.plain(*leaves)
        wanted = [a for a, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad,
                                         allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in needs))
