"""The port's CUDA kernels and their build layer.

Tests marked `cuda` hold each kernel against its plain PyTorch version on
the card and skip where there is none.  This file imports no JAX, so on the
card's machine it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py

The unmarked tests check `_kernels.py` (nvcc missing or failing raises with
the compiler's output) on any machine.
"""

import os
import stat

import numpy as np
import pytest
import torch

from diffcodec_tpu_torch import _kernels
from diffcodec_tpu_torch.ops.attention import attention, attention_reference
from diffcodec_tpu_torch.ops.softsplat import (softsplat, splat_sum,
                                               splat_sum_reference)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _flow(rng, B, H, W):
    f = (rng.standard_normal((B, H, W, 2)) * 2.5).astype(np.float32)
    f[0, 1, 2, 0] = np.nan
    f[-1, 0, 0, 1] = np.inf
    f[:, :, -1, 0] = W + 3.0
    return torch.from_numpy(f)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Lq,Lk,D", [
    (16, 256, 256, 40), (16, 128, 77, 80), (8, 64, 64, 160),
    (8, 100, 77, 160), (4, 33, 5, 32), (2, 64, 300, 16), (3, 17, 130, 40),
    (4, 2048, 2048, 40)])
def test_attention_kernel_matches_plain(cuda_device, BH, Lq, Lk, D):
    g = torch.Generator(device=cuda_device).manual_seed(BH + Lq + D)
    q, k, v = (torch.randn(BH, L, D, device=cuda_device, generator=g)
               .bfloat16() for L in (Lq, Lk, Lk))
    before = attention.launches
    got = attention(q, k, v, D ** -0.5).float()
    assert attention.launches == before + 1
    want = attention_reference(q, k, v, D ** -0.5).float()
    # bf16 output: one ulp of x is at most 2^-7 |x|.  The two round P to
    # bf16 at different points and each rounds its output, so an element
    # may differ by an ulp of itself plus one of the largest output; the
    # limit follows each shape's output scale, which shrinks as Lk grows.
    # The norm check catches a small fault that moves every element.
    ulp = 2.0 ** -7
    torch.testing.assert_close(got, want, rtol=ulp,
                               atol=ulp * want.abs().max().item())
    assert (got - want).norm() <= 1e-2 * want.norm()


@pytest.mark.cuda
def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 16, 40, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        attention(q.float(), q.float(), q.float(), 0.1)
    with pytest.raises(ValueError):
        attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, 0.1)
    for d in (12, 64, 168):  # widths the kernel is not built for
        odd = torch.zeros(2, 16, d, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            attention(odd, odd, odd, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C", [(3, 16, 16, 161), (3, 16, 16, 3),
                                     (2, 8, 8, 641), (1, 5, 7, 1)])
def test_splat_kernel_matches_plain(cuda_device, B, H, W, C):
    rng = np.random.default_rng(B * H * W + C)
    vals = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32))
    flow = _flow(rng, B, H, W)
    before = splat_sum.launches
    got = splat_sum(vals.to(cuda_device), flow.to(cuda_device))
    assert splat_sum.launches == before + 1
    # fp32 atomics add in a varying order
    torch.testing.assert_close(got.cpu(), splat_sum_reference(vals, flow),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_softsplat_soft_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.standard_normal((2, 12, 12, 9)).astype(
        np.float32))
    metric = torch.from_numpy(rng.standard_normal((2, 12, 12, 1)).astype(
        np.float32))
    flow = _flow(rng, 2, 12, 12)
    got = softsplat(vals.to(cuda_device), flow.to(cuda_device),
                    metric.to(cuda_device), "soft")
    torch.testing.assert_close(got.cpu(), softsplat(vals, flow, metric,
                                                    "soft"),
                               atol=1e-5, rtol=1e-4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels.os, "access", lambda path, mode: False)
    with pytest.raises(_kernels.KernelBuildError, match="nvcc not found"):
        _kernels._Library().get()


def test_build_failure_carries_compiler_output(monkeypatch, tmp_path):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                    "exit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_kernels, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(_kernels.KernelBuildError,
                       match="no such intrinsic"):
        _kernels._Library().get()
    # nothing half-built is left where a later load would find it
    assert not any(p.name.endswith(".so")
                   for p in (tmp_path / "build").rglob("*"))


def test_build_directory_follows_the_sources(tmp_path):
    lib = _kernels._Library()
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    d1 = lib._digest([str(a), str(b)])
    assert d1 == lib._digest([str(a), str(b)])
    b.write_text("// two, edited\n")
    assert lib._digest([str(a), str(b)]) != d1
    assert os.path.basename(_kernels.CSRC_DIR) == "csrc"
