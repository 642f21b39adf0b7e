"""The port's CUDA kernels and their build layer.

Tests marked `cuda` hold each kernel (attention forward and backward,
splat, the 3x3 convs, the stride-2 conv) against its plain PyTorch version
on the card, and each differentiable wrapper's gradient against autograd
of its plain version, and skip where there is no card.  This file imports
no JAX, so on the card's machine it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py

The unmarked tests check `_kernels.py` (nvcc missing or failing raises with
the compiler's output) and that every in-memory edit of a kernel source
that `scripts/conv_kernel_breakdown.py`, `scripts/attention_bwd_ab.py`,
`scripts/attention_fwd_ab.py` and `scripts/splat_kernel_ab.py` build still
finds its text, on any machine.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from diffcodec_tpu_torch import _kernels
from diffcodec_tpu_torch.ops import conv
from diffcodec_tpu_torch.ops.attention import (attention,
                                               attention_backward,
                                               attention_bwd,
                                               attention_forward,
                                               attention_reference)
from diffcodec_tpu_torch.ops.softsplat import (softsplat, splat_sum,
                                               splat_sum_reference)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_REPO, os.path.join(_REPO, "scripts")]
import attention_bwd_ab  # noqa: E402
import attention_fwd_ab  # noqa: E402
import conv_kernel_breakdown  # noqa: E402
import splat_kernel_ab  # noqa: E402


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
    got = attention(q, k, v, D ** -0.5)
    assert attention.launches == before + 1
    _assert_attention_close(got, attention_reference(q, k, v, D ** -0.5))


def _assert_attention_close(got, want):
    """bf16 output: one ulp of x is at most 2^-7 |x|.  The kernel and the
    plain version round P to bf16 at different points and each rounds its
    output, so an element may differ by an ulp of itself plus one of the
    largest output; the limit follows each shape's output scale, which
    shrinks as Lk grows.  The norm check catches a small fault that moves
    every element."""
    got, want = got.float(), want.float()
    ulp = 2.0 ** -7
    torch.testing.assert_close(got, want, rtol=ulp,
                               atol=ulp * want.abs().max().item())
    assert (got - want).norm() <= 1e-2 * want.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 40, 80, 160])
@pytest.mark.parametrize("Lk", [1, 77, 127, 128, 129, 300])
@pytest.mark.parametrize("Lq", [1, 63, 64, 65, 129])
def test_attention_forward_edges_match_plain(cuda_device, Lq, Lk, D):
    """The forward at the edges of its tiles, at every width: Lq around a
    consumer warpgroup's 64 queries and an item's 128 (D > 64) or 192
    (Lq <= 64 leaves one consumer warpgroup, Lq <= 128 two), Lk around the
    key tile (128 keys; 64 at D = 160), the 77-token context and a single
    key.  Its lse against
    torch.logsumexp of the fp32 scaled logits: fp32 sums of exponentials in
    another order, and ex2.approx, within 1e-3."""
    q, k, v, _ = _attention_inputs(cuda_device, 3, Lq, Lk, D,
                                   seed=Lq * 1000 + Lk + D)
    scale = D ** -0.5
    before = attention.launches
    out, lse = attention_forward(q, k, v, scale, with_lse=True)
    assert attention.launches == before + 1
    assert out.shape == q.shape and lse.shape == (3, Lq)
    _assert_attention_close(out, attention_reference(q, k, v, scale))
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-3,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Lq,Lk,D", [
    (8, 4096, 4096, 40), (3, 129, 300, 160), (4, 65, 77, 80),
    (16, 64, 64, 160)])
def test_attention_forward_repeats_bitwise(cuda_device, BH, Lq, Lk, D):
    """The forward adds in a fixed order (no atomics): two launches give
    the same bits, and asking for lse does not change the output."""
    q, k, v, _ = _attention_inputs(cuda_device, BH, Lq, Lk, D, seed=D)
    out1, lse1 = attention_forward(q, k, v, D ** -0.5, with_lse=True)
    out2, lse2 = attention_forward(q, k, v, D ** -0.5, with_lse=True)
    out3, none = attention_forward(q, k, v, D ** -0.5)
    assert none is None
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)
    assert torch.equal(out1, out3)


@pytest.mark.cuda
def test_attention_forward_rejects_a_scale_not_above_zero(cuda_device):
    """The kernel takes each row's maximum of the unscaled logits, which
    is the maximum of the scaled ones only where scale > 0."""
    q = torch.zeros(2, 16, 40, device=cuda_device, dtype=torch.bfloat16)
    for scale in (0.0, -0.1, float("nan")):
        with pytest.raises(RuntimeError, match="dc_attention_fwd"):
            attention_forward(q, q, q, scale)


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
@pytest.mark.parametrize("C", [1, 2, 3, 5, 161, 321, 641])
def test_splat_kernel_matches_plain_at_every_alignment(cuda_device, C):
    """Odd H and W and C = 1, 2, 3, 5, 161, 321, 641: destination rows
    start at every offset mod 4 floats, so each corner's row has every
    head (0-3 scalar channels before its first 16-byte boundary) and tail
    of the v4 reductions; with a NaN, an infinite, an off-frame and a
    -1e9 flow."""
    rng = np.random.default_rng(C)
    B, H, W = 3, 9, 13
    vals = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32))
    flow = _flow(rng, B, H, W)
    flow[1, 2, :, 1] = -1e9
    before = splat_sum.launches
    got = splat_sum(vals.to(cuda_device), flow.to(cuda_device))
    assert splat_sum.launches == before + 1
    # fp32 reductions add in a varying order
    torch.testing.assert_close(got.cpu(), splat_sum_reference(vals, flow),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,spread", [
    (2, 40, 37, 161, 0.5), (2, 40, 37, 161, 6.0), (1, 64, 64, 33, 1.5),
    (2, 33, 70, 321, 2.0)])
def test_splat_kernel_matches_plain_with_local_and_wide_flows(
        cuda_device, B, H, W, C, spread):
    """Larger frames, with flows of a spread of half a pixel (most corners
    land next to their source) to six pixels, and a NaN, an infinite, an
    off-frame and a -1e9 flow."""
    rng = np.random.default_rng(H * W + C)
    vals = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32))
    flow = _flow(rng, B, H, W) * (spread / 2.5)
    flow[:, :, -1, 0] = W + 3.0
    flow[-1, 3, :, 1] = -1e9
    got = splat_sum(vals.to(cuda_device), flow.to(cuda_device))
    torch.testing.assert_close(got.cpu(), splat_sum_reference(vals, flow),
                               atol=1e-5, rtol=1e-5)


def _smooth_flow(rng, B, H, W):
    """A smooth field as RAFT's flows are: per sample a translation of up
    to 8 pixels plus a field at 1/32 of the frame, upsampled bilinearly,
    ~2 pixels; with a NaN, an infinite and an off-frame flow."""
    g = (max(1, H // 32), max(1, W // 32))
    field = torch.nn.functional.interpolate(
        torch.from_numpy(rng.standard_normal((B, 2) + g).astype(np.float32)),
        size=(H, W), mode="bilinear", align_corners=False)
    field = field * (2.0 / field.std().clamp_min(1e-6))
    shift = torch.from_numpy(rng.uniform(-8, 8, (B, 2, 1, 1)).astype(
        np.float32))
    f = (field + shift).permute(0, 2, 3, 1).contiguous()
    f[0, 1, 2, 0] = float("nan")
    f[-1, 0, 0, 1] = float("inf")
    f[:, :, -1, 0] = W + 3.0
    return f


def _splat_flow(rng, kind, B, H, W):
    """'local' (0.5 pixels), 'wide' (6 pixels), 'smooth' (`_smooth_flow`)
    or 'converge' (every pixel of a 32 x 32 block to its centre plus 0,
    1/4 or 1/2 pixel: a tile's corners in a few destinations, with
    weights that are multiples of 1/16)."""
    if kind == "smooth":
        return _smooth_flow(rng, B, H, W)
    if kind == "converge":
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        f = np.stack([xx // 32 * 32 + 16 - xx, yy // 32 * 32 + 16 - yy],
                     -1)[None].repeat(B, 0)
        f += rng.choice(np.float32([0, 0.25, 0.5]), f.shape)
        return torch.from_numpy(np.ascontiguousarray(f))
    return _flow(rng, B, H, W) * ({"local": 0.5, "wide": 6.0}[kind] / 2.5)


def _misaligned(t, floats):
    """A contiguous copy of `t` whose data starts `floats` floats past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[floats:floats + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["local", "wide", "smooth"])
@pytest.mark.parametrize("C", list(range(1, 16)))
def test_splat_rows_kernel_matches_plain(cuda_device, C, kind):
    """Below 16 channels (the rows kernel at C = 3, 4, rows padded to
    whole v4s at 3; the first design's 8 lanes a pixel otherwise): odd H
    and W, so that unpadded rows start at every offset mod 4 floats, local,
    wide and smooth flows (lane pairs and merged corners),
    with a NaN, an infinite, an off-frame and a -1e9 flow; the result is
    [B, H, W, C] whatever width the kernel's rows have."""
    rng = np.random.default_rng(100 * C + len(kind))
    B, H, W = 3, 37, 45
    vals = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32))
    flow = _splat_flow(rng, kind, B, H, W)
    flow[1, 2, :, 1] = -1e9
    before = splat_sum.launches
    got = splat_sum(vals.to(cuda_device), flow.to(cuda_device))
    assert splat_sum.launches == before + 1
    assert tuple(got.shape) == (B, H, W, C)
    # fp32 reductions add in a varying order
    torch.testing.assert_close(got.cpu(), splat_sum_reference(vals, flow),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["local", "wide", "smooth", "converge"])
@pytest.mark.parametrize("B,H,W,C", [
    (1, 512, 512, 3), (8, 512, 512, 4), (8, 512, 512, 3), (16, 512, 512, 4),
    (16, 512, 512, 3), (16, 512, 512, 7), (16, 512, 512, 15),
    (32, 256, 256, 3), (16, 256, 256, 4), (27, 263, 301, 4),
    (27, 263, 301, 3), (32, 255, 257, 4)])
def test_splat_small_channels_match_plain_at_full_frames(cuda_device, B, H,
                                                         W, C, kind):
    """The residue transform's full frames, B up to 16 (both directions
    of a batch of 8), the DDPM's 256 px at B = 32 (the tile kernel) and 16
    (under 2^21 pixels: the rows kernel), and frames the tile kernel cuts
    into ragged tiles (263 x 301) or leaves to the rows kernel (255 x 257,
    under 256 x 256 pixels an image), against the plain version on the
    card; 'converge' sends a whole tile's corners (~1000 a pixel) into a
    few window slots, with integer values in [-2, 2], so that every
    product and sum is exact in fp32 and any order of the additions gives
    the plain version's result."""
    rng = np.random.default_rng(B * C + H + len(kind))
    vals = (rng.integers(-2, 3, (B, H, W, C)) if kind == "converge"
            else rng.standard_normal((B, H, W, C)))
    vals = torch.from_numpy(vals.astype(np.float32)).to(cuda_device)
    flow = _splat_flow(rng, kind, B, H, W).to(cuda_device)
    got = splat_sum(vals, flow)
    assert tuple(got.shape) == (B, H, W, C)
    # fp32 reductions add in a varying order
    torch.testing.assert_close(got, splat_sum_reference(vals, flow),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(19, 23), (256, 260)])
@pytest.mark.parametrize("C", [3, 4, 8, 161])
@pytest.mark.parametrize("vals_off,flow_off", [(1, 0), (0, 1), (2, 3)])
def test_splat_kernel_matches_plain_on_misaligned_inputs(cuda_device, C,
                                                         vals_off, flow_off,
                                                         H, W):
    """vals and flow contiguous but not 16- or 8-byte aligned (a view into
    a larger buffer): the kernels read them with scalar loads (the rows
    kernel at 2 x 19 x 23, the tile kernel at 32 x 256 x 260)."""
    rng = np.random.default_rng(C + 10 * vals_off + flow_off)
    B = 2 if H < 256 else 32
    vals = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32))
    flow = _splat_flow(rng, "wide", B, H, W)
    got = splat_sum(_misaligned(vals.to(cuda_device), vals_off),
                    _misaligned(flow.to(cuda_device), flow_off))
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


def _conv_args(device, B, H, W, C, O, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=device, generator=g) * scale

    return dict(
        x=randn(B, H, W, C).bfloat16(),
        scale=randn(B, C, scale=0.25) + 1.0,
        shift=randn(B, C),
        weight=randn(O, C, 3, 3, scale=(9 * C) ** -0.5).bfloat16(),
        bias=randn(O, scale=0.1).bfloat16(),
        residual=randn(B, H, W, O).bfloat16())


def _assert_conv_close(got, want):
    """bf16 outputs: one ulp of x is at most 2^-7 |x|.  The kernel rounds
    once (conv + bias + residual in fp32); the plain version rounds the
    conv, then the sum with the residual, and sums in another order (and
    for the upsample the kernel's collapsed taps are rounded to bf16 once
    more), so an element may differ by an ulp of itself plus one of the
    largest output.  The norm check catches a small fault that moves every
    element (a dropped tap, a wrong phase)."""
    got, want = got.float(), want.float()
    ulp = 2.0 ** -7
    torch.testing.assert_close(got, want, rtol=ulp,
                               atol=ulp * want.abs().max().item())
    assert (got - want).norm() <= 1e-2 * want.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,residual", [
    (2, 16, 16, 8, 3, False),     # C = 8 and the out-head's O = 3
    (1, 13, 21, 16, 24, True),    # H, W off the 8 x 16 tile; O off 16
    (2, 32, 48, 64, 128, True),
    (1, 9, 17, 128, 130, False),  # O one past a 128-channel tile
    (1, 16, 16, 512, 512, True),
    (1, 40, 40, 96, 130, True),   # C off the 64-channel chunk; 3 x 3 tiles
    (2, 24, 40, 8, 256, False),   # C = 8 on the Hopper loop; O = 2 tiles
    (1, 48, 16, 256, 256, True)])  # an odd tile count (3)
def test_gn_silu_conv3x3_kernel_matches_plain(cuda_device, B, H, W, C, O,
                                              residual):
    a = _conv_args(cuda_device, B, H, W, C, O, seed=B + H + C + O)
    res = a["residual"] if residual else None
    before = conv.gn_silu_conv3x3.launches
    got = conv.gn_silu_conv3x3(a["x"], a["scale"], a["shift"], a["weight"],
                               a["bias"], res)
    assert conv.gn_silu_conv3x3.launches == before + 1
    want = conv.gn_silu_conv3x3_ref(a["x"], a["scale"], a["shift"],
                                    a["weight"], a["bias"], res)
    assert got.shape == want.shape == (B, H, W, O)
    _assert_conv_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,prologue,residual", [
    (2, 13, 21, 8, 3, "gn", False),     # C = 8; H, W off the 12 x 16 tile
    (1, 25, 33, 40, 3, "gn", True),     # C = 40: part of a 64-channel chunk
    (2, 12, 16, 128, 1, "gn", True),    # exactly one tile; O = 1
    (1, 17, 40, 128, 8, "gn", False),   # O = 8: groups of 3, 3 and 2
    (1, 30, 18, 40, 8, "gn", True),
    (1, 5, 7, 128, 3, "gn", False),     # smaller than one tile
    (1, 40, 52, 200, 5, "gn", True),    # C = 200: 4 chunks, the ring wraps
    (2, 11, 9, 8, 1, "silu", False),
    (1, 26, 35, 40, 3, "silu", False),
    (1, 24, 48, 128, 8, "silu", False),
    (1, 512, 512, 128, 3, "gn", False)])  # the out-head's full width
def test_conv3x3_head_kernel_matches_plain(cuda_device, B, H, W, C, O,
                                           prologue, residual):
    """dc_conv3x3 where O <= 8: the project-then-stencil kernel, both
    prologues, with and without a residual."""
    a = _conv_args(cuda_device, B, H, W, C, O, seed=H * W + C + O)
    res = a["residual"] if residual else None
    before = (conv.projected_head.launches, conv.gn_silu_conv3x3.launches,
              conv.silu_conv3x3.launches)
    if prologue == "gn":
        args = (a["x"], a["scale"], a["shift"], a["weight"], a["bias"], res)
        got = conv.gn_silu_conv3x3(*args)
        want = conv.gn_silu_conv3x3_ref(*args)
        counted = (1, 1, 0)
    else:
        args = (a["x"], a["weight"], a["bias"])
        got = conv.silu_conv3x3(*args)
        want = conv.silu_conv3x3_ref(*args)
        counted = (1, 0, 1)
    assert (conv.projected_head.launches - before[0],
            conv.gn_silu_conv3x3.launches - before[1],
            conv.silu_conv3x3.launches - before[2]) == counted
    assert got.shape == want.shape == (B, H, W, O)
    _assert_conv_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,residual", [
    (2, 16, 24, 64, 9, False), (1, 13, 21, 40, 12, True),
    (1, 32, 32, 128, 16, True), (2, 9, 17, 8, 16, False)])
def test_conv3x3_between_8_and_16_runs_the_hopper_loop(cuda_device, B, H, W,
                                                       C, O, residual):
    """dc_conv3x3 at 8 < O <= 16: the Hopper loop, whose 128-column tile
    is masked on O."""
    a = _conv_args(cuda_device, B, H, W, C, O, seed=B + W + O)
    res = a["residual"] if residual else None
    args = (a["x"], a["scale"], a["shift"], a["weight"], a["bias"], res)
    before = conv.projected_head.launches
    got = conv.gn_silu_conv3x3(*args)
    assert conv.projected_head.launches == before
    _assert_conv_close(got, conv.gn_silu_conv3x3_ref(*args))
    got = conv.silu_conv3x3(*args[:1], *args[3:5])
    _assert_conv_close(got, conv.silu_conv3x3_ref(*args[:1], *args[3:5]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O", [(2, 50, 70, 40, 8),
                                       (1, 512, 512, 128, 3)])
def test_conv3x3_head_kernel_repeats_bitwise(cuda_device, B, H, W, C, O):
    """The head kernel sums in a fixed order (no atomics), so runs on the
    same inputs agree bit for bit; a difference is a race."""
    a = _conv_args(cuda_device, B, H, W, C, O, seed=C + O)
    args = (a["x"], a["scale"], a["shift"], a["weight"], a["bias"],
            a["residual"])
    first = conv.gn_silu_conv3x3(*args)
    for _ in range(3):
        assert torch.equal(conv.gn_silu_conv3x3(*args), first)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O", [(2, 16, 24, 32, 64),
                                       (1, 7, 9, 8, 3)])
def test_silu_conv3x3_kernel_matches_plain(cuda_device, B, H, W, C, O):
    a = _conv_args(cuda_device, B, H, W, C, O, seed=H + W + O)
    before = conv.silu_conv3x3.launches
    got = conv.silu_conv3x3(a["x"], a["weight"], a["bias"])
    assert conv.silu_conv3x3.launches == before + 1
    _assert_conv_close(got, conv.silu_conv3x3_ref(a["x"], a["weight"],
                                                  a["bias"]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O", [
    (2, 8, 8, 16, 16),       # O <= 16: the weight box zero-fills past O
    (1, 3, 4, 8, 3),
    (1, 5, 11, 32, 40),
    (1, 16, 16, 256, 256),
    (1, 13, 21, 40, 200),    # C = 40: a part of one 64-channel chunk;
                             # O = 200: a part of a 128-column tile; H, W
                             # off the 16 x 16 tile
    (2, 9, 17, 8, 24),       # C = 8; O = 24 (a part of a tile)
    (1, 7, 9, 24, 20),       # O % 8 != 0: the epilogue's pair stores
    (2, 50, 70, 96, 136),    # 320 tiles: more than the SMs; C = 96
    (1, 64, 64, 512, 512)])  # full width (a race showed only there)
def test_upsample_conv3x3_kernel_matches_plain(cuda_device, B, H, W, C, O):
    a = _conv_args(cuda_device, B, H, W, C, O, seed=H * W + O)
    before = conv.upsample_conv3x3.launches
    got = conv.upsample_conv3x3(a["x"], a["weight"], a["bias"])
    assert conv.upsample_conv3x3.launches == before + 1
    want = conv.upsample_conv3x3_ref(a["x"], a["weight"], a["bias"])
    assert got.shape == want.shape == (B, 2 * H, 2 * W, O)
    _assert_conv_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O", [(2, 50, 70, 96, 136),
                                       (1, 64, 64, 512, 512)])
def test_upsample_conv3x3_kernel_repeats_bitwise(cuda_device, B, H, W, C, O):
    """The upsample's Hopper loop sums in a fixed order (no atomics), so
    runs on the same inputs agree bit for bit; a difference is a race."""
    a = _conv_args(cuda_device, B, H, W, C, O, seed=B * C + O)
    first = conv.upsample_conv3x3(a["x"], a["weight"], a["bias"])
    for _ in range(3):
        again = conv.upsample_conv3x3(a["x"], a["weight"], a["bias"])
        assert torch.equal(again, first)


@pytest.mark.cuda
def test_conv_wrappers_reject_what_they_do_not_take(cuda_device):
    a = _conv_args(cuda_device, 1, 8, 8, 16, 16, seed=0)
    x, w, b = a["x"], a["weight"], a["bias"]
    affine = (a["scale"], a["shift"])
    with pytest.raises(TypeError):  # fp32 activations
        conv.gn_silu_conv3x3(x.float(), *affine, w, b)
    with pytest.raises(TypeError):
        conv.upsample_conv3x3(x, w.float(), b)
    with pytest.raises(ValueError):  # not contiguous
        conv.silu_conv3x3(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        conv.gn_silu_conv3x3(x, *affine, w, b,
                             a["residual"].transpose(1, 2))
    with pytest.raises(ValueError):  # weight on another device
        conv.upsample_conv3x3(x, w.cpu(), b)
    with pytest.raises(ValueError):
        conv.gn_silu_conv3x3(x, a["scale"].cpu(), a["shift"], w, b)
    odd = x[..., :12].contiguous()  # C % 8 != 0
    with pytest.raises(ValueError):
        conv.silu_conv3x3(odd, w[:, :12].contiguous(), b)


def _assert_grad_close(label, got, want):
    """A gradient of bf16 attention against autograd of the plain version:
    the kernels round P and dS to bf16 before their products, the plain
    version rounds P and dP, and each rounds its output once, so the
    difference is a sum of many bf16 roundings.  Over the whole tensor
    ||kernel - plain|| <= 1e-2 ||plain|| (the forward's form); elementwise
    2^-5 of the largest value and of itself, which a fault local to a row
    block or a column tile crosses."""
    got, want = got.float(), want.float()
    assert (got - want).norm() <= 1e-2 * want.norm(), label
    tol = 2.0 ** -5
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * want.abs().max().item(), msg=label)


def _attention_inputs(device, BH, Lq, Lk, D, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, dout = (torch.randn(BH, L, D, device=device, generator=g)
                     .bfloat16() for L in (Lq, Lk, Lk, Lq))
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Lq,Lk,D", [
    (4, 128, 128, 40), (4, 256, 77, 80), (4, 64, 64, 160),
    (3, 100, 77, 160), (2, 33, 5, 32), (2, 64, 300, 16), (3, 17, 130, 40),
    (64, 4096, 4096, 40)])
def test_attention_backward_kernels_match_plain(cuda_device, BH, Lq, Lk, D):
    """dQ, dK, dV of the backward kernel (one launch) against autograd of
    the plain version; Lk = 77, 5, 130 and 300 leave a masked tail in the
    last block of 128 keys, Lq = 100, 33 and 17 one in the last query
    tile."""
    q, k, v, dout = _attention_inputs(cuda_device, BH, Lq, Lk, D,
                                      seed=BH * Lq + D)
    scale = D ** -0.5
    out, lse = attention_forward(q, k, v, scale, with_lse=True)
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-4,
                               rtol=1e-5)
    del logits
    before = attention_bwd.launches
    got = attention_backward(q, k, v, out, lse, dout, scale)
    assert attention_bwd.launches == before + 1
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_reference(*leaves, scale), leaves,
                               dout)
    for name, g_, w_ in zip("qkv", got, want):
        assert g_.shape == w_.shape and g_.dtype == torch.bfloat16
        _assert_grad_close(f"d{name}", g_, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Lq,Lk,D", [
    (64, 4096, 4096, 40), (3, 100, 77, 160), (4, 256, 300, 80)])
def test_attention_backward_kernel_repeats(cuda_device, BH, Lq, Lk, D):
    """Two launches on the same inputs: dK and dV are written once, by the
    block that owns the keys, so they are bitwise equal; dQ is summed over
    key blocks by bulk reductions in an order that varies, so it may differ
    in its last fp32 bits and then by one bf16 rounding: at most one bf16
    ulp (2^-7 relative) of the largest |dQ|."""
    q, k, v, dout = _attention_inputs(cuda_device, BH, Lq, Lk, D, seed=Lq)
    scale = D ** -0.5
    out, lse = attention_forward(q, k, v, scale, with_lse=True)
    before = attention_bwd.launches
    dq1, dk1, dv1 = attention_bwd(q, k, v, out, dout, lse, scale)
    dq2, dk2, dv2 = attention_bwd(q, k, v, out, dout, lse, scale)
    assert attention_bwd.launches == before + 2
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    ulp = 2.0 ** -7 * dq1.float().abs().max().item()
    assert (dq1.float() - dq2.float()).abs().max().item() <= ulp


@pytest.mark.cuda
def test_attention_backward_kernels_reject_what_they_do_not_take(
        cuda_device):
    q, k, v, dout = _attention_inputs(cuda_device, 2, 16, 16, 40, seed=0)
    out = torch.zeros_like(q)
    lse = torch.zeros(2, 16, device=cuda_device)
    before = attention_bwd.launches
    with pytest.raises(TypeError):  # bf16 lse
        attention_bwd(q, k, v, out, dout, lse.bfloat16(), 0.1)
    with pytest.raises(ValueError):  # lse of the wrong length
        attention_bwd(q, k, v, out, dout, lse[:, :8].contiguous(), 0.1)
    with pytest.raises(TypeError):  # fp32 out
        attention_bwd(q, k, v, out.float(), dout, lse, 0.1)
    with pytest.raises(ValueError):  # dout not contiguous
        attention_bwd(q, k, v, out, dout.transpose(0, 1).contiguous()
                      .transpose(0, 1), lse, 0.1)
    for d in (12, 64):  # widths the kernel is not built for
        x = torch.zeros(2, 16, d, device=cuda_device, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            attention_bwd(x, x, x, x, x, lse, 0.1)
    with pytest.raises(ValueError):  # CPU tensors: the kernel runs on cards
        attention_bwd(*(t.cpu() for t in (q, k, v, out, dout, lse)), 0.1)
    assert attention_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("asymmetric_pad", [True, False])
@pytest.mark.parametrize("B,H,W,C,O", [
    (2, 16, 32, 16, 16),        # one 8 x 16 output tile per image
    (1, 13, 21, 8, 3),          # odd H, W: off the tile; narrow O
    (1, 34, 66, 32, 130),       # O one past a 128-channel tile
    (2, 64, 64, 128, 128),
    (1, 45, 31, 96, 256),       # odd H, W; C off the chunk; 3 tiles
    (2, 47, 33, 8, 130),        # odd H, W; C = 8; O one past a tile
    (1, 2, 2, 16, 24)])         # the smallest input it takes
def test_downsample_conv3x3_kernel_matches_plain(cuda_device, B, H, W, C, O,
                                                 asymmetric_pad):
    a = _conv_args(cuda_device, B, H, W, C, O, seed=H + W + C)
    before = conv.downsample_conv3x3.launches
    got = conv.downsample_conv3x3(a["x"], a["weight"], a["bias"],
                                  asymmetric_pad)
    assert conv.downsample_conv3x3.launches == before + 1
    want = conv.downsample_conv3x3_ref(a["x"], a["weight"], a["bias"],
                                       asymmetric_pad)
    pad = 0 if asymmetric_pad else 1
    assert got.shape == want.shape == (B, (H + pad - 2) // 2 + 1,
                                       (W + pad - 2) // 2 + 1, O)
    _assert_conv_close(got, want)


def _grads(fn, *args):
    """Gradients of sum(fn(*args) * cotangent) for the float tensors among
    args, with a fixed seeded cotangent."""
    leaves = [a.detach().requires_grad_() if a is not None
              and a.is_floating_point() else a for a in args]
    out = fn(*leaves)
    g = torch.Generator(device=out.device).manual_seed(1)
    ct = torch.randn(out.shape, device=out.device, generator=g).to(out.dtype)
    wanted = [a for a in leaves if a is not None and a.requires_grad]
    return torch.autograd.grad(out, wanted, ct)


@pytest.mark.cuda
def test_attention_gradient_through_autograd_matches_plain(cuda_device):
    q, k, v, _ = _attention_inputs(cuda_device, 4, 96, 77, 80, seed=5)
    before = attention.launches
    got = _grads(lambda *t: attention(*t, 80 ** -0.5), q, k, v)
    assert attention.launches == before + 1
    want = _grads(lambda *t: attention_reference(*t, 80 ** -0.5), q, k, v)
    for name, g_, w_ in zip("qkv", got, want):
        _assert_grad_close(f"d{name}", g_, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["splat", "gn", "gn_res", "silu", "up",
                                   "down", "down_sym"])
def test_kernel_wrapper_gradients_match_plain(cuda_device, which):
    """The kernel wrappers' backward is autograd of their plain versions on
    the same inputs: the same functions on the same device, so they agree
    to the plain version's own run-to-run spread (atomics in the splat's
    index_add_, cuDNN's choice of algorithm)."""
    a = _conv_args(cuda_device, 2, 12, 10, 16, 24, seed=3)
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.standard_normal((2, 9, 11, 5)).astype(
        np.float32)).to(cuda_device)
    flow = _flow(rng, 2, 9, 11).to(cuda_device)
    flow = torch.nan_to_num(flow, nan=0.0, posinf=30.0)
    x, sc, sh, w, b, res = (a[n] for n in ("x", "scale", "shift", "weight",
                                           "bias", "residual"))
    cases = {
        "splat": (splat_sum, splat_sum_reference, (vals, flow)),
        "gn": (conv.gn_silu_conv3x3, conv.gn_silu_conv3x3_ref,
               (x, sc, sh, w, b, None)),
        "gn_res": (conv.gn_silu_conv3x3, conv.gn_silu_conv3x3_ref,
                   (x, sc, sh, w, b, res)),
        "silu": (conv.silu_conv3x3, conv.silu_conv3x3_ref, (x, w, b)),
        "up": (conv.upsample_conv3x3, conv.upsample_conv3x3_ref, (x, w, b)),
        "down": (conv.downsample_conv3x3, conv.downsample_conv3x3_ref,
                 (x, w, b)),
        "down_sym": (lambda *t: conv.downsample_conv3x3(*t, False),
                     lambda *t: conv.downsample_conv3x3_ref(*t, False),
                     (x, w, b)),
    }
    fast, plain, args = cases[which]
    got = _grads(fast, *args)
    want = _grads(plain, *args)
    assert len(got) == len(want) > 0
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_.float(), w_.float(), atol=1e-5,
                                   rtol=1e-3)


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


def test_build_directory_follows_the_sources(tmp_path, monkeypatch):
    lib = _kernels._Library()
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    d1 = lib._digest([str(a), str(b)])
    assert d1 == lib._digest([str(a), str(b)])
    b.write_text("// two, edited\n")
    assert lib._digest([str(a), str(b)]) != d1
    assert os.path.basename(_kernels.CSRC_DIR) == "csrc"
    # a header the sources include is hashed too: editing it builds anew
    h = tmp_path / "shared.cuh"
    h.write_text("// shared\n")
    (tmp_path / "notes.txt").write_text("not a source\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(tmp_path))
    assert lib.sources() == [str(a), str(b), str(h)]
    d2 = lib._digest(lib.sources())
    h.write_text("// shared, edited\n")
    assert lib._digest(lib.sources()) != d2


def test_build_compiles_the_sources_and_not_the_headers(monkeypatch,
                                                        tmp_path):
    """nvcc gets every .cu of csrc/ and no .cuh (those are included)."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    args = tmp_path / "args.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" > {args}\nexit 3\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_kernels, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(_kernels.KernelBuildError):
        _kernels._Library().get()
    passed = args.read_text().split()
    names = {os.path.basename(a) for a in passed}
    assert {"attention.cu", "conv3x3.cu", "splat.cu"} <= names
    assert not any(a.endswith(".cuh") for a in passed)
    assert "hopper.cuh" in {os.path.basename(s)
                            for s in _kernels._Library().sources()}


def _csrc(name):
    with open(os.path.join(_kernels.CSRC_DIR, name)) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(conv_kernel_breakdown.BUILDS))
def test_conv_breakdown_edits_match_the_source(name):
    """Each build of the conv breakdown edits text that occurs exactly once
    in the current conv3x3.cu, and changes it (but the unedited one)."""
    src = _csrc("conv3x3.cu")
    edits = conv_kernel_breakdown.BUILDS[name][0]
    got = conv_kernel_breakdown.edited(src, edits, name)
    assert (got == src) == (not edits)


@pytest.mark.parametrize("name", sorted(attention_bwd_ab.ABLATIONS))
def test_attention_ablation_edits_match_the_source(name):
    """Each ablated build of the attention backward, with its one head
    width, edits text that occurs exactly once in the current
    attention.cu."""
    src = _csrc("attention.cu")
    edits = (attention_bwd_ab.ABLATIONS[name]
             + attention_bwd_ab.one_width(40))
    got = conv_kernel_breakdown.edited(src, edits, name)
    assert got != src and "if constexpr (8 * decltype(d8)::value != 40)" in got


@pytest.mark.parametrize("name", sorted({**attention_fwd_ab.ABLATIONS,
                                          **attention_fwd_ab.CHOICES}))
def test_attention_fwd_ablation_edits_match_the_source(name):
    """Each ablated build of the attention forward, and each with a design
    choice undone, with its one head width (forward and backward), edits
    text that occurs exactly once in the current attention.cu."""
    src = _csrc("attention.cu")
    edits = {**attention_fwd_ab.ABLATIONS, **attention_fwd_ab.CHOICES}[name]
    got = conv_kernel_breakdown.edited(
        src, edits + attention_fwd_ab.one_width(40), name)
    assert got != src
    assert got.count("if constexpr (8 * decltype(d8)::value != 40)") == 2


@pytest.mark.parametrize("name", sorted(splat_kernel_ab.ABLATIONS))
def test_splat_ablation_edits_match_the_source(name):
    """Each ablated build of the splat edits text that occurs exactly once
    in the current splat.cu."""
    src = _csrc("splat.cu")
    edits = splat_kernel_ab.ABLATIONS[name][0]
    assert conv_kernel_breakdown.edited(src, edits, name) != src


def test_source_edits_refuse_text_that_is_not_there_once():
    edit = conv_kernel_breakdown.edited
    assert edit("a b c", [("b", "x"), ("x c", "y")], "t") == "a y"
    with pytest.raises(RuntimeError, match="0 copies"):
        edit("a b c", [("d", "x")], "t")
    with pytest.raises(RuntimeError, match="2 copies"):
        edit("a b b", [("b", "x")], "t")
