"""The splat below 16 channels and the residue transform that batches its
splats, against the JAX package on the CPU.

On the card the splat's small-channel kernel pads 3-channel rows to 4
floats and returns the view of the first 3 (`ops/softsplat.py::
_splat_sum_fast`); on the CPU `splat_sum` is its plain version, so these
tests hold what the card's path is held to there (`tests/
test_torch_port_kernels.py`, marked `cuda`): the plain version at every
stacked width the small kernel takes on the paths (2, 3 and 4: one value
or a flow, or RGB, beside the metric), every mode of `softsplat`, flows
with NaN, infinite, off-frame and -1e9 rows.  Then `warp_and_fuse` and
`make_residue_batch`, which warp both anchors in one splat and run both
occlusion checks in one call, against JAX's four splats at two sizes, and
against the port's own one-direction-at-a-time form bit for bit.

    python -m pytest tests/test_torch_port_splat_small.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu.ops import softsplat as jsplat
from diffcodec_tpu.ops.softsplat_pallas import splat_sum_pallas
from diffcodec_tpu.train import residue as jres

from diffcodec_tpu_torch.ops import softsplat as tsplat
from diffcodec_tpu_torch.ops.flow import compute_occlusion_mask
from diffcodec_tpu_torch.train import residue as tres
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

# fp32 on both sides, sums in another order (index_add_ against JAX's
# scatter or one-hot matmuls): a few ulps of the largest terms, as
# tests/test_torch_port_ops.py and test_torch_port_residual.py hold them
OP_TOL = dict(atol=2e-5, rtol=1e-4)
MODES = ["sum", "avg", "linear", "soft", "linear-addeps", "linear-zeroeps",
         "linear-clipeps", "soft-addeps", "soft-zeroeps", "soft-clipeps"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _flow(rng, B, H, W, scale=3.0):
    """Flow of `scale` N(0, 1) pixels with a NaN, an infinite, an
    off-frame column and a -1e9 row."""
    f = (rng.standard_normal((B, H, W, 2)) * scale).astype(np.float32)
    f[0, 1, 2, 0] = np.nan
    f[-1, 0, 0, 1] = np.inf
    f[:, :, -1, 0] = W + 3.0
    f[-1, 2, :, 1] = -1e9
    return f


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("width", [2, 3, 4])
def test_softsplat_at_small_stacked_widths_matches_jax(mode, width):
    """The splat's rows are `width` wide: vals of width - 1 channels beside
    the metric (or the ones of 'avg'), or `width` channels in 'sum'."""
    rng = np.random.default_rng(10 * width + MODES.index(mode))
    B, H, W = 3, 11, 13
    C = width if mode == "sum" else width - 1
    vals = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = _flow(rng, B, H, W)
    # 'linear' divides by the splatted metric itself: a weight, positive
    # (a signed N(0, 1) metric sums to ~0 at some pixels, where the
    # quotient turns the two sums' rounding into any error at all)
    metric = {"linear": rng.uniform(0.25, 2.0, (B, H, W, 1)),
              "soft": rng.standard_normal((B, H, W, 1))}.get(
                  mode.split("-")[0])
    metric = None if metric is None else metric.astype(np.float32)
    want = np.asarray(jsplat.softsplat(
        jnp.asarray(vals), jnp.asarray(flow),
        None if metric is None else jnp.asarray(metric), mode))
    got = tsplat.softsplat(_t(vals), _t(flow),
                           None if metric is None else _t(metric), mode)
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)


@pytest.mark.parametrize("C", [1, 2, 3, 4, 7, 15])
def test_splat_sum_below_16_channels_matches_pallas_interpret(C):
    """The 'sum' core at the small kernel's widths against the TPU
    kernel it replaces, in interpret mode."""
    rng = np.random.default_rng(C)
    vals = rng.standard_normal((2, 9, 10, C)).astype(np.float32)
    flow = _flow(rng, 2, 9, 10)
    want = np.asarray(splat_sum_pallas(jnp.asarray(vals), jnp.asarray(flow),
                                       interpret=True))
    got = tsplat.splat_sum(_t(vals), _t(flow))
    np.testing.assert_allclose(got.numpy(), want, **OP_TOL)


def test_softsplat_soft_gradient_at_width_3_matches_jax():
    """The occlusion check's splat (a flow beside its metric): gradients
    in vals, flow and metric against jax.vjp (the wrapper's backward is
    autograd of the plain version)."""
    rng = np.random.default_rng(5)
    B, H, W = 2, 8, 9
    vals = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * 2).astype(np.float32)
    flow[:, :, -1, 0] = W + 3.0
    metric = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    cot = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda v, f, m: jsplat.softsplat(v, f, m, "soft"),
                     *map(jnp.asarray, (vals, flow, metric)))
    want = vjp(jnp.asarray(cot))
    leaves = [_t(a).requires_grad_() for a in (vals, flow, metric)]
    out = tsplat.softsplat(*leaves, "soft")
    got = torch.autograd.grad(out, leaves, _t(cot))
    for g, w, name in zip(got, want, ("vals", "flow", "metric")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   atol=1e-4, rtol=1e-4)


def _pair(seed, B, H, W, scale):
    """Two anchors and two flows of `scale` N(0, 1) pixels, a column of
    each off the frame.  Finite: the occlusion checks splat the flows as
    values, and JAX's one-hot form spreads a non-finite value (or loses
    the small ones beside -1e9) over the whole image."""
    rng = np.random.default_rng(seed)
    imgs = [rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
            for _ in range(2)]
    flows = [(rng.standard_normal((B, H, W, 2)) * scale).astype(np.float32)
             for _ in range(2)]
    for f in flows:
        f[:, :, -1, 0] = W + 3.0
    return imgs + flows


@pytest.mark.parametrize("B,H,W", [(2, 24, 32), (3, 40, 36)])
def test_batched_warp_and_fuse_matches_jax(B, H, W):
    args = _pair(B * H, B, H, W, 3.0)
    want = jres.warp_and_fuse(*map(jnp.asarray, args))
    got = tres.warp_and_fuse(*map(_t, args))
    for g, w, name in zip(got, want, ("fused", "occ1", "occ2")):
        assert g.shape == (B, H, W, 3 if name == "fused" else 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **OP_TOL)
    assert 0 < float(got[1].mean()) < 1 and 0 < float(got[2].mean()) < 1


@pytest.mark.parametrize("B,H,W", [(2, 24, 32), (3, 40, 36)])
def test_batched_warp_and_fuse_is_the_one_direction_form(B, H, W):
    """Both directions in one splat give each sample's splat on its own:
    the warps and the occlusion masks equal, bit for bit, those of one
    direction at a time, as the JAX package computes them."""
    img1, img2, flow1, flow2 = map(_t, _pair(B + H, B, H, W, 2.0))
    fused, occ1, occ2 = tres.warp_and_fuse(img1, img2, flow1, flow2)
    ones = torch.ones(B, H, W, 1)
    warped1 = tsplat.softsplat(img1, flow1, ones, "soft")
    warped2 = tsplat.softsplat(img2, flow2, ones, "soft")
    assert torch.equal(occ1, compute_occlusion_mask(flow2, flow1))
    assert torch.equal(occ2, compute_occlusion_mask(flow1, flow2))
    w1, w2 = 1.0 - occ1, 1.0 - occ2
    denom = w1 + w2
    want = torch.where(denom > 1e-6,
                       (w1 * warped1 + w2 * warped2) / denom.clamp_min(1e-6),
                       0.5 * (warped1 + warped2))
    assert torch.equal(fused, want)


@pytest.mark.parametrize("B,R,scale", [(2, 32, 3.0), (4, 48, 0.5)])
def test_batched_make_residue_batch_matches_jax(B, R, scale):
    rng = np.random.default_rng(B * R)
    batch = dict(image=rng.uniform(-1, 1, (B, R, R, 3)).astype(np.float32),
                 cond=rng.uniform(0, 1, (B, R, R, 6)).astype(np.float32),
                 flow=(rng.standard_normal((B, R, R, 4)) * scale).astype(
                     np.float32))
    want = jres.make_residue_batch({k: jnp.asarray(v)
                                    for k, v in batch.items()})
    got = tres.make_residue_batch({k: _t(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in ("warped", "residual"):
        assert got[k].shape == (B, R, R, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **OP_TOL)
