"""The port's ops (diffcodec_tpu_torch.ops, FreeU, UniPC) against the JAX
package on the CPU.

Inputs are made with numpy from a seed and fed to both sides.  On the CPU
the port's kernel wrappers run their plain PyTorch versions; where the JAX
function reaches a Pallas kernel it runs in interpret mode.  All math is
fp32, so the tolerances only allow for a different order of summation.
The CUDA kernels are held against their plain versions on the card in
`test_torch_port_kernels.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu.models import layers as jlayers
from diffcodec_tpu.models import unet2d_condition as junet
from diffcodec_tpu.ops import conv_pallas as jconv
from diffcodec_tpu.ops import flow as jflow
from diffcodec_tpu.ops import packed_conv as jpacked
from diffcodec_tpu.ops import softsplat as jsplat
from diffcodec_tpu.ops.attention import fused_attention
from diffcodec_tpu.ops.softsplat_pallas import splat_sum_pallas
from diffcodec_tpu.config import SchedulerConfig as JSchedulerConfig
from diffcodec_tpu.sampling import schedulers as jsched

from diffcodec_tpu_torch.config import SchedulerConfig
from diffcodec_tpu_torch.models import layers as tlayers
from diffcodec_tpu_torch.models import unet2d_condition as tunet
from diffcodec_tpu_torch.ops import conv as tconv
from diffcodec_tpu_torch.ops import flow as tflow
from diffcodec_tpu_torch.ops import softsplat as tsplat
from diffcodec_tpu_torch.ops.attention import attention, attention_reference
from diffcodec_tpu_torch.sampling import schedulers as tsched
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

# fp32 on both sides; the sums run in another order (index_add_ against
# one-hot matmuls, einsum contraction order), so allow a few ulps of the
# largest terms
ATOL, RTOL = 2e-5, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _flow(rng, B, H, W, scale=2.5):
    """Random flow with a NaN pixel, an inf pixel and a column that lands
    out of frame."""
    f = (rng.standard_normal((B, H, W, 2)) * scale).astype(np.float32)
    f[0, 1, 2, 0] = np.nan
    f[-1, 0, 0, 1] = np.inf
    f[:, :, -1, 0] = W + 3.0
    return f


SPLAT_MODES = ["sum", "avg", "linear", "soft", "linear-addeps",
               "linear-zeroeps", "linear-clipeps", "soft-addeps",
               "soft-zeroeps", "soft-clipeps"]


@pytest.mark.parametrize("mode", SPLAT_MODES)
def test_softsplat_matches_jax_auto(mode):
    rng = np.random.default_rng(0)
    B, H, W, C = 2, 7, 9, 3
    vals = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = _flow(rng, B, H, W)
    base = mode.split("-")[0]
    metric = (rng.standard_normal((B, H, W, 1)).astype(np.float32)
              if base in ("linear", "soft") else None)
    want = np.asarray(jsplat.softsplat(
        jnp.asarray(vals), jnp.asarray(flow),
        None if metric is None else jnp.asarray(metric), mode, impl="auto"))
    got = tsplat.softsplat(_t(vals), _t(flow),
                           None if metric is None else _t(metric), mode)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_splat_sum_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((2, 6, 8, 5)).astype(np.float32)
    flow = _flow(rng, 2, 6, 8)
    want = np.asarray(splat_sum_pallas(jnp.asarray(vals), jnp.asarray(flow),
                                       interpret=True))
    got = tsplat.splat_sum(_t(vals), _t(flow))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_splat_sum_wrapper_takes_plain_version_on_cpu_only():
    rng = np.random.default_rng(2)
    vals = _t(rng.standard_normal((1, 4, 4, 2)).astype(np.float32))
    flow = _t(_flow(rng, 1, 4, 4))
    before = tsplat.splat_sum.launches
    torch.testing.assert_close(tsplat.splat_sum(vals, flow),
                               tsplat.splat_sum_reference(vals, flow))
    assert tsplat.splat_sum.launches == before
    with pytest.raises(ValueError):
        tsplat.splat_sum(vals.to("meta"), flow.to("meta"))


def test_backward_warp_matches_jax():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 6, 7, 2)) * 2).astype(np.float32)
    want = np.asarray(jsplat.backward_warp(jnp.asarray(vals),
                                           jnp.asarray(flow)))
    got = tsplat.backward_warp(_t(vals), _t(flow))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("fn,shape", [
    ("resize_bilinear", (8, 12)), ("resize_bilinear_ac", (8, 12)),
    ("resize_and_normalize_flow", (4, 4)),
    ("resize_flow_by_factor", (4, 4)), ("resize_flow_pixel_units", (8, 6))])
def test_flow_resize_conventions_match_jax(fn, shape):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 16, 12, 2)) * 3).astype(np.float32)
    if fn == "resize_bilinear_ac":
        want = jflow.resize_bilinear(jnp.asarray(x), *shape,
                                     align_corners=True)
        got = tflow.resize_bilinear(_t(x), *shape, align_corners=True)
    else:
        want = getattr(jflow, fn)(jnp.asarray(x), *shape)
        got = getattr(tflow, fn)(_t(x), *shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_occlusion_mask_and_soft_fuse_match_jax():
    rng = np.random.default_rng(5)
    B, H, W, C = 2, 8, 8, 4
    fwd = (rng.standard_normal((B, H, W, 2)) * 1.5).astype(np.float32)
    bwd = (-fwd + rng.standard_normal((B, H, W, 2)) * 0.4).astype(np.float32)
    occ_j = np.asarray(jflow.compute_occlusion_mask(jnp.asarray(bwd),
                                                    jnp.asarray(fwd)))
    occ_t = tflow.compute_occlusion_mask(_t(bwd), _t(fwd)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)
    assert 0 < occ_t.sum() < occ_t.size  # both classes present

    wa, wb = (rng.standard_normal((B, H, W, C)).astype(np.float32)
              for _ in range(2))
    ca, cb = (rng.standard_normal((B, H, W, 1)).astype(np.float32)
              for _ in range(2))
    oa = (rng.random((B, H, W, 1)) > 0.5).astype(np.float32)
    ob = (rng.random((B, H, W, 1)) > 0.5).astype(np.float32)
    want = np.asarray(jflow.soft_fuse(*map(jnp.asarray,
                                           (wa, wb, ca, cb, oa, ob))))
    got = tflow.soft_fuse(*map(_t, (wa, wb, ca, cb, oa, ob))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# D as on the main path (40, 80, 160) at short lengths; Lk = 77 is the text
# context of the cross-attention
ATTN_SHAPES = [(2, 2, 64, 64, 40), (1, 2, 32, 32, 80), (1, 2, 16, 16, 160),
               (2, 2, 64, 77, 40), (1, 2, 16, 77, 160)]


@pytest.mark.parametrize("B,H,Lq,Lk,D", ATTN_SHAPES)
def test_attention_matches_fused_attention_interpret(B, H, Lq, Lk, D):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Lk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Lk, H, D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), scale, interpret=True))

    def fold(a):  # [B, L, H, D] -> [B*H, L, D]
        return _t(a.transpose(0, 2, 1, 3).reshape(B * H, -1, D))

    got = attention(fold(q), fold(k), fold(v), scale).numpy()
    got = got.reshape(B, H, Lq, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("heads,dim_head,Lk", [(2, 40, None), (2, 80, None),
                                               (1, 160, None), (2, 40, 77),
                                               (2, 80, 77)])
def test_attention_module_matches_jax(heads, dim_head, Lk):
    """The JAX `Attention` module and the port's, self and cross, with the
    same weights."""
    rng = np.random.default_rng(7)
    B, L, dim, ctx_dim = 2, 48, 64, 24
    x = rng.standard_normal((B, L, dim)).astype(np.float32)
    ctx = (None if Lk is None
           else rng.standard_normal((B, Lk, ctx_dim)).astype(np.float32))
    jmod = jlayers.Attention(heads, dim_head)
    jargs = (jnp.asarray(x),) if ctx is None else (jnp.asarray(x),
                                                   jnp.asarray(ctx))
    params = jmod.init(jax.random.PRNGKey(0), *jargs)
    params = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                              / np.sqrt(p.shape[0])), params)
    want = np.asarray(jmod.apply(params, *jargs))

    tmod = tlayers.Attention(dim, heads, dim_head,
                             context_dim=None if ctx is None else ctx_dim)
    p = params["params"]
    sd = {f"{n}.weight": _t(np.asarray(p[n]["kernel"]).T)
          for n in ("to_q", "to_k", "to_v")}
    sd["to_out.0.weight"] = _t(np.asarray(p["to_out"]["kernel"]).T)
    sd["to_out.0.bias"] = _t(np.asarray(p["to_out"]["bias"]))
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tmod(_t(x), None if ctx is None else _t(ctx)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_attention_wrapper_takes_plain_version_on_cpu_only():
    rng = np.random.default_rng(8)
    q = _t(rng.standard_normal((2, 8, 16)).astype(np.float32))
    before = attention.launches
    torch.testing.assert_close(attention(q, q, q, 0.25),
                               attention_reference(q, q, q, 0.25))
    assert attention.launches == before
    with pytest.raises(ValueError):
        attention(q.to("meta"), q.to("meta"), q.to("meta"), 0.25)


@pytest.mark.parametrize("H,W,scale", [(8, 8, 0.9), (16, 12, 0.2),
                                       (7, 9, 0.5)])
def test_fourier_filter_matches_both_jax_forms(H, W, scale):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    got = tunet.fourier_filter(_t(x), 1, scale).numpy()
    for ref in (junet.fourier_filter, junet._fourier_filter_fft):
        want = np.asarray(ref(jnp.asarray(x), 1, scale))
        # the box-projector and FFT forms agree to ~1e-5 in fp32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_apply_freeu_matches_jax(idx):
    rng = np.random.default_rng(10)
    h = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    r = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    knobs = (0.9, 0.2, 1.2, 1.4)
    jh, jr = junet.apply_freeu(idx, jnp.asarray(h), jnp.asarray(r), *knobs)
    th, tr = tunet.apply_freeu(idx, _t(h), _t(r), *knobs)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("steps", [2, 3, 30])
def test_unipc_tables_match_jax(steps):
    jt = jsched.UniPC(jsched.NoiseSchedule.create(JSchedulerConfig()),
                      steps).tables()
    tt = tsched.UniPC(tsched.NoiseSchedule.create(SchedulerConfig()),
                      steps).tables()
    for name in tt._fields:
        want = np.asarray(getattr(jt, name))
        got = getattr(tt, name)
        assert got.dtype == (np.int64 if name == "timesteps"
                             else np.float32), name
        np.testing.assert_array_equal(got, want.astype(got.dtype), name)


def test_unipc_steps_match_jax():
    """Eight UniPC steps on the same model outputs, both sides carrying
    their own state."""
    n = 8
    rng = np.random.default_rng(11)
    x0 = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    outs = [rng.standard_normal(x0.shape).astype(np.float32)
            for _ in range(n)]
    ju = jsched.UniPC(jsched.NoiseSchedule.create(JSchedulerConfig()), n)
    tu = tsched.UniPC(tsched.NoiseSchedule.create(SchedulerConfig()), n)
    jt, tt = ju.tables(), tu.tables()
    js, ts = ju.init_state(jnp.asarray(x0)), tu.init_state(_t(x0))
    for i in range(n):
        js = ju.step(jt, js, jnp.asarray(outs[i]), i)
        ts = tu.step(tt, ts, _t(outs[i]), i)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
    keep_j = jsched.controlnet_keep_schedule(10, 0.1, 0.8)
    np.testing.assert_array_equal(
        tsched.controlnet_keep_schedule(10, 0.1, 0.8), keep_j)


def test_conv_plain_math_matches_jax():
    rng = np.random.default_rng(12)
    B, H, W, C, O = 2, 8, 8, 6, 5
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    k = (rng.standard_normal((3, 3, C, O)) * 0.3).astype(np.float32)
    b = rng.standard_normal((O,)).astype(np.float32)
    scale = rng.standard_normal((B, C)).astype(np.float32)
    shift = rng.standard_normal((B, C)).astype(np.float32)
    res = rng.standard_normal((B, H, W, O)).astype(np.float32)
    oihw = _t(k.transpose(3, 2, 0, 1))
    np.testing.assert_allclose(
        tconv.silu_conv3x3(_t(x), oihw, _t(b)).numpy(),
        np.asarray(jconv.silu_conv3x3_ref(jnp.asarray(x), jnp.asarray(k),
                                          jnp.asarray(b))),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tconv.gn_silu_conv3x3_ref(_t(x), _t(scale), _t(shift), oihw, _t(b),
                                  _t(res)).numpy(),
        np.asarray(jconv.gn_silu_conv3x3_ref(
            *map(jnp.asarray, (x, scale, shift, k, b, res)))),
        atol=ATOL, rtol=RTOL)
    ks = [(rng.standard_normal((3, 3, ci, co)) * 0.3).astype(np.float32)
          for ci, co in ((C, 4), (4, 7))]
    bs = [rng.standard_normal((co,)).astype(np.float32) for co in (4, 7)]
    np.testing.assert_allclose(
        tconv.conv_silu_chain(_t(x), [_t(a.transpose(3, 2, 0, 1))
                                      for a in ks],
                              list(map(_t, bs)), (2, 1)).numpy(),
        np.asarray(jpacked.reference_chain(jnp.asarray(x),
                                           list(map(jnp.asarray, ks)),
                                           list(map(jnp.asarray, bs)),
                                           (2, 1))),
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("C", [64, 12])
def test_group_norm_and_affine_match_jax(C):
    """GroupNorm32 (groups halved for narrow widths) and its folded
    affine, against the JAX module."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((2, 4, 4, C)) * 2 + 0.5).astype(np.float32)
    jmod = jlayers.GroupNorm32(32, 1e-6)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = params["params"]["norm"]
    p["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, C).astype(np.float32))
    p["bias"] = jnp.asarray(rng.standard_normal(C).astype(np.float32))
    tmod = tlayers.GroupNorm32(C, 1e-6)
    tmod.load_state_dict({"weight": _t(np.asarray(p["scale"])),
                          "bias": _t(np.asarray(p["bias"]))})
    with torch.no_grad():
        np.testing.assert_allclose(
            tmod(_t(x)).numpy(), np.asarray(jmod.apply(params,
                                                       jnp.asarray(x))),
            atol=1e-5, rtol=1e-5)
        sc, sh = tmod.affine(_t(x))
    jsc, jsh = jmod.apply(params, jnp.asarray(x), return_affine=True)
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jsh), rtol=1e-5,
                               atol=1e-5)
