"""The port's VAE encoder and stride-2 conv against the JAX package, on the
CPU.

The plain stride-2 conv behind `ops.conv.downsample_conv3x3` is held
against the JAX package's Pallas kernel in interpret mode and its XLA
reference, in fp32 and bf16; `Downsample2D` with both paddings, the
`Encoder`, `AutoencoderKL.encode` and `encode_to_latents` against their JAX
modules on the same randomised weights, through the port's weight bridge.
Inputs come from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models import layers as jlayers
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.models.vae import encode_to_latents as j_encode
from diffcodec_tpu.ops import conv_pallas as jconv

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models import layers as tlayers
from diffcodec_tpu_torch.models.vae import AutoencoderKL, encode_to_latents
from diffcodec_tpu_torch.ops import conv as tconv
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

# the Pallas kernel against plain convs in fp32 (JAX's own limits,
# tests/test_conv_pallas.py): the same sums in another order
KERNEL_TOL = dict(atol=2e-5, rtol=1e-5)
# fp32 through whole modules: convs and GroupNorm statistics accumulate in
# another order in XLA and in PyTorch's CPU kernels
MODULE_TOL = dict(atol=1e-4, rtol=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(k):
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _down_inputs(seed, B=2, H=16, W=16, C=8, O=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32),
            (rng.standard_normal((3, 3, C, O)) * 0.2).astype(np.float32),
            (rng.standard_normal(O) * 0.1).astype(np.float32))


@pytest.mark.parametrize("asymmetric_pad", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_downsample_conv3x3_plain_matches_pallas_interpret(asymmetric_pad,
                                                           dtype):
    x, k, b = _down_inputs(0)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jx, jk, jb = (jnp.asarray(a).astype(jdt) for a in (x, k, b))
    kernel = jconv.downsample_conv3x3_pallas(
        jx, jk, jb, asymmetric_pad=asymmetric_pad, th=8, interpret=True)
    ref = jconv.downsample_conv3x3_ref(jx, jk, jb, asymmetric_pad)
    before = tconv.downsample_conv3x3.launches
    got = tconv.downsample_conv3x3(_t(x).to(tdt), _oihw(k).to(tdt),
                                   _t(b).to(tdt), asymmetric_pad)
    assert tconv.downsample_conv3x3.launches == before  # CPU: plain
    assert got.shape == (2, 8, 8, 8) and got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        tol = KERNEL_TOL
    else:
        # bf16 outputs (one ulp is 2^-7 of the value at most): the kernel
        # and the two plain convs add the bias and round at other points
        m = float(np.abs(np.asarray(ref, np.float32)).max())
        tol = dict(atol=2 * 2.0 ** -8 * m, rtol=2.0 ** -7)
    for want in (kernel, ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("H,W", [(16, 16), (9, 13)])
@pytest.mark.parametrize("asymmetric_pad", [True, False])
def test_downsample2d_matches_jax(asymmetric_pad, H, W):
    """Both paddings, on even and odd sizes (where the two conventions
    give different output sizes too); fused_conv (the plain version on the
    CPU) and not."""
    x, k, b = _down_inputs(1, H=H, W=W)
    jmod = jlayers.Downsample2D(8, asymmetric_pad=asymmetric_pad)
    params = {"params": {"conv": {"kernel": jnp.asarray(k),
                                  "bias": jnp.asarray(b)}}}
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    for fused in (False, True):
        mod = tlayers.Downsample2D(8, asymmetric_pad=asymmetric_pad,
                                   fused_conv=fused)
        mod.conv.weight.data = _oihw(k)
        mod.conv.bias.data = _t(b)
        with torch.no_grad():
            got = mod(_t(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **KERNEL_TOL)


def _randomize(params, seed):
    """Seeded values for every leaf: norm scales near 1, small biases,
    kernels ~ N(0, 1/fan_in); numpy float32 leaves."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            v = rng.uniform(0.7, 1.3, p.shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, p.shape)
        else:
            fan_in = int(np.prod(p.shape[:-1])) if len(p.shape) > 1 else 1
            v = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)


@pytest.fixture(scope="module")
def vae_params():
    shapes = jax.eval_shape(JVAE(jcfg.VAEConfig(**VAE_KW)).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return _randomize(shapes, 11)


def _port_vae(params, fused):
    cfg = tcfg.VAEConfig(**VAE_KW)
    vae = AutoencoderKL(cfg, fused_conv=fused)
    weights.load_flax_params(vae, params, weights.vae_name_map(cfg))
    return vae


@pytest.mark.parametrize("fused", [False, True])
def test_encoder_and_encode_match_jax(vae_params, fused):
    jvae = JVAE(jcfg.VAEConfig(**VAE_KW))
    img = np.random.default_rng(12).uniform(-1, 1, (2, 32, 40, 3)).astype(
        np.float32)
    jmean, jlogvar = jax.jit(functools.partial(jvae.apply,
                                               method=jvae.encode))(
        vae_params, jnp.asarray(img))
    jmoments = jax.jit(lambda p, x: jvae.apply(
        p, x, method=lambda m, x: m.encoder(x)))(vae_params, jnp.asarray(img))
    vae = _port_vae(vae_params, fused)
    with torch.no_grad():
        moments = vae.encoder(_t(img))
        mean, logvar = vae.encode(_t(img))
    assert mean.shape == logvar.shape == (2, 4, 5, 4)
    np.testing.assert_allclose(moments.numpy(), np.asarray(jmoments),
                               **MODULE_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **MODULE_TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar),
                               **MODULE_TOL)


def test_encode_to_latents_matches_jax(vae_params):
    """The posterior's draw, fed JAX's own normal draw, and its mode."""
    cfg = jcfg.VAEConfig(**VAE_KW)
    jvae = JVAE(cfg)
    img = np.random.default_rng(13).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    rng = jax.random.PRNGKey(5)
    enc = jax.jit(functools.partial(j_encode, jvae))
    want_draw = np.asarray(enc(vae_params, jnp.asarray(img), rng))
    want_mode = np.asarray(enc(vae_params, jnp.asarray(img)))
    eps = np.asarray(jax.random.normal(rng, (2, 4, 4, 4), jnp.float32))
    vae = _port_vae(vae_params, False)
    with torch.no_grad():
        got_draw = encode_to_latents(vae, _t(img), noise=_t(eps)).numpy()
        got_mode = encode_to_latents(vae, _t(img)).numpy()
    np.testing.assert_allclose(got_draw, want_draw, **MODULE_TOL)
    np.testing.assert_allclose(got_mode, want_mode, **MODULE_TOL)
    assert not np.allclose(got_draw, got_mode)
