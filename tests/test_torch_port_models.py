"""The port's models and weight bridge against the JAX package, on the CPU.

Each JAX model is initialised at its `tiny()` config, its parameters are
replaced with seeded random values (so no zero-initialised head hides a
path), and the tree goes through the port's bridge
(`diffcodec_tpu_torch.weights`).  The bridge must give the same keys and
arrays as `hf_import.export_state_dict`, and the port's forward must match
the JAX forward on the same numpy inputs, in fp32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models import hf_import
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.extractors import (
    BiDirFeatureExtractor as JExtractor)
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.models.vae import decode_from_latents as j_decode

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.extractors import BiDirFeatureExtractor
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL, decode_from_latents
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

# fp32 through a few dozen layers: convs and matmuls accumulate in another
# order in XLA and in PyTorch's CPU kernels
ATOL, RTOL = 1e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _randomize(params, seed):
    """Seeded values for every leaf of a tree of arrays or shapes: norm
    scales near 1, small biases, kernels ~ N(0, 1/fan_in); numpy float32
    leaves."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = p.shape
        if name == "scale":
            v = rng.uniform(0.7, 1.3, shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _tiny_vae_cfgs():
    # four levels (latents at /8) at tiny widths
    kw = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
    return jcfg.VAEConfig(**kw), tcfg.VAEConfig(**kw)


@pytest.fixture(scope="module")
def jax_params():
    """Randomised flax trees of the tiny UNet, ControlNet and VAE."""
    B, h, L = 1, 8, 5
    sample = jnp.zeros((B, h, h, 4))
    t0 = jnp.asarray([0])
    ctx = jnp.zeros((B, L, 32))
    jvae_cfg, _ = _tiny_vae_cfgs()
    key = jax.random.PRNGKey(0)
    # shapes only: every leaf is replaced by `_randomize`
    unet = jax.eval_shape(JUNet(jcfg.UNetConfig.tiny()).init, key, sample,
                          t0, ctx)
    cn = jax.eval_shape(JControlNet(jcfg.ControlNetConfig.tiny()).init, key,
                        sample, t0, ctx, jnp.zeros((B, 8 * h, 8 * h, 6)),
                        jnp.zeros((B, 8 * h, 8 * h, 4)))
    vae = jax.eval_shape(JVAE(jvae_cfg).init, key,
                         jnp.zeros((B, 8 * h, 8 * h, 3)))
    return {"unet": _randomize(unet, 1), "controlnet": _randomize(cn, 2),
            "vae": _randomize(vae, 3)}


def _bridge_cases():
    _, tvae = _tiny_vae_cfgs()
    return {
        "unet": (lambda: UNet2DConditionModel(tcfg.UNetConfig.tiny()),
                 weights.unet_name_map(tcfg.UNetConfig.tiny()),
                 hf_import.unet_name_map(jcfg.UNetConfig.tiny())),
        "controlnet": (
            lambda: DualFlowControlNet(tcfg.ControlNetConfig.tiny()),
            weights.controlnet_name_map(tcfg.ControlNetConfig.tiny()),
            hf_import.controlnet_name_map(jcfg.ControlNetConfig.tiny())),
        "vae": (lambda: AutoencoderKL(tvae), weights.vae_name_map(tvae),
                hf_import.vae_name_map(_tiny_vae_cfgs()[0])),
    }


@pytest.mark.parametrize("which", ["unet", "controlnet", "vae"])
def test_weight_bridge_matches_export_state_dict(jax_params, which):
    make, port_map, jax_map = _bridge_cases()[which]
    params = jax_params[which]
    got = weights.export_state_dict(params, port_map)
    want = hf_import.export_state_dict(params, jax_map)
    assert port_map == jax_map
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    module = make()
    assert set(module.state_dict()) == set(got)
    weights.load_flax_params(module, params, port_map)
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)


def test_feature_extractor_name_map_matches_jax():
    inject = tcfg.ControlNetConfig.tiny().inject_channels
    assert (weights.feature_extractor_name_map(inject)
            == hf_import.feature_extractor_name_map(inject))


def test_weight_bridge_rejects_a_missing_key(jax_params):
    make, port_map, _ = _bridge_cases()["unet"]
    with pytest.raises(RuntimeError, match="Missing key"):
        weights.load_flax_params(make(), jax_params["unet"], port_map[:-1])


def _inputs(seed, B=2, H=64, L=5, ctx_dim=32):
    rng = np.random.default_rng(seed)
    return dict(
        sample=rng.standard_normal((B, H // 8, H // 8, 4)).astype(np.float32),
        ctx=(rng.standard_normal((B, L, ctx_dim)) * 0.5).astype(np.float32),
        cond=rng.uniform(-1, 1, (B, H, H, 6)).astype(np.float32),
        flow=(rng.standard_normal((B, H, H, 4)) * 3).astype(np.float32))


def test_feature_extractor_matches_jax(jax_params):
    inj = tcfg.ControlNetConfig.tiny().inject_channels
    fe_params = jax_params["controlnet"]["params"]["feature_extractor"]
    x = _inputs(4)
    want = jax.jit(JExtractor(inject_channels=inj).apply)(
        {"params": fe_params}, jnp.asarray(x["cond"]), jnp.asarray(x["flow"]))
    module = BiDirFeatureExtractor(inj)
    weights.load_flax_params(module, fe_params,
                             weights.feature_extractor_name_map(inj))
    with torch.no_grad():
        got = module(_t(x["cond"]), _t(x["flow"]))
    assert len(got) == len(want) == len(inj)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


def test_controlnet_matches_jax(jax_params):
    jmodel = JControlNet(jcfg.ControlNetConfig.tiny())
    params = jax_params["controlnet"]
    x = _inputs(5)
    jpyr = jax.jit(functools.partial(jmodel.apply,
                                     method=jmodel.extract_pyramid))(
        params, jnp.asarray(x["cond"]), jnp.asarray(x["flow"]))
    jdown, jmid = jax.jit(functools.partial(jmodel.apply,
                                            method=jmodel.backbone))(
        params, jnp.asarray(x["sample"]), jnp.int32(321),
        jnp.asarray(x["ctx"]), jpyr, 1.35)
    module = DualFlowControlNet(tcfg.ControlNetConfig.tiny())
    weights.load_flax_params(module, params, weights.controlnet_name_map(
        tcfg.ControlNetConfig.tiny()))
    with torch.no_grad():
        pyr = module.extract_pyramid(_t(x["cond"]), _t(x["flow"]))
        down, mid = module.backbone(_t(x["sample"]), 321, _t(x["ctx"]), pyr,
                                    1.35)
    for g, w in zip(pyr, jpyr):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)
    assert len(down) == len(jdown)
    for g, w in zip(list(down) + [mid], list(jdown) + [jmid]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("with_residuals", [True, False])
def test_unet_matches_jax(jax_params, with_residuals):
    """The UNet with ControlNet residuals and FreeU, and the plain forward;
    also `decode(*encode(...))` against `forward`."""
    cfg = jcfg.UNetConfig.tiny()
    params = jax_params["unet"]
    x = _inputs(6)
    rng = np.random.default_rng(7)
    widths = [(32, 8), (32, 8), (32, 4), (64, 4), (64, 2), (64, 2)]
    down = [(rng.standard_normal((2, r, r, c)) * 0.1).astype(np.float32)
            for c, r in widths]
    mid = (rng.standard_normal((2, 2, 2, 64)) * 0.1).astype(np.float32)
    freeu = (0.9, 0.2, 1.2, 1.4)
    kw_j = (dict(down_block_additional_residuals=tuple(map(jnp.asarray,
                                                           down)),
                 mid_block_additional_residual=jnp.asarray(mid), freeu=freeu)
            if with_residuals else {})
    want = jax.jit(functools.partial(JUNet(cfg).apply, freeu=kw_j.pop(
        "freeu", None)))(params, jnp.asarray(x["sample"]), jnp.int32(777),
                         jnp.asarray(x["ctx"]), **kw_j)
    module = UNet2DConditionModel(tcfg.UNetConfig.tiny())
    weights.load_flax_params(module, params,
                             weights.unet_name_map(tcfg.UNetConfig.tiny()))
    kw_t = (dict(down_block_additional_residuals=list(map(_t, down)),
                 mid_block_additional_residual=_t(mid), freeu=freeu)
            if with_residuals else {})
    with torch.no_grad():
        got = module(_t(x["sample"]), 777, _t(x["ctx"]), **kw_t)
        hidden, stack = module.encode(_t(x["sample"]), 777, _t(x["ctx"]))
        split = module.decode(hidden, stack, 777, _t(x["ctx"]), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(split, got, atol=0, rtol=0)


def test_vae_decoder_matches_jax(jax_params):
    jvae_cfg, tvae_cfg = _tiny_vae_cfgs()
    params = jax_params["vae"]
    z = np.random.default_rng(8).standard_normal((2, 4, 4, 4)).astype(
        np.float32)
    want = jax.jit(functools.partial(j_decode, JVAE(jvae_cfg)))(
        params, jnp.asarray(z))
    module = AutoencoderKL(tvae_cfg)
    weights.load_flax_params(module, params, weights.vae_name_map(tvae_cfg))
    with torch.no_grad():
        got = decode_from_latents(module, _t(z))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
