"""The port's residual second stage against the JAX package, on the CPU.

fp32 on both sides, the same seeded parameters (JAX's, carried across by
the port's name maps) and the same numpy inputs; JAX's own draws where a
step draws noise:
  * `ConvBlock`, `BiDirResidueExtractor` and `WarpExtractor` at full inject
    widths at 64 px, `ResControlNet` at the tiny config (pyramid, residuals);
  * `warp_and_fuse` and `make_residue_batch`: arbitrary flows, a zero-flow
    identity and the two directions read from their own anchors;
  * the trainer's residual branch: `loss_fn` gradients and one
    `train_step` against `jax.value_and_grad` of JAX's trainer;
  * `UNet2DModel` at a narrow config and at its published widths at 32 px,
    `ddpm_step` over the 500-step squaredcos schedule, the residual DDPM's
    training step against `jax.value_and_grad` and `optax.adamw`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models import extractors as jext
from diffcodec_tpu.models.controlnet import ResControlNet as JResControlNet
from diffcodec_tpu.models.layers import ConvBlock as JConvBlock
from diffcodec_tpu.models.unet2d import UNet2DModel as JUNet2D
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.sampling import schedulers as jsched
from diffcodec_tpu.train import residue as jres
from diffcodec_tpu.train import trainer as jtrainer

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models import extractors as text
from diffcodec_tpu_torch.models.controlnet import ResControlNet
from diffcodec_tpu_torch.models.layers import ConvBlock
from diffcodec_tpu_torch.models.unet2d import UNet2DModel
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule, ddpm_step
from diffcodec_tpu_torch.train import residue as tres
from diffcodec_tpu_torch.train import trainer as ttrainer
from train_parity import LOSS_RTOL, assert_grads_close, draws
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

# fp32 ops with a few sums in another order (the JAX Pallas tests' fp32
# tolerance), for the small modules and the residue transform
OP_TOL = dict(atol=2e-5, rtol=1e-4)
# fp32 through a deep stack (the extractors' 7-9 convs at widths up to
# 1280, the UNets' ~30 layers): held to 1e-5 of the output's largest value
# and 1e-5 of each element; they differ by at most ~2e-6 of the largest
DEEP_RTOL = 1e-5

INJECT = (320, 320, 640, 1280)
VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
B, RES, L_TEXT = 2, 64, 5
NARROW = dict(block_out_channels=(16, 32, 32, 64), layers_per_block=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _randomize(params, seed):
    """Seeded values for every leaf: norm scales near 1, small biases,
    kernels ~ N(0, 1/fan_in); numpy float32 leaves (no zero-initialised
    head hides a path)."""
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


def _init(module, seed, *args):
    """Randomised params of a JAX module for inputs shaped like `args`."""
    return _randomize(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                     *args), seed)


def _close_deep(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, label
    np.testing.assert_allclose(
        got, want, rtol=DEEP_RTOL,
        atol=DEEP_RTOL * float(np.abs(want).max()), err_msg=label)


def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout,stride", [(3, 64, 4), (64, 320, 2),
                                             (32, 16, 1)])
def test_conv_block_matches_jax(cin, cout, stride):
    x = _rand(np.random.default_rng(0), 2, 32, 32, cin)
    jm = JConvBlock(cout, stride=stride)
    params = _init(jm, 1, jnp.zeros((1, 32, 32, cin)))
    want = jm.apply(params, jnp.asarray(x))
    m = ConvBlock(cin, cout, stride)
    weights.load_flax_params(m, params, [
        e for name in ("conv1", "conv2")
        for e in weights._conv(f"block.{0 if name == 'conv1' else 2}",
                               (name,))])
    with torch.no_grad():
        got = m(_t(x)).numpy()
    assert got.shape == (2, -(-32 // stride), -(-32 // stride), cout)
    np.testing.assert_allclose(got, np.asarray(want), **OP_TOL)


@pytest.fixture(scope="module")
def extractor_inputs():
    rng = np.random.default_rng(2)
    return dict(prev=_rand(rng, B, RES, RES, 3), next=_rand(rng, B, RES, RES,
                                                            3),
                fwd=(rng.standard_normal((B, RES, RES, 2)) * 3).astype(
                    np.float32),
                bwd=(rng.standard_normal((B, RES, RES, 2)) * 3).astype(
                    np.float32))


def test_residue_extractor_matches_jax(extractor_inputs):
    x = extractor_inputs
    jm = jext.BiDirResidueExtractor(inject_channels=INJECT)
    args = [jnp.asarray(x[k]) for k in ("prev", "next", "fwd", "bwd")]
    params = _init(jm, 3, *args)
    want = jax.jit(jm.apply)(params, *args)
    m = text.BiDirResidueExtractor(INJECT)
    weights.load_flax_params(m, params,
                             weights.residue_extractor_name_map(INJECT))
    with torch.no_grad():
        got = m(*[_t(x[k]) for k in ("prev", "next", "fwd", "bwd")])
    assert len(got) == len(INJECT)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, RES // 8 >> lvl, RES // 8 >> lvl, INJECT[lvl])
        _close_deep(g, w, f"level {lvl}")


def test_warp_extractor_matches_jax(extractor_inputs):
    warp = extractor_inputs["prev"]
    jm = jext.WarpExtractor(inject_channels=INJECT)
    params = _init(jm, 4, jnp.asarray(warp))
    want = jax.jit(jm.apply)(params, jnp.asarray(warp))
    m = text.WarpExtractor(INJECT)
    weights.load_flax_params(m, params,
                             weights.warp_extractor_name_map(INJECT))
    with torch.no_grad():
        got = m(_t(warp))
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B, RES // 8 >> lvl, RES // 8 >> lvl, INJECT[lvl])
        _close_deep(g, w, f"level {lvl}")


def _batch(seed, flow_scale=3.0):
    """A ControlNet batch as the dataset gives it (cond in [0, 1])."""
    rng = np.random.default_rng(seed)
    return dict(image=_rand(rng, B, RES, RES, 3),
                cond=_rand(rng, B, RES, RES, 6, lo=0.0),
                flow=(rng.standard_normal((B, RES, RES, 4))
                      * flow_scale).astype(np.float32),
                text_embeds=(rng.standard_normal((B, L_TEXT, 32))
                             * 0.5).astype(np.float32))


def test_rescontrolnet_matches_jax():
    cfg = jcfg.ControlNetConfig.tiny()
    tc = tcfg.ControlNetConfig.tiny()
    batch = _batch(5)
    rb = {k: np.asarray(v) for k, v in
          jres.make_residue_batch({k: jnp.asarray(v)
                                   for k, v in batch.items()}).items()}
    h = RES // 8
    rng = np.random.default_rng(6)
    sample = _rand(rng, B, h, h, 4)
    t = np.asarray([3, 801])
    args = (sample, t, rb["text_embeds"], rb["cond"], rb["flow"],
            rb["warped"])
    jm = JResControlNet(cfg)
    params = _init(jm, 7, *[jnp.asarray(a) for a in args])

    @jax.jit
    def forward(p, *a):
        return (jm.apply(p, *a[3:], method=jm.extract_pyramid),
                jm.apply(p, *a, conditioning_scale=1.35))

    want_pyr, (want_down, want_mid) = forward(
        params, *[jnp.asarray(a) for a in args])
    m = ResControlNet(tc)
    weights.load_flax_params(m, params, weights.rescontrolnet_name_map(tc))
    with torch.no_grad():
        pyr = m.extract_pyramid(*[_t(a) for a in args[3:]])
        down, mid = m(*[_t(a) for a in args], conditioning_scale=1.35)
    for g, w in zip(pyr, want_pyr):
        _close_deep(g, w, "pyramid")
    assert len(down) == len(want_down)
    for g, w in zip(down, want_down):
        _close_deep(g, w, "down residual")
    _close_deep(mid, want_mid, "mid residual")


def test_warp_and_fuse_matches_jax():
    rng = np.random.default_rng(8)
    img1, img2 = _rand(rng, B, RES, RES, 3), _rand(rng, B, RES, RES, 3)
    flow1, flow2 = ((rng.standard_normal((B, RES, RES, 2)) * 4)
                    .astype(np.float32) for _ in range(2))
    want = jres.warp_and_fuse(*map(jnp.asarray, (img1, img2, flow1, flow2)))
    got = tres.warp_and_fuse(*map(_t, (img1, img2, flow1, flow2)))
    for g, w, name in zip(got, want, ("fused", "occ1", "occ2")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **OP_TOL)
    # the flows occlude some pixels and not others
    assert 0 < float(got[1].mean()) < 1 and 0 < float(got[2].mean()) < 1


def test_warp_and_fuse_zero_flow_and_directions():
    """`tests/test_residue_validation.py`'s two cases: zero flow occludes
    nothing and gives the anchors' mean; warp 2 reads anchor 2 (the
    reference warped anchor 1 twice)."""
    rng = np.random.default_rng(9)
    img1, img2 = _rand(rng, 1, 16, 16, 3), _rand(rng, 1, 16, 16, 3)
    zero = torch.zeros(1, 16, 16, 2)
    fused, occ1, occ2 = tres.warp_and_fuse(_t(img1), _t(img2), zero, zero)
    assert float(occ1.sum()) == 0.0 and float(occ2.sum()) == 0.0
    np.testing.assert_allclose(fused.numpy(), 0.5 * (img1 + img2),
                               rtol=1e-4, atol=1e-5)
    fused, _, _ = tres.warp_and_fuse(torch.zeros(1, 8, 8, 3),
                                     torch.ones(1, 8, 8, 3),
                                     zero[:, :8, :8], zero[:, :8, :8])
    np.testing.assert_allclose(fused.numpy(), 0.5, atol=1e-5)


@pytest.mark.parametrize("flow_scale", [0.0, 3.0])
def test_make_residue_batch_matches_jax(flow_scale):
    batch = _batch(10, flow_scale)
    want = jres.make_residue_batch({k: jnp.asarray(v)
                                    for k, v in batch.items()})
    got = tres.make_residue_batch({k: _t(v) for k, v in batch.items()})
    assert set(got) == set(want) == set(batch) | {"warped", "residual"}
    for k in batch:
        assert got[k] is not None and np.array_equal(got[k].numpy(),
                                                     batch[k])
    for k in ("warped", "residual"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **OP_TOL)
    assert float(got["warped"].abs().max()) <= 1.0
    np.testing.assert_array_equal(got["residual"].numpy(),
                                  (_t(batch["image"]) - got["warped"]).numpy())
    if flow_scale == 0.0:  # the anchors' mean, mapped to [-1, 1]
        np.testing.assert_allclose(
            got["warped"].numpy(),
            batch["cond"][..., :3] + batch["cond"][..., 3:] - 1.0,
            rtol=1e-4, atol=1e-5)


# --- the trainer's residual branch ----------------------------------------

@pytest.fixture(scope="module")
def res_setup():
    """JAX params of the tiny UNet, ResControlNet and VAE, and a residual
    batch made by JAX's `make_residue_batch`."""
    h = RES // 8
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L_TEXT, 32))
    unet = _init(JUNet(jcfg.UNetConfig.tiny()), 11, sample, t0, ctx)
    cn = _init(JResControlNet(jcfg.ControlNetConfig.tiny()), 12, sample, t0,
               ctx, jnp.zeros((1, RES, RES, 6)), jnp.zeros((1, RES, RES, 4)),
               jnp.zeros((1, RES, RES, 3)))
    vae = _init(JVAE(jcfg.VAEConfig(**VAE_KW)), 13,
                jnp.zeros((1, RES, RES, 3)))
    batch = {k: np.asarray(v) for k, v in jres.make_residue_batch(
        {k: jnp.asarray(v) for k, v in _batch(14).items()}).items()}
    return dict(jparams=dict(unet=unet, controlnet=cn, vae=vae), batch=batch)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn():
    tr = jtrainer.ControlNetTrainer(
        unet=JUNet(jcfg.UNetConfig.tiny()),
        controlnet=JResControlNet(jcfg.ControlNetConfig.tiny()),
        vae=JVAE(jcfg.VAEConfig(**VAE_KW)),
        schedule=jsched.NoiseSchedule.create(jcfg.SchedulerConfig()),
        config=jcfg.TrainConfig())
    return jax.jit(jax.value_and_grad(tr.loss_fn, has_aux=True))


def _jax_value_and_grad(setup, rng):
    jp = setup["jparams"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    (loss, _), grads = _jax_grad_fn()(
        jp["controlnet"], {"unet": jp["unet"], "vae": jp["vae"]}, batch, rng)
    return float(loss), grads


def _port_trainer(jparams, cfg):
    ccfg, vcfg = tcfg.ControlNetConfig.tiny(), tcfg.VAEConfig(**VAE_KW)
    unet = UNet2DConditionModel(tcfg.UNetConfig.tiny())
    cn, vae = ResControlNet(ccfg), AutoencoderKL(vcfg)
    weights.load_flax_params(unet, jparams["unet"], weights.unet_name_map(
        tcfg.UNetConfig.tiny()))
    weights.load_flax_params(cn, jparams["controlnet"],
                             weights.rescontrolnet_name_map(ccfg))
    weights.load_flax_params(vae, jparams["vae"], weights.vae_name_map(vcfg))
    return ttrainer.ControlNetTrainer(
        unet=unet, controlnet=cn, vae=vae,
        schedule=NoiseSchedule.create(tcfg.SchedulerConfig()), config=cfg)


def _torch_layout(tree):
    return weights.export_state_dict(
        tree, weights.rescontrolnet_name_map(tcfg.ControlNetConfig.tiny()))


def test_residual_loss_fn_and_gradients_match_jax(res_setup):
    rng = jax.random.PRNGKey(15)
    want_loss, want_grads = _jax_value_and_grad(res_setup, rng)
    tr = _port_trainer(res_setup["jparams"], tcfg.TrainConfig())
    batch = {k: _t(v) for k, v in res_setup["batch"].items()}
    # the encode target is the residual, not the image
    mean, _ = tr.moments(batch)
    with torch.no_grad():
        want_mean, _ = tr.vae.encode(batch["residual"])
        other, _ = tr.vae.encode(batch["image"])
    torch.testing.assert_close(mean, want_mean, rtol=0, atol=0)
    assert not torch.allclose(mean, other)
    loss, _ = tr.loss_fn(batch, **draws(rng, B, RES))
    loss.backward()
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    got = tr.gradients()
    assert_grads_close(got, _torch_layout(want_grads))
    # the warped prediction reaches the ControlNet: its warp extractor and
    # the residue extractor upstream of the splats get gradients
    for prefix in ("warp_extractor.enc1.", "feature_extractor.prev_pre.",
                   "feature_extractor.flow_refiners.",
                   "feature_extractor.warpers."):
        assert any(float(np.abs(g.numpy()).max()) > 0
                   for n, g in got.items() if n.startswith(prefix)), prefix


def test_residual_train_step_matches_jax(res_setup):
    """One AdamW update, as `test_torch_port_train.py` holds the DualFlow
    step (lr 1e-3 and eps 1e-6 keep the update of the tensors whose exact
    gradient is 0 at the rounding noise's scale)."""
    kw = dict(learning_rate=1e-3, adam_weight_decay=0.1, adam_epsilon=1e-6)
    rng = jax.random.PRNGKey(16)
    _, grads = _jax_value_and_grad(res_setup, rng)
    tx = jtrainer.make_optimizer(jcfg.TrainConfig(**kw))
    want = _torch_layout(jax.jit(
        lambda p, g: jtrainer.TrainState.create(p, tx).apply_gradients(
            g).params)(res_setup["jparams"]["controlnet"], grads))
    tr = _port_trainer(res_setup["jparams"], tcfg.TrainConfig(**kw))
    before = {n: p.detach().clone()
              for n, p in tr.controlnet.named_parameters()}
    state = ttrainer.TrainState.create(dict(tr.controlnet.named_parameters()),
                                       ttrainer.Optimizer(tr.config))
    batch = {k: _t(v) for k, v in res_setup["batch"].items()}
    state, metrics = tr.train_step(state, batch, **draws(rng, B, RES))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    for name, w in want.items():
        delta_w = w - before[name].numpy()
        delta_g = state.params[name].numpy() - before[name].numpy()
        np.testing.assert_allclose(delta_g, delta_w, rtol=0,
                                   atol=0.02 * kw["learning_rate"],
                                   err_msg=name)


# --- the residual pixel DDPM ----------------------------------------------

def _unet2d_pair(kw, seed, res):
    jm = JUNet2D(**kw)
    params = _init(jm, seed, jnp.zeros((1, res, res, 3)),
                   jnp.zeros((1,), jnp.int32))
    m = UNet2DModel(**kw)
    weights.load_flax_params(m, params, weights.unet2d_name_map(
        **{k: v for k, v in kw.items()}))
    return jm, params, m


@pytest.mark.parametrize("widths", ["narrow", "published"])
def test_unet2d_matches_jax(widths):
    kw = NARROW if widths == "narrow" else {}
    res = 32
    jm, params, m = _unet2d_pair(kw, 17, res)
    rng = np.random.default_rng(18)
    x = _rand(rng, 2, res, res, 3)
    t = np.asarray([0, 437])
    want = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = m(_t(x), _t(t))
    assert got.shape == (2, res, res, 3)
    _close_deep(got, want)
    if widths == "published":
        assert sum(p.numel() for p in m.parameters()) == sum(
            np.size(p) for p in jax.tree.leaves(params))


def test_ddpm_step_matches_jax():
    """Every 37th step of the 500-step squaredcos schedule, the last one
    (prev_timestep < 0, no noise) included.  XLA's CPU square root is not
    always IEEE-rounded, so the coefficients may sit an ulp apart."""
    T = 500
    jsch = jsched.NoiseSchedule.create(jcfg.SchedulerConfig(
        num_train_timesteps=T, beta_schedule="squaredcos_cap_v2",
        beta_start=0.0001, beta_end=0.02))
    tsch = tres.ddpm_schedule()
    np.testing.assert_array_equal(tsch.alphas_cumprod,
                                  np.asarray(jsch.alphas_cumprod))
    rng = np.random.default_rng(19)
    sample = (rng.standard_normal((2, 8, 8, 3))).astype(np.float32)
    for t in list(range(T - 1, 0, -37)) + [1, 0]:
        prev = t - 1 if t > 0 else -1
        eps = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
        noise = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
        for clip in (True, False):
            want = jsched.ddpm_step(jsch, jnp.asarray(eps), t, prev,
                                    jnp.asarray(sample), jnp.asarray(noise),
                                    clip_sample=clip)
            got = ddpm_step(tsch, _t(eps), t, prev, _t(sample),
                            None if prev < 0 else _t(noise),
                            clip_sample=clip)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"t={t} clip={clip}")
        sample = np.asarray(want)
    assert np.isfinite(sample).all()


def test_ddpm_optimizer_is_optax_adamw():
    """`ddpm_optimizer()` computes `optax.adamw(4e-4)`'s update (b1 0.9,
    b2 0.999, eps 1e-8, weight decay 1e-4, no clipping) on the same
    gradients, tiny ones included, over three steps."""
    rng = np.random.default_rng(20)
    params = {"w": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    tx = optax.adamw(4e-4)
    jparams, jstate = params, tx.init(params)
    tparams = {k: _t(v) for k, v in params.items()}
    opt = tres.ddpm_optimizer()
    state = opt.init(tparams)
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** -(3 * step + 1)
                     * 30).astype(np.float32) for k, v in params.items()}
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update(tparams, {k: _t(v) for k, v in grads.items()}, state)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{k} {step}")


def test_ddpm_train_step_matches_jax():
    """`ddpm_train_step` with JAX's draws against `train_residual.py`'s
    step: the loss, and the parameters after `optax.adamw(lr, eps=1e-6)`
    (eps as in the ControlNet step's test) held like it holds them."""
    res, lr, eps = 32, 4e-4, 1e-6
    jm, params, m = _unet2d_pair(NARROW, 21, res)
    residual = _rand(np.random.default_rng(22), 2, res, res, 3)
    schedule = jsched.NoiseSchedule.create(jcfg.SchedulerConfig(
        num_train_timesteps=500, beta_schedule="squaredcos_cap_v2",
        beta_start=0.0001, beta_end=0.02))
    rng_n, rng_t = jax.random.split(jax.random.PRNGKey(23))
    noise = jax.random.normal(rng_n, residual.shape)
    t = jax.random.randint(rng_t, (2,), 0, 500)
    noisy = schedule.add_noise(jnp.asarray(residual), noise, t)

    def loss_fn(p):
        pred = jm.apply(p, noisy, t)
        return jnp.mean((pred.astype(jnp.float32) - noise) ** 2)

    tx = optax.adamw(lr, eps=eps)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, optax.apply_updates(p, updates)

    want_loss, new_params = step(params)
    want = weights.export_state_dict(new_params,
                                     weights.unet2d_name_map(**NARROW))
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    opt = ttrainer.Optimizer(tcfg.TrainConfig(
        learning_rate=lr, adam_weight_decay=1e-4, adam_epsilon=eps,
        max_grad_norm=float("inf")))
    state = opt.init(dict(m.named_parameters()))
    loss = tres.ddpm_train_step(m, tres.ddpm_schedule(), opt, state,
                                _t(residual), noise=_t(noise),
                                timesteps=_t(t))
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * float(
        want_loss)
    assert state["count"] == 1
    got = dict(m.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].detach().numpy() - before[name].numpy(),
            w - before[name].numpy(), rtol=0, atol=0.02 * lr, err_msg=name)
    # drawn from a generator, the step runs and moves the loss
    g = torch.Generator().manual_seed(0)
    losses = [tres.ddpm_train_step(m, tres.ddpm_schedule(), opt, state,
                                   _t(residual), generator=g).item()
              for _ in range(2)]
    assert all(np.isfinite(losses)) and state["count"] == 3
