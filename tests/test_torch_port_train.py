"""The port's ControlNet training step against the JAX package, on the CPU.

Tiny fp32 configs on both sides, the same randomised weights (through the
port's weight bridge), the same batch (numpy seeds) and JAX's own draws
(`jax.random` splits of the step's key, handed to the port's `loss_fn`):
  * the loss and every ControlNet gradient, mapped through
    `controlnet_name_map`, against `jax.value_and_grad` of JAX's
    `loss_fn`, without and with the edge term, and with remat;
  * one `train_step` with AdamW, with bf16 moments, and an accumulation of
    two micro-steps, against JAX's optimizer applied to JAX's gradients;
  * the loss and gradients with the LPIPS term (the port's `LPIPS`
    against JAX's, one set of converted weights);
  * the four learning-rate schedules, a checkpoint round trip with
    rotation, latent caches written by one package and read by the other;
  * the backward of the kernel wrappers (attention with a masked key tail,
    splat, the four convs) against `jax.vjp` of the JAX forms;
  * the per-sample-timestep noise schedule and the Sobel edge loss.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.ops import conv_pallas as jconv
from diffcodec_tpu.ops import softsplat as jsplat
from diffcodec_tpu.ops import sobel as jsobel
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule
from diffcodec_tpu.train import latent_cache as jcache
from diffcodec_tpu.train import lpips as jlpips
from diffcodec_tpu.train import trainer as jtrainer

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.ops import conv as tconv
from diffcodec_tpu_torch.ops.attention import attention
from diffcodec_tpu_torch.ops.softsplat import splat_sum
from diffcodec_tpu_torch.ops.sobel import sobel_edge_loss, sobel_magnitude
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from diffcodec_tpu_torch.train import checkpoint as tckpt
from diffcodec_tpu_torch.train import latent_cache as tcache
from diffcodec_tpu_torch.train import lpips as tlpips
from diffcodec_tpu_torch.train import trainer as ttrainer
from train_parity import LOSS_RTOL, assert_grads_close, draws
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

# fp32 ops with a few sums in another order
OP_TOL = dict(atol=2e-5, rtol=1e-4)

VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
B, RES, L_TEXT = 2, 64, 5


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


@pytest.fixture(scope="module")
def setup():
    """Randomised JAX params, the port's modules loaded from them, and a
    batch."""
    h = RES // 8
    key = jax.random.PRNGKey(0)
    ucfg, ccfg = jcfg.UNetConfig.tiny(), jcfg.ControlNetConfig.tiny()
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L_TEXT, 32))
    unet = _randomize(jax.eval_shape(JUNet(ucfg).init, key, sample, t0, ctx),
                      1)
    cn = _randomize(jax.eval_shape(
        JControlNet(ccfg).init, key, sample, t0, ctx,
        jnp.zeros((1, RES, RES, 6)), jnp.zeros((1, RES, RES, 4))), 2)
    vae = _randomize(jax.eval_shape(JVAE(jcfg.VAEConfig(**VAE_KW)).init, key,
                                    jnp.zeros((1, RES, RES, 3))), 3)
    rng = np.random.default_rng(4)
    batch = dict(
        image=rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
        cond=rng.uniform(-1, 1, (B, RES, RES, 6)).astype(np.float32),
        flow=(rng.standard_normal((B, RES, RES, 4)) * 3).astype(np.float32),
        text_embeds=(rng.standard_normal((B, L_TEXT, 32)) * 0.5).astype(
            np.float32))
    return dict(jparams=dict(unet=unet, controlnet=cn, vae=vae), batch=batch)


def _jax_trainer(cfg):
    return jtrainer.ControlNetTrainer(
        unet=JUNet(jcfg.UNetConfig.tiny()),
        controlnet=JControlNet(jcfg.ControlNetConfig.tiny()),
        vae=JVAE(jcfg.VAEConfig(**VAE_KW)),
        schedule=JSchedule.create(jcfg.SchedulerConfig()), config=cfg)


def _port_trainer(jparams, cfg):
    ccfg = tcfg.ControlNetConfig.tiny()
    vcfg = tcfg.VAEConfig(**VAE_KW)
    unet = UNet2DConditionModel(tcfg.UNetConfig.tiny())
    cn = DualFlowControlNet(ccfg)
    vae = AutoencoderKL(vcfg)
    weights.load_flax_params(unet, jparams["unet"], weights.unet_name_map(
        tcfg.UNetConfig.tiny()))
    weights.load_flax_params(cn, jparams["controlnet"],
                             weights.controlnet_name_map(ccfg))
    weights.load_flax_params(vae, jparams["vae"], weights.vae_name_map(vcfg))
    return ttrainer.ControlNetTrainer(
        unet=unet, controlnet=cn, vae=vae,
        schedule=NoiseSchedule.create(tcfg.SchedulerConfig()), config=cfg)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(cfg_items):
    """jit(value_and_grad(loss_fn)) of JAX's trainer, one per loss config
    (compiled once per test process)."""
    tr = _jax_trainer(jcfg.TrainConfig(**dict(cfg_items)))
    return jax.jit(jax.value_and_grad(tr.loss_fn, has_aux=True))


def _jax_value_and_grad(setup, rng, **cfg_kw):
    """(loss, ControlNet gradient tree) of JAX's loss_fn at key `rng`."""
    jp = setup["jparams"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    frozen = {"unet": jp["unet"], "vae": jp["vae"]}
    (loss, _), grads = _jax_grad_fn(tuple(sorted(cfg_kw.items())))(
        jp["controlnet"], frozen, batch, rng)
    return float(loss), grads


def _torch_layout(tree):
    return weights.export_state_dict(
        tree, weights.controlnet_name_map(tcfg.ControlNetConfig.tiny()))


@pytest.mark.parametrize("variant", ["mse", "edge", "remat"])
def test_loss_fn_and_gradients_match_jax(setup, variant):
    kw = {"mse": {}, "edge": {"edge_weight": 0.5},
          "remat": {"remat": True}}[variant]
    rng = jax.random.PRNGKey(7)
    want_loss, want_grads = _jax_value_and_grad(setup, rng, **kw)
    tr = _port_trainer(setup["jparams"], tcfg.TrainConfig(**kw))
    batch = {k: _t(v) for k, v in setup["batch"].items()}
    loss, metrics = tr.loss_fn(batch, **draws(rng, B, RES))
    loss.backward()
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert ("loss_edge" in metrics) == (variant == "edge")
    assert_grads_close(tr.gradients(), _torch_layout(want_grads))
    # the frozen models get no gradient
    assert all(p.grad is None for m in (tr.unet, tr.vae)
               for p in m.parameters())


def test_loss_fn_with_lpips_matches_jax(setup):
    """`pixel_losses` through the port's LPIPS against JAX's, both fed one
    set of seeded AlexNet and lin weights (the JAX bridge's
    `lpips_alex_name_map`): the loss and every ControlNet gradient."""
    cfg_kw = dict(lpips_weight=0.5, edge_weight=0.25)
    z = jnp.zeros((1, RES, RES, 3))
    lp_params = _randomize(jax.eval_shape(jlpips.LPIPS().init,
                                          jax.random.PRNGKey(0), z, z), 9)
    jtr = dataclasses.replace(_jax_trainer(jcfg.TrainConfig(**cfg_kw)),
                              lpips=jlpips.LPIPS())
    jp = setup["jparams"]
    rng = jax.random.PRNGKey(8)
    (want_loss, want_metrics), want_grads = jax.jit(jax.value_and_grad(
        jtr.loss_fn, has_aux=True))(
            jp["controlnet"], {"unet": jp["unet"], "vae": jp["vae"],
                               "lpips": lp_params},
            {k: jnp.asarray(v) for k, v in setup["batch"].items()}, rng)
    lp = tlpips.LPIPS()
    weights.load_flax_params(lp, lp_params, weights.lpips_alex_name_map())
    tr = _port_trainer(jp, tcfg.TrainConfig(**cfg_kw))
    tr = dataclasses.replace(tr, lpips=lp)
    batch = {k: _t(v) for k, v in setup["batch"].items()}
    loss, metrics = tr.loss_fn(batch, **draws(rng, B, RES))
    loss.backward()
    assert abs(float(want_metrics["loss_lpips"])) > 1e-4
    np.testing.assert_allclose(metrics["loss_lpips"].item(),
                               float(want_metrics["loss_lpips"]),
                               rtol=LOSS_RTOL * 10)
    assert abs(loss.item() - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    assert_grads_close(tr.gradients(), _torch_layout(want_grads))
    assert all(p.grad is None for p in lp.parameters())


def _jax_params_after(setup, cfg_kw, n_steps):
    """JAX's train_step, n_steps times from step 0: value_and_grad of
    loss_fn at fold_in(key, step), then `TrainState.apply_gradients`.
    Returns the parameters in torch layout and the first step's gradient
    norm."""
    tx = jtrainer.make_optimizer(jcfg.TrainConfig(**cfg_kw))
    state = jtrainer.TrainState.create(setup["jparams"]["controlnet"], tx)
    norms = []
    for step in range(n_steps):
        rng = jax.random.fold_in(jax.random.PRNGKey(9), step)
        _, grads = _jax_value_and_grad(setup, rng)
        norms.append(float(optax_global_norm(grads)))
        state = state.apply_gradients(grads)
    return _torch_layout(state.params), norms[0]


def optax_global_norm(tree):
    return jnp.sqrt(sum(jnp.sum(jnp.square(x))
                        for x in jax.tree.leaves(tree)))


@pytest.mark.parametrize("variant", ["adamw", "lowp", "accum"])
def test_train_step_matches_jax(setup, variant):
    """The master parameters after one update: AdamW with fp32 moments,
    with bf16 moments, and two micro-steps accumulated.  lr 1e-3 so that
    the update stands well above fp32's rounding of the weights; the
    gradient norm is above max_grad_norm, so the clip acts.  Adam's step
    is g / (|g| + eps) at the first update: eps 1e-6 keeps the step of the
    few tensors whose exact gradient is 0 (biases that a GroupNorm
    follows), where both sides hold rounding noise of ~1e-9, at the noise's
    scale and not at lr's."""
    kw = dict(learning_rate=1e-3, adam_weight_decay=0.1, adam_epsilon=1e-6)
    kw.update({"adamw": {}, "lowp": {"lowp_adam_moments": True},
               "accum": {"gradient_accumulation_steps": 2}}[variant])
    n_steps = 2 if variant == "accum" else 1
    want, norm = _jax_params_after(setup, kw, n_steps)
    tr = _port_trainer(setup["jparams"], tcfg.TrainConfig(**kw))
    before = {n: p.detach().clone()
              for n, p in tr.controlnet.named_parameters()}
    state = ttrainer.TrainState.create(dict(tr.controlnet.named_parameters()),
                                       ttrainer.Optimizer(tr.config))
    batch = {k: _t(v) for k, v in setup["batch"].items()}
    for step in range(n_steps):
        rng = jax.random.fold_in(jax.random.PRNGKey(9), step)
        state, _ = tr.train_step(state, batch, **draws(rng, B, RES))
        if variant == "accum" and step == 0:  # no update yet
            for n, p in tr.controlnet.named_parameters():
                torch.testing.assert_close(p.detach(), before[n], atol=0,
                                           rtol=0)
    assert state.step == n_steps and state.opt_state["count"] == 1
    assert norm > kw.get("max_grad_norm", 1.0)  # the clip acted
    for name, w in want.items():
        got = state.params[name].numpy()
        # the update is lr * (Adam's ~unit step + decay); hold the change
        # of each weight to 2% of the update's scale: Adam divides by
        # sqrt(nu) + 1e-8, which amplifies the gradients' fp32 differences
        # where a gradient element is tiny
        delta_w = w - before[name].numpy()
        delta_g = got - before[name].numpy()
        np.testing.assert_allclose(delta_g, delta_w, rtol=0,
                                   atol=0.02 * kw["learning_rate"],
                                   err_msg=name)
        # the working copy holds the master
        np.testing.assert_array_equal(
            dict(tr.controlnet.named_parameters())[name].detach().numpy(),
            got)


@pytest.mark.parametrize("scheduler", ["constant", "constant_with_warmup",
                                       "linear", "cosine"])
def test_lr_schedules_match_jax(scheduler):
    cfg = dict(learning_rate=3e-4, lr_scheduler=scheduler,
               lr_warmup_steps=5, max_train_steps=23)
    want = jtrainer.make_lr_schedule(jcfg.TrainConfig(**cfg))
    got = ttrainer.make_lr_schedule(tcfg.TrainConfig(**cfg))
    steps = range(0, 30)
    np.testing.assert_allclose([got(n) for n in steps],
                               [float(want(n)) for n in steps],
                               rtol=1e-5, atol=1e-12)


def test_checkpoint_round_trip_with_rotation(tmp_path):
    d = str(tmp_path / "ckpt")
    assert tckpt.restore_checkpoint(d) == (None, 0)
    states = {}
    for step in (100, 200, 300):
        states[step] = {"step": step, "params": {"w": torch.full((2, 3),
                                                                 step / 7)},
                        "opt_state": {"count": step // 100,
                                      "mu": {"w": torch.ones(2, 3)}}}
        tckpt.save_checkpoint(d, step, states[step], total_limit=2)
    assert [s for s, _ in tckpt.list_checkpoints(d)] == [200, 300]
    state, step = tckpt.restore_checkpoint(d)
    assert step == 300 and state["opt_state"]["count"] == 3
    torch.testing.assert_close(state["params"]["w"],
                               states[300]["params"]["w"])
    state, step = tckpt.restore_checkpoint(d, step=200)
    assert step == 200 and state["step"] == 200
    assert tckpt.restore_checkpoint(d, step=100) == (None, 0)
    # saving a step again replaces it and rotates nothing
    tckpt.save_checkpoint(d, 300, states[100], total_limit=2)
    assert [s for s, _ in tckpt.list_checkpoints(d)] == [200, 300]
    assert tckpt.restore_checkpoint(d)[0]["step"] == 100
    fresh = {"w": torch.zeros(2, 3), "b": torch.zeros(4)}
    merged, copied = tckpt.warm_start_filter(
        fresh, {"w": torch.ones(2, 3), "b": torch.ones(5)})
    assert copied == 1 and merged["w"].sum() == 6 and merged["b"].sum() == 0


class _Images:
    """An indexable dataset of images, without augmentation."""
    transform = False

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "index": i}


def test_latent_caches_read_across_packages(setup, tmp_path):
    """A cache written by JAX reads in the port, with the moments the
    port's encoder gives; one written by the port reads in JAX."""
    jp = setup["jparams"]["vae"]
    images = np.random.default_rng(21).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)
    ds = _Images(images)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcache.precompute_latent_moments(
        JVAE(jcfg.VAEConfig(**VAE_KW)), jp, ds, jdir, batch_size=2) == 3
    cached = tcache.LatentCachedDataset(ds, jdir)
    vae = AutoencoderKL(tcfg.VAEConfig(**VAE_KW))
    weights.load_flax_params(vae, jp, weights.vae_name_map(vae.cfg))
    # encoded in the writers' batches (2, then 1): the CPU's convs may
    # round a sample apart with the batch it is in (1.5e-6 at most on one
    # host, torch 2.13.0+cpu; bit-identical on the card machine's CPU,
    # torch 2.11.0+cu128), so the bit-for-bit read-back below compares
    # like with like
    with torch.no_grad():
        want = torch.cat([torch.cat(vae.encode(_t(images[s])), dim=-1)
                          for s in (slice(0, 2), slice(2, 3))]).numpy()
    for i in range(3):
        sample = cached[i]
        assert sample["index"] == i
        np.testing.assert_allclose(sample["latent_moments"], want[i],
                                   atol=1e-4, rtol=1e-3)
    assert tcache.precompute_latent_moments(vae, ds, tdir, batch_size=2) == 3
    back = jcache.LatentCachedDataset(ds, tdir)
    for i in range(3):
        np.testing.assert_array_equal(back[i]["latent_moments"], want[i])
    with pytest.raises(FileNotFoundError):
        tcache.LatentCachedDataset(ds, str(tmp_path / "none"))


def test_loss_fn_takes_cached_moments(setup):
    """'latent_moments' in the batch skips the encoder: the same loss as
    the online encode with the same draws."""
    tr = _port_trainer(setup["jparams"], tcfg.TrainConfig())
    batch = {k: _t(v) for k, v in setup["batch"].items()}
    drawn = draws(jax.random.PRNGKey(3), B, RES)
    with torch.no_grad():
        mean, logvar = tr.vae.encode(batch["image"])
        online, _ = tr.loss_fn(batch, **drawn)
        cached, _ = tr.loss_fn(dict(batch, latent_moments=torch.cat(
            [mean, logvar], dim=-1)), **drawn)
    assert float(cached) == float(online)


def _vjp_pair(jfn, tfn, jargs, targs, seed=0):
    """(port grads, JAX grads as numpy) of sum(out * ct), ct seeded."""
    out, vjp = jax.vjp(jfn, *jargs)
    ct = np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)
    want = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    leaves = [a.clone().requires_grad_() for a in targs]
    got = torch.autograd.grad(tfn(*leaves), leaves, _t(ct))
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("Lk", [77, 128])
def test_attention_backward_matches_jax_vjp(Lk):
    """The port's Function on the CPU (autograd of the plain version)
    against jax.vjp of an exact attention whose keys are padded to a
    multiple of 128 and masked, as the JAX package's flash path pads and
    masks them (`layers.py:209-219`); the padded keys get no gradient."""
    rng = np.random.default_rng(Lk)
    BH, Lq, D = 3, 40, 16
    q, k, v = (rng.standard_normal((BH, n, D)).astype(np.float32)
               for n in (Lq, Lk, Lk))
    scale = D ** -0.5
    Lp = -(-Lk // 128) * 128

    def jattn(q, k, v):
        kp = jnp.pad(k, ((0, 0), (0, Lp - Lk), (0, 0)))
        vp = jnp.pad(v, ((0, 0), (0, Lp - Lk), (0, 0)))
        s = jnp.einsum("bqd,bkd->bqk", q, kp) * scale
        s = jnp.where(jnp.arange(Lp) < Lk, s, -0.7 * jnp.finfo(s.dtype).max)
        return jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(s, -1), vp)

    got, want = _vjp_pair(jattn, lambda *t: attention(*t, scale),
                          (q, k, v), [_t(a) for a in (q, k, v)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **OP_TOL)


def test_splat_backward_matches_jax_vjp():
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    flow = (rng.standard_normal((2, 9, 11, 2)) * 2.5).astype(np.float32)
    got, want = _vjp_pair(jsplat.splat_sum, splat_sum, (vals, flow),
                          (_t(vals), _t(flow)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **OP_TOL)


def _hwio_grad_to_oihw(g):
    return np.asarray(g).transpose(3, 2, 0, 1)


@pytest.mark.parametrize("which", ["gn", "gn_res", "silu", "up", "down",
                                   "down_sym"])
def test_conv_backward_matches_jax_vjp(which):
    """The conv wrappers' Function on the CPU against jax.vjp of the JAX
    `*_ref` forms, which JAX's custom_vjps differentiate."""
    rng = np.random.default_rng(6)
    C, O = 8, 8
    x = rng.standard_normal((2, 10, 12, C)).astype(np.float32)
    sc = (rng.random((2, C)) + 0.5).astype(np.float32)
    sh = rng.standard_normal((2, C)).astype(np.float32)
    k = (rng.standard_normal((3, 3, C, O)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(O) * 0.1).astype(np.float32)
    res = rng.standard_normal((2, 10, 12, O)).astype(np.float32)
    cases = {
        "gn": (jconv.gn_silu_conv3x3_ref, tconv.gn_silu_conv3x3,
               (x, sc, sh, k, b)),
        "gn_res": (jconv.gn_silu_conv3x3_ref, tconv.gn_silu_conv3x3,
                   (x, sc, sh, k, b, res)),
        "silu": (jconv.silu_conv3x3_ref, tconv.silu_conv3x3, (x, k, b)),
        "up": (jconv.upsample_conv3x3_ref, tconv.upsample_conv3x3,
               (x, k, b)),
        "down": (jconv.downsample_conv3x3_ref, tconv.downsample_conv3x3,
                 (x, k, b)),
        "down_sym": (functools.partial(jconv.downsample_conv3x3_ref,
                                       asymmetric_pad=False),
                     lambda *a: tconv.downsample_conv3x3(*a, False),
                     (x, k, b)),
    }
    jfn, tfn, args = cases[which]
    kpos = 3 if which.startswith("gn") else 1
    targs = [_t(a) if i != kpos else _t(a.transpose(3, 2, 0, 1))
             for i, a in enumerate(args)]
    got, want = _vjp_pair(jfn, tfn, args, targs)
    want[kpos] = _hwio_grad_to_oihw(want[kpos])
    for g, w in zip(got, want):
        m = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, atol=OP_TOL["atol"] * max(m, 1),
                                   rtol=OP_TOL["rtol"])


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_per_sample_timestep_schedule_matches_jax(prediction_type):
    cfg_kw = dict(prediction_type=prediction_type)
    js = JSchedule.create(jcfg.SchedulerConfig(**cfg_kw))
    ts = NoiseSchedule.create(tcfg.SchedulerConfig(**cfg_kw))
    rng = np.random.default_rng(8)
    x, n = (rng.standard_normal((4, 3, 5, 4)).astype(np.float32)
            for _ in range(2))
    t = np.asarray([0, 17, 500, 999], np.int32)
    for name in ("add_noise", "velocity", "pred_original_sample"):
        want = np.asarray(getattr(js, name)(jnp.asarray(x), jnp.asarray(n),
                                            jnp.asarray(t)))
        got = getattr(ts, name)(_t(x), _t(n), _t(t).long())
        # XLA's CPU square root is not correctly rounded: an ulp apart
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        # the per-sample form is the scalar form sample by sample
        for i in range(4):
            one = getattr(ts, name)(_t(x[i:i + 1]), _t(n[i:i + 1]),
                                    int(t[i]))
            torch.testing.assert_close(got[i:i + 1], one, atol=0, rtol=0)


def test_sobel_edge_loss_matches_jax():
    rng = np.random.default_rng(10)
    pred, target = (rng.uniform(-1, 1, (2, 12, 9, 3)).astype(np.float32)
                    for _ in range(2))
    np.testing.assert_allclose(
        sobel_magnitude(_t(pred)).numpy(),
        np.asarray(jsobel.sobel_magnitude(jnp.asarray(pred))), **OP_TOL)
    got, want = _vjp_pair(jsobel.sobel_edge_loss, sobel_edge_loss,
                          (pred, target), (_t(pred), _t(target)))
    np.testing.assert_allclose(
        float(sobel_edge_loss(_t(pred), _t(target))),
        float(jsobel.sobel_edge_loss(jnp.asarray(pred), jnp.asarray(target))),
        rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **OP_TOL)
