"""The port's consistency distillation trainer against the JAX package, on
the CPU.

Tiny fp32 configs on both sides and the same randomised weights through
the port's weight bridge: a teacher, a student and an EMA target that
differ from one another (so a network used in the wrong place shows),
and the VAE.  The same batch (numpy seeds, text and uncond embeddings
that differ) and JAX's own draws (`jax.random` splits of the step's key,
handed to the port's `loss_fn`):
  * `ddim_step` at [B] and int timesteps, "to x0" included;
  * `consistency_fn` (and its identity at t = 0) and `teacher_eps`, with
    FreeU on and off;
  * `loss_fn`'s value and every student gradient (UNet and ControlNet,
    mapped through the name maps) against `jax.value_and_grad` of JAX's
    `ConsistencyDistiller.loss_fn`, Huber with FreeU and L2 without;
  * two `train_step`s: masters, EMA and Adam's moments against JAX's
    `train_step` (`make_optimizer` at the distillation script's settings);
  * with bf16 networks, the noisy samples in the image's dtype, as JAX
    casts them;
  * the `DistillState` checkpoint: a resumed step bit-identical to an
    uninterrupted one, rotation, and the EMA put into fresh modules.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule
from diffcodec_tpu.train import distill as jdistill
from diffcodec_tpu.train import trainer as jtrainer

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from diffcodec_tpu_torch.train import checkpoint as tckpt
from diffcodec_tpu_torch.train import distill as tdistill
from diffcodec_tpu_torch.train.trainer import Optimizer
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

# fp32 through the encoder, three ControlNet + UNet calls and their
# backward: sums in another order in XLA and PyTorch's CPU kernels (the
# tolerances of tests/test_torch_port_train.py).  A gradient tensor is
# held to 1e-4 of its own largest value and of each element, plus 1e-6 of
# the largest gradient of all; the loss to 1e-6.  At 64 px, as there: at
# 32 px the tiny UNet's bottom is 1 x 1 and flax's GroupNorm (E[x^2] -
# E[x]^2 in fp32) loses most of its digits over such groups, which
# throws JAX's gradients 1e-3 off an fp64 run of the port (the port's
# fp32 run: 3e-4 off it, its GroupNorm two-pass); at 64 px JAX and the
# port are both ~1e-6 off it.
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6
LOSS_RTOL = 1e-6
# the consistency function and the teacher's eps: x0 divides by
# sqrt(abar_t) (0.068 at t = 999), which magnifies the networks' ~1e-6
# differences of summation order (tests/test_torch_port_distilled.py)
F_TOL = dict(atol=1e-4, rtol=1e-4)
# ddim_step: the same fp32 operations; XLA's CPU square root is not
# IEEE-rounded (tests/test_torch_port_distilled.py), so a few ulps
DDIM_TOL = dict(atol=1e-6, rtol=1e-6)

VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
B, RES, L_TEXT = 2, 64, 5
# the distillation script's optimizer (adam_weight_decay 0, clip 1.0),
# at lr 1e-3 so that an update stands well above fp32's rounding of the
# weights.  Adam moves an element by lr * m / (sqrt(v) + eps): where its
# gradient is rounding noise (the two sides agree to 1e-4 of a tensor's
# largest gradient, ~1.6e-6 after the clip here), the move is noise of up
# to lr.  eps 1e-4 bounds that to ~2% of lr; at 1e-6 (test_torch_port_
# train.py's) 2 of 9216 weights of a conv moved 10% of lr apart, their
# gradients 1.5e-5 of the tensor's largest.
TRAIN_KW = dict(learning_rate=1e-3, adam_weight_decay=0.0, adam_epsilon=1e-4)
# ema_decay 0.9 (the JAX package's own test's): the EMA's move stands
# 10x further above the weights' rounding than at 0.995
EMA_DECAY = 0.9
# Adam's moments after two steps, relative norm per tensor (see the
# test); the worst reads 3.3e-4
MOMENT_REL_NORM = 3e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _randomize(params, seed):
    """Seeded float32 values for every leaf: norm scales near 1, small
    biases, kernels ~ N(0, 1/fan_in)."""
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
    h = RES // 8
    key = jax.random.PRNGKey(0)
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L_TEXT, 32))
    unet_shape = jax.eval_shape(JUNet(jcfg.UNetConfig.tiny()).init, key,
                                sample, t0, ctx)
    cn_shape = jax.eval_shape(
        JControlNet(jcfg.ControlNetConfig.tiny()).init, key, sample, t0, ctx,
        jnp.zeros((1, RES, RES, 6)), jnp.zeros((1, RES, RES, 4)))
    nets = {role: {"unet": _randomize(unet_shape, 10 * i + 1),
                   "controlnet": _randomize(cn_shape, 10 * i + 2)}
            for i, role in enumerate(("teacher", "student", "ema"))}
    vae = _randomize(jax.eval_shape(JVAE(jcfg.VAEConfig(**VAE_KW)).init, key,
                                    jnp.zeros((1, RES, RES, 3))), 40)
    rng = np.random.default_rng(4)
    batch = dict(
        image=rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32),
        cond=rng.uniform(0, 1, (B, RES, RES, 6)).astype(np.float32),
        flow=(rng.standard_normal((B, RES, RES, 4)) * 3).astype(np.float32),
        text_embeds=(rng.standard_normal((B, L_TEXT, 32)) * 0.5).astype(
            np.float32),
        uncond_embeds=(rng.standard_normal((B, L_TEXT, 32)) * 0.5).astype(
            np.float32))
    return dict(nets=nets, vae=vae, batch=batch)


def _jax_distiller(**cfg):
    return jdistill.ConsistencyDistiller(
        unet=JUNet(jcfg.UNetConfig.tiny()),
        controlnet=JControlNet(jcfg.ControlNetConfig.tiny()),
        vae=JVAE(jcfg.VAEConfig(**VAE_KW)),
        schedule=JSchedule.create(jcfg.SchedulerConfig()),
        config=jcfg.DistillConfig(**cfg))


def _port_net(params):
    ucfg, ccfg = tcfg.UNetConfig.tiny(), tcfg.ControlNetConfig.tiny()
    unet, cn = UNet2DConditionModel(ucfg), DualFlowControlNet(ccfg)
    weights.load_flax_params(unet, params["unet"], weights.unet_name_map(ucfg))
    weights.load_flax_params(cn, params["controlnet"],
                             weights.controlnet_name_map(ccfg))
    return tdistill.denoiser(unet, cn)


def _port_distiller(setup, target="ema", **cfg):
    """The port's distiller, fp32, on JAX's weights; the target's working
    copy from `target`'s weights."""
    vcfg = tcfg.VAEConfig(**VAE_KW)
    vae = AutoencoderKL(vcfg)
    weights.load_flax_params(vae, setup["vae"], weights.vae_name_map(vcfg))
    nets = setup["nets"]
    return tdistill.ConsistencyDistiller(
        teacher=_port_net(nets["teacher"]),
        student=_port_net(nets["student"]), target=_port_net(nets[target]),
        vae=vae, schedule=NoiseSchedule.create(tcfg.SchedulerConfig()),
        config=tcfg.DistillConfig(**cfg))


def _frozen(setup):
    t = setup["nets"]["teacher"]
    return {"unet": t["unet"], "controlnet": t["controlnet"],
            "vae": setup["vae"]}


def _jbatch(setup):
    return {k: jnp.asarray(v) for k, v in setup["batch"].items()}


def _tbatch(setup):
    return {k: _t(v) for k, v in setup["batch"].items()}


def _draws(rng, n_teacher=50):
    """JAX's loss_fn draws from `rng`, for the port: latent_eps, idx,
    noise."""
    rng_n, rng_t, rng_lat = jax.random.split(rng, 3)
    shape = (B, RES // 8, RES // 8, 4)
    return dict(latent_eps=_t(jax.random.normal(rng_lat, shape, jnp.float32)),
                idx=_t(jax.random.randint(rng_t, (B,), 0, n_teacher - 1)),
                noise=_t(jax.random.normal(rng_n, shape, jnp.float32)))


def _torch_layout(tree):
    """A {'unet', 'controlnet'} flax tree -> `denoiser`-named numpy."""
    out = {}
    for name, name_map in (
            ("unet", weights.unet_name_map(tcfg.UNetConfig.tiny())),
            ("controlnet", weights.controlnet_name_map(
                tcfg.ControlNetConfig.tiny()))):
        out.update({f"{name}.{k}": v for k, v in
                    weights.export_state_dict(tree[name], name_map).items()})
    return out


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        atol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_FLOOR * top
        np.testing.assert_allclose(got[name].numpy(), w, rtol=GRAD_RTOL,
                                   atol=atol, err_msg=name)


def test_ddim_step_matches_jax():
    jsched = JSchedule.create(jcfg.SchedulerConfig())
    tsched = NoiseSchedule.create(tcfg.SchedulerConfig())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((4, 4, 4, 4)).astype(np.float32)
    t = np.array([999, 700, 300, 19], np.int32)
    t_prev = np.array([979, 500, 100, -1], np.int32)
    want = jdistill.ddim_step(jsched, jnp.asarray(x), jnp.asarray(eps),
                              jnp.asarray(t), jnp.asarray(t_prev))
    got = tdistill.ddim_step(tsched, _t(x), _t(eps), _t(t).long(),
                             _t(t_prev).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DDIM_TOL)
    # ints, and "to x0": the x0 prediction itself
    got = tdistill.ddim_step(tsched, _t(x), _t(eps), 19, -1)
    want = jdistill.ddim_step(jsched, jnp.asarray(x), jnp.asarray(eps),
                              jnp.asarray(19), jnp.asarray(-1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DDIM_TOL)
    np.testing.assert_allclose(
        got.numpy(), tsched.pred_original_sample(_t(x), _t(eps), 19).numpy(),
        **DDIM_TOL)


@pytest.mark.parametrize("freeu", [True, False])
def test_consistency_fn_and_teacher_eps_match_jax(setup, freeu):
    jd = _jax_distiller(freeu=freeu)
    td = _port_distiller(setup, freeu=freeu)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, RES // 8, RES // 8, 4)).astype(np.float32)
    t = np.array([999, 407], np.int32)
    b = setup["batch"]
    args = (b["text_embeds"], b["cond"], b["flow"])
    want = jax.jit(jd.consistency_fn)(
        setup["nets"]["student"], jnp.asarray(x), jnp.asarray(t),
        *map(jnp.asarray, args))
    with torch.no_grad():
        got = td.consistency_fn(td.student, _t(x), _t(t).long(),
                                *map(_t, args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F_TOL)

    want = jax.jit(jd.teacher_eps)(
        _frozen(setup), jnp.asarray(x), jnp.asarray(t),
        *map(jnp.asarray, (b["text_embeds"], b["uncond_embeds"], b["cond"],
                           b["flow"])))
    got = td.teacher_eps(_t(x), _t(t).long(), *map(_t, (
        b["text_embeds"], b["uncond_embeds"], b["cond"], b["flow"])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F_TOL)

    # the boundary condition: f(x, 0) = x exactly, whatever the network
    with torch.no_grad():
        f0 = td.consistency_fn(td.student, _t(x), torch.zeros(B,
                                                              dtype=torch.long),
                               *map(_t, args))
    torch.testing.assert_close(f0, _t(x), atol=0, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(cfg_items):
    jd = _jax_distiller(**dict(cfg_items))
    return jax.jit(jax.value_and_grad(jd.loss_fn, has_aux=True))


@pytest.mark.parametrize("loss,freeu", [("huber", True), ("l2", False)])
def test_loss_fn_and_gradients_match_jax(setup, loss, freeu):
    cfg = dict(loss=loss, freeu=freeu)
    rng = jax.random.PRNGKey(7)
    nets = setup["nets"]
    (want_loss, want_metrics), want_grads = _jax_grad_fn(
        tuple(sorted(cfg.items())))(nets["student"], nets["ema"],
                                    _frozen(setup), _jbatch(setup), rng)
    td = _port_distiller(setup, **cfg)
    draws = _draws(rng)
    loss_t, metrics = td.loss_fn(_tbatch(setup), **draws)
    loss_t.backward()
    want_loss = float(want_loss)
    assert abs(loss_t.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert metrics["t_mean"].item() == float(want_metrics["t_mean"])
    grads = {n: p.grad for n, p in td.student.named_parameters()}
    assert all(g is not None for g in grads.values())
    _assert_grads_close(grads, _torch_layout(want_grads))
    # the UNet trains too, FreeU's scaled paths included
    assert any(n.startswith("unet.up_blocks") and g.abs().sum() > 0
               for n, g in grads.items())
    # nothing flows into the teacher, the target or the VAE
    assert all(p.grad is None for m in (td.teacher, td.target, td.vae)
               for p in m.parameters())


def _adam_moments(opt_state):
    adam = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return adam[0].mu, adam[0].nu


def _port_trainable(setup):
    """The port's distiller with the target at the student's weights (a
    new state's EMA), and its state."""
    td = _port_distiller(setup, target="student", ema_decay=EMA_DECAY)
    state = tdistill.DistillState.create(
        dict(td.student.named_parameters()),
        Optimizer(tcfg.TrainConfig(**TRAIN_KW)))
    return td, state


def _step(td, state, setup, step):
    rng = jax.random.fold_in(jax.random.PRNGKey(9), step)
    return td.train_step(state, _tbatch(setup), **_draws(rng))


def test_train_step_matches_jax(setup):
    """Two steps from a new state against JAX's `train_step` fed the same
    key: the masters, the EMA and Adam's moments after the second (the
    elementwise gradient check is `test_loss_fn_and_gradients_match_jax`'s
    business)."""
    jd = _jax_distiller(ema_decay=EMA_DECAY)
    jstate = jdistill.DistillState.create(
        setup["nets"]["student"],
        jtrainer.make_optimizer(jcfg.TrainConfig(**TRAIN_KW)))
    step_fn = jax.jit(jd.train_step)
    td, state = _port_trainable(setup)
    before = {n: p.clone() for n, p in state.params.items()}
    for step in range(2):
        jstate, jm = step_fn(jstate, _frozen(setup), _jbatch(setup),
                             jax.random.PRNGKey(9))
        state, metrics = _step(td, state, setup, step)
    assert state.step == 2 and state.opt_state["count"] == 2
    # the second step's loss, at masters and an EMA already apart by the
    # first move's noise (see below): 10 x LOSS_RTOL
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]),
                               rtol=10 * LOSS_RTOL)
    lr = TRAIN_KW["learning_rate"]
    for key, want_tree, scale in (
            ("params", jstate.params, lr),
            ("ema_params", jstate.ema_params, lr * (1 - EMA_DECAY))):
        want = _torch_layout(want_tree)
        got = getattr(state, key)
        for name, w in want.items():
            # hold each weight's move to 2% of the move's scale a step
            # (test_torch_port_train.py's one-step limit, once per step)
            np.testing.assert_allclose(
                got[name].numpy() - before[name].numpy(),
                w - before[name].numpy(), rtol=0, atol=0.02 * scale * 2,
                err_msg=f"{key} {name}")
    # the second step's gradient is taken at masters and an EMA that
    # already differ by the first move's noise (up to 2% of lr at the
    # weights whose gradient is noise), so its elementwise error is no
    # longer the gradient tolerance: each moment tensor is held in norm,
    # to MOMENT_REL_NORM of its own plus the gradient tolerance's floor
    # (GRAD_FLOOR of the largest moment, per element, once a step for mu
    # and twice for nu) for the tensors whose gradient is exactly 0 and
    # both sides hold rounding noise
    mu, nu = _adam_moments(jstate.opt_state)
    for key, tree, factor in (("mu", mu, 2.0), ("nu", nu, 4.0)):
        want = _torch_layout(tree)
        top = max(float(np.abs(w).max()) for w in want.values())
        for name, w in want.items():
            got = state.opt_state[key][name].numpy()
            limit = (MOMENT_REL_NORM * np.linalg.norm(w)
                     + factor * GRAD_FLOOR * top * np.sqrt(w.size))
            assert np.linalg.norm(got - w) <= limit, (key, name)
    # the working copies hold the masters and the EMA
    for net, params in ((td.student, state.params),
                        (td.target, state.ema_params)):
        for n, p in net.named_parameters():
            torch.testing.assert_close(p.detach(), params[n], atol=0, rtol=0)


def _sample_dtypes(consistency_fn):
    """A wrapper of a `consistency_fn` (JAX's or the port's) that records
    the dtype of each noisy sample it is given, and the list it fills."""
    seen = []

    def wrapped(self, net, x, *args, **kwargs):
        seen.append(str(x.dtype).replace("torch.", ""))
        return consistency_fn(self, net, x, *args, **kwargs)

    return wrapped, seen


@pytest.mark.parametrize("image", ["float32", "bfloat16"])
def test_noisy_samples_take_the_images_dtype(setup, image):
    """Both noisy samples, x_tn (the student's) and x_tm (the target's),
    in the image's dtype whatever the networks' (JAX's `distill.py:201`,
    `:210`): bf16 networks given the script's fp32 frames see fp32 samples,
    and the boundary term c_skip(t) x keeps them unrounded.  Read from
    JAX's loss_fn traced with bf16 modules (shapes only) and the port's run
    in bf16."""
    jd = jdistill.ConsistencyDistiller(
        unet=JUNet(jcfg.UNetConfig.tiny(), dtype=jnp.bfloat16),
        controlnet=JControlNet(jcfg.ControlNetConfig.tiny(),
                               dtype=jnp.bfloat16),
        vae=JVAE(jcfg.VAEConfig(**VAE_KW), dtype=jnp.bfloat16),
        schedule=JSchedule.create(jcfg.SchedulerConfig()),
        config=jcfg.DistillConfig())
    wrapped, want = _sample_dtypes(
        jdistill.ConsistencyDistiller.consistency_fn)
    batch = {k: jax.ShapeDtypeStruct(v.shape, jnp.dtype(image)
                                     if k == "image" else jnp.float32)
             for k, v in setup["batch"].items()}
    nets = setup["nets"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdistill.ConsistencyDistiller, "consistency_fn", wrapped)
        jax.eval_shape(jd.loss_fn, nets["student"], nets["ema"],
                       _frozen(setup), batch, jax.random.PRNGKey(7))

    td = _port_distiller(setup)
    for m in (td.teacher, td.student, td.target, td.vae):
        m.to(torch.bfloat16)
    wrapped, got = _sample_dtypes(tdistill.ConsistencyDistiller.consistency_fn)
    tbatch = {k: v.to(getattr(torch, image)) if k == "image"
              else v if k == "flow" else v.to(torch.bfloat16)
              for k, v in _tbatch(setup).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdistill.ConsistencyDistiller, "consistency_fn", wrapped)
        with torch.no_grad():
            td.loss_fn(tbatch, **_draws(jax.random.PRNGKey(7)))
    assert want == [image, image] and got == want, (want, got)


def test_distill_checkpoint_resume_is_bit_identical(setup, tmp_path):
    """Three steps uninterrupted against two, a save, a restore into a
    fresh distiller and state, and the third: bit-identical masters, EMA,
    moments and working copies.  Rotation keeps the newest checkpoints,
    and the EMA goes into fresh modules through `load_student`."""
    td, state = _port_trainable(setup)
    d = str(tmp_path / "run")
    for step in range(2):
        state, _ = _step(td, state, setup, step)
        tdistill.save_distill_checkpoint(d, state, total_limit=1)
    assert [s for s, _ in tckpt.list_checkpoints(d)] == [2]
    state, _ = _step(td, state, setup, 2)

    td2, state2 = _port_trainable(setup)
    restored, step = tdistill.restore_distill_checkpoint(d, state2)
    assert restored is state2 and step == 2 and state2.step == 2
    assert state2.opt_state["count"] == 2
    td2.load_params(state2)
    state2, _ = _step(td2, state2, setup, 2)
    for key in ("params", "ema_params"):
        for n, p in getattr(state, key).items():
            torch.testing.assert_close(getattr(state2, key)[n], p, atol=0,
                                       rtol=0)
    for key in ("mu", "nu"):
        for n, p in state.opt_state[key].items():
            torch.testing.assert_close(state2.opt_state[key][n], p, atol=0,
                                       rtol=0)
    for n, p in td.student.named_parameters():
        torch.testing.assert_close(dict(td2.student.named_parameters())[n],
                                   p, atol=0, rtol=0)

    saved, step = tckpt.restore_checkpoint(d)
    ema = saved["ema_params"]
    assert step == 2
    unet = UNet2DConditionModel(tcfg.UNetConfig.tiny()).to(torch.bfloat16)
    cn = DualFlowControlNet(tcfg.ControlNetConfig.tiny()).to(torch.bfloat16)
    tdistill.load_student(unet, cn, ema)
    for n, p in tdistill.denoiser(unet, cn).named_parameters():
        assert p.dtype == torch.bfloat16
        torch.testing.assert_close(p, ema[n].to(torch.bfloat16), atol=0,
                                   rtol=0)
    with pytest.raises(KeyError, match="names differ"):
        tdistill.load_student(unet, cn, {"unet.conv_in.weight":
                                         ema["unet.conv_in.weight"]})
