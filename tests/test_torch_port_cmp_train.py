"""The port's CMP trainer (`train/cmp_train.py`) against the JAX package's
`train/cmp_train.py`, on the CPU.

The bins exactly, the losses to 1e-6, the schedule and the samplers bit
for bit, and two training steps of each trainer configuration (resnet50
with the skip, plain (1, 2, 4) and flownet decoders, alexnet_fcn_32x with
plain (1,)) against `jax.value_and_grad` of JAX's loss and its optax
chain: the loss to 1e-5, the parameters, the BatchNorm statistics and the
momentum to 1e-4 relative (atol 1e-6).  The JAX package cannot take its
own AlexNet step (its `loss_fn` gives flax's dropout no RNG, and the two
`nn.Dropout`s raise `InvalidRngError`), so that test computes JAX's loss
with a dropout key itself and hands the port JAX's masks.
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch

from diffcodec_tpu.models import cmp as jcmp
# imported here: JAX's `_flow_edge` imports it inside the function, and a
# first import under jit would make its module-level kernel a tracer
from diffcodec_tpu.ops import sobel as _jsobel  # noqa: F401
from diffcodec_tpu.train import cmp_train as jtrain

from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models import cmp
from diffcodec_tpu_torch.train import cmp_train
from torch_threads import few_torch_threads


_one_torch_thread = few_torch_threads(1)


def _edge_sweep(nbins=99, fmax=50.0):
    """fp32 values from -51 to 51: every bin edge, its neighbours one ulp
    away, the clip limits and a uniform grid."""
    step = np.float32(2 * fmax / nbins)
    edges = (np.arange(nbins + 1, dtype=np.float32) * step
             - np.float32(fmax))
    lim = np.float32(fmax - 1e-3)
    base = np.concatenate([edges, [lim, -lim, fmax, -fmax],
                           np.linspace(-51, 51, 4001, dtype=np.float32)])
    vals = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])
    return vals.astype(np.float32)


def test_quantize_flow_bins_are_jaxs():
    """The bins of JAX's jitted `quantize_flow`, which its training step
    computes: XLA multiplies by the step's fp32 reciprocal.  JAX's eager
    call divides, and puts 3 of the sweep's values (bin edges' neighbours)
    in the next bin."""
    v = _edge_sweep()
    flow = v.reshape(1, 1, -1, 1).repeat(2, -1)
    want = np.asarray(jax.jit(jtrain.quantize_flow)(jnp.asarray(flow)))
    got = cmp_train.quantize_flow(torch.from_numpy(flow)).numpy()
    assert got.min() == 0 and got.max() == 98
    np.testing.assert_array_equal(got, want)
    eager = np.asarray(jtrain.quantize_flow(jnp.asarray(flow)))
    apart = np.nonzero(eager[0, 0, :, 0] != want[0, 0, :, 0])[0]
    assert 0 < len(apart) <= 3
    assert np.abs(eager - want).max() == 1


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 12, 18)).astype(np.float32) * 3
    flow = rng.uniform(-60, 60, (2, 8, 12, 2)).astype(np.float32)
    want = float(jax.jit(lambda a, b: jtrain.discrete_flow_loss(
        a, b, 9, 50.0))(logits, flow))
    got = cmp_train.discrete_flow_loss(torch.from_numpy(logits),
                                       torch.from_numpy(flow), 9, 50.0)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    pred = rng.standard_normal((2, 8, 12, 2)).astype(np.float32) * 4
    target = rng.standard_normal((2, 16, 24, 2)).astype(np.float32) * 4
    for p in (pred, target + 0.3):  # resized to the target, and not
        want = float(jax.jit(jtrain.edge_aware_loss)(p, target))
        got = cmp_train.edge_aware_loss(torch.from_numpy(p),
                                        torch.from_numpy(target))
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("args, kw", [
    ((0.1, (24000, 36000), (0.1, 0.1)), {}),
    ((0.1, (80000, 120000), (0.1, 0.1)),
     dict(warmup_lr=(0.4,), warmup_steps=(10000,))),
    ((0.01, (100, 200), (0.1, 0.1)),
     dict(warmup_lr=(0.1, 0.05), warmup_steps=(10, 30))),
])
def test_lr_schedule_is_jaxs_bit_for_bit(args, kw):
    """Steps 0 to 45000 through JAX's jitted schedule (as optax calls it
    inside the jitted step, on an int32 count): the shipped config, the
    AlexNet config's warmup, and two warmup segments."""
    jsched = jax.jit(jtrain.cmp_lr_schedule(*args, **kw))
    steps = range(0, 45001)
    want = np.asarray([np.asarray(jsched(jnp.int32(s))) for s in steps],
                      np.float32)
    sched = cmp_train.cmp_lr_schedule(*args, **kw)
    got = np.asarray([sched(s) for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)


def test_samplers_are_jaxs():
    for n, world in ((10, 4), (100, 3), (7, 1)):
        for r in range(world):
            np.testing.assert_array_equal(
                cmp_train.distributed_sequential_indices(n, world, r),
                jtrain.distributed_sequential_indices(n, world, r))
    for n, it, b, world, last in ((100, 5, 4, 2, -1), (100, 5, 4, 2, 2),
                                  (6, 7, 2, 1, -1), (6, 7, 2, 1, 3),
                                  (1000, 50, 8, 4, 17)):
        for r in range(world):
            np.testing.assert_array_equal(
                cmp_train.distributed_given_iteration_indices(
                    n, it, b, world, r, last_iter=last),
                jtrain.distributed_given_iteration_indices(
                    n, it, b, world, r, last_iter=last))


def _randomize(shapes, seed):
    """Seeded fp32 variables: kernels ~ N(0, 1.3 / fan_in), BatchNorm
    scales and variances in [0.5, 1.5], small biases and means."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(p.shape[:-1]))
            v = rng.standard_normal(p.shape) * np.sqrt(1.3 / fan_in)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, p.shape)
        else:
            v = rng.uniform(-0.1, 0.1, p.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(B, H, seed):
    rng = np.random.default_rng(seed)
    image = rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32)
    sparse = np.zeros((B, H, H, 4), np.float32)
    for b in range(B):
        ys, xs = rng.integers(0, H, 20), rng.integers(0, H, 20)
        sparse[b, ys, xs, :2] = rng.uniform(-20, 20, (20, 2))
        sparse[b, ys, xs, 2:] = 1.0
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, H),
                         indexing="ij")
    a = rng.uniform(-30, 30, (B, 2, 3, 1, 1))
    flow = np.stack([a[:, i, 0] * xx + a[:, i, 1] * yy + a[:, i, 2]
                     for i in range(2)], -1).astype(np.float32)
    return {"image": image, "sparse": sparse, "flow_target": flow}


VARIANTS = {
    "resnet50_skip": (dict(backbone="resnet50", decoder="skip"), 64),
    "resnet50_plain": (dict(backbone="resnet50", decoder="plain",
                            combo=(1, 2, 4)), 64),
    "resnet50_flownet": (dict(backbone="resnet50", decoder="flownet"), 96),
    "alexnet_fcn_32x_plain": (dict(backbone="alexnet_fcn_32x",
                                   decoder="plain", combo=(1,)), 128),
}
NBINS, LR = 9, 0.05


def _close(label, got, want, rtol=1e-4, atol=1e-6):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{label}: {k}")


def _steps(name, dtype, n_steps, monkeypatch, H=None):
    """`n_steps` training steps of both packages in `dtype` from the same
    variables and batches.  Returns (JAX's and the port's losses, JAX's
    params, batch_stats and momentum trace as torch-named numpy dicts,
    the port's trainer).  H defaults to the variant's size."""
    kw, size = VARIANTS[name]
    H = H or size
    dims = dict(img_enc_dim=16, sparse_enc_dim=4, nbins=NBINS, fmax=50.0)
    jnp_dtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    jmodel = jcmp.CMP(**dims, **kw, dtype=jnp_dtype)
    variables = jax.tree.map(
        lambda v: v.astype(jnp_dtype),
        _randomize(jax.eval_shape(
            jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, H, H, 3)),
            jnp.zeros((1, H, H, 4))), 3))
    model = cmp.CMP(**dims, **kw)
    weights.load_cmp_params(model, variables)
    pmap, smap = weights.cmp_maps(model)
    tx = jtrain.make_cmp_optimizer(LR, (1,), (0.5,))
    trainer = cmp_train.CMPTrainer(
        model.to(dtype), cmp_train.make_cmp_optimizer(LR, (1,), (0.5,)),
        NBINS)
    alexnet = kw["backbone"].startswith("alexnet")
    jtrainer = jtrain.CMPTrainer(model=jmodel, nbins=NBINS)

    def jloss(params, bs, batch, key):
        """JAX's `loss_fn`, given the dropout RNG it lacks, capturing the
        Dropouts' outputs."""
        logits, state = jmodel.apply(
            {"params": params, "batch_stats": bs}, batch["image"],
            batch["sparse"], True, rngs={"dropout": key},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout),
            method=jmodel.logits)
        loss = jtrain.discrete_flow_loss(
            logits, jtrain._downsample_target(
                batch["flow_target"], logits.shape[1], logits.shape[2]),
            NBINS, 50.0)
        return loss, (state["batch_stats"], state["intermediates"])

    @jax.jit
    def jstep(params, bs, opt_state, batch, key):
        if not alexnet:  # the package's own step
            p, b, o, loss = jtrainer.train_step(params, bs, opt_state, tx,
                                                batch)
            return p, b, o, loss, None
        (loss, (b, inter)), grads = jax.value_and_grad(
            jloss, has_aux=True)(params, bs, batch, key)
        updates, o = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), b, o, loss, inter

    masks = []
    monkeypatch.setattr(cmp.Dropout, "mask",
                        lambda self, shape, device, gen: masks.pop(0))
    params, bs = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    losses = []
    for step in range(n_steps):
        batch = {k: v.astype(jnp_dtype)
                 for k, v in _batch(2, H, 10 + step).items()}
        params, bs, opt_state, jl, inter = jstep(
            params, bs, opt_state, batch, jax.random.PRNGKey(step))
        if alexnet:
            enc = inter["image_encoder"]
            for d in ("Dropout_0", "Dropout_1"):
                out = np.asarray(enc[d]["__call__"][0])
                masks.append(torch.from_numpy(out != 0).permute(0, 3, 1, 2))
            # kept and positive after the ReLU: about half of a half
            assert 0.1 < masks[0].float().mean() < 0.5
        got = trainer.train_step({k: torch.from_numpy(np.asarray(v))
                                  for k, v in batch.items()})
        assert not masks
        losses.append((float(jl), got.item()))
    trace = opt_state[1][0].trace
    return (losses, weights.export_state_dict(params, pmap),
            weights.export_state_dict(bs, smap),
            weights.export_state_dict(trace, pmap), trainer)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_two_train_steps_match_jax(name, monkeypatch):
    """Two steps in float64 on both sides (JAX under x64 with the CMP's
    dtype float64, the port's model in float64): the loss to 1e-5, the
    parameters, BatchNorm statistics and momentum to 1e-4 (atol 1e-6).
    In fp32 the gradients at a random initialisation are ill-conditioned:
    each package's fp32 gradient of the encoder's BatchNorm parameters
    sits 3-8% from the float64 one (the port's 3-4%, JAX's 7-8%, at
    128 px), so fp32 holds what the forward sets, below.  The flownet
    variant runs at 96 px: at 64 px its pooled-by-8 branch normalises a
    1 x 1 map over 2 samples, which moves even the float64 momentum by up
    to 1e-5 of its norm in the second step."""
    with jax.enable_x64():
        losses, params, bs, trace, trainer = _steps(
            name, torch.float64, 2, monkeypatch)
    for jl, tl in losses:
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert trainer.opt_state["count"] == 2
    _close("params", {k: v.detach().numpy()
                      for k, v in trainer.params().items()}, params)
    _close("batch_stats", {k: v.numpy()
                           for k, v in trainer.batch_stats().items()}, bs)
    _close("momentum", {k: v.numpy()
                        for k, v in trainer.opt_state["trace"].items()},
           trace)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fp32_train_forward_matches_jax(name, monkeypatch):
    """fp32, one step at 128 px: the loss (the training-mode forward,
    BatchNorm from the batch) to 1e-4 and each running statistic after it
    to 1e-4 of its tensor's largest magnitude, looser than the float64
    test's: through ResNet-50's 53 BatchNorms over a batch of 2, each
    package's fp32 E[x^2] - E[x]^2 cancels in its own summation order
    (the loss lands up to 2e-5 apart, the decoder's first pooled running
    mean up to 2.8e-5 of its largest).  At 64 px the pooled-by-8 decoder branch normalises a
    1 x 1 map over the 2 samples, and the loss lands 1.5e-4 apart."""
    losses, _, bs, _, trainer = _steps(name, torch.float32, 1, monkeypatch,
                                       H=128)
    np.testing.assert_allclose(losses[0][1], losses[0][0], rtol=1e-4)
    got = {k: v.numpy() for k, v in trainer.batch_stats().items()}
    for k, want in bs.items():
        np.testing.assert_allclose(got[k], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_jax_alexnet_step_needs_the_dropout_rng():
    """The defect the port does not copy: JAX's own `CMPTrainer` cannot
    step the AlexNet configuration (`cmp_train.py:177-185` applies the
    model in training mode with no 'dropout' RNG)."""
    import flax.errors

    jmodel = jcmp.CMP(img_enc_dim=16, sparse_enc_dim=4, nbins=NBINS,
                      backbone="alexnet_fcn_32x", decoder="plain",
                      combo=(1,))
    variables = _randomize(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
        jnp.zeros((1, 128, 128, 4))), 3)
    batch = _batch(1, 128, 0)
    with pytest.raises(flax.errors.InvalidRngError):
        jtrain.CMPTrainer(model=jmodel, nbins=NBINS).loss_fn(
            variables["params"], variables["batch_stats"], batch)


def test_dropout_draws_from_the_generator_and_is_off_in_eval():
    d = cmp.Dropout(0.5)
    x = torch.ones(4, 8, 3, 3)
    a = d(x, torch.Generator().manual_seed(1))
    b = d(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(d.eval()(x, torch.Generator().manual_seed(1)), x)
