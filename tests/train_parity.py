"""The ControlNet training step, JAX against the port, on the CPU: what the
training parity tests share.

`draws`, `assert_grads_close` and their limits serve every such test
(`test_torch_port_train.py` and `test_torch_port_residual.py` at the tiny
configs).  `compare_step` runs one training step at SD-1.5's widths
(`test_torch_port_train_fullwidth.py`, one layer a block) or its depth
(`test_torch_port_train_fulldepth.py`), at `scripts/bench_train.py`'s
operating point (`:99-123`): AdamW at lr 1e-5, weight decay 1e-2, clip
1.0; 77 x 768 text; bf16 compute over fp32 ControlNet masters, the
frozen UNet and VAE in bf16.

Four runs of `loss_fn` and its gradient, on one set of seeded float32
parameters (`test_torch_port_fullwidth._draw`), one batch made by numpy
(frames of 64 px, batch 2) and JAX's own draws (`draws`):
  * JAX fp32: `jax.jit(jax.value_and_grad(ControlNetTrainer.loss_fn))`;
  * JAX bf16 as `bench_train.py` runs it: the modules' dtype bf16, the
    frozen parameters cast to bf16, the ControlNet's fp32;
  * the port fp32 and the port bf16, the trainer built by
    `chip_smoke.make_trainer` (the fused-conv VAE of `chip_smoke.
    train_models`), the batch cast as `chip_smoke` casts it.
Then, from each gradient, the masters after one update by each optimizer
(AdamW with fp32 moments and with `lowp_adam_moments`): JAX's optax chain
on JAX's gradient, the port's `ControlNetTrainer.update` (what
`train_step` runs after the backward) on its own.

One sample in every run.  JAX's `loss_fn` draws the posterior's eps in the
VAE's dtype (`diffcodec_tpu/train/trainer.py:223`), and
`jax.random.normal` in bf16 draws other bits than in fp32: a different
sample, not a rounding of it (`test_torch_port_train_fullwidth.py::
test_jax_draws_the_posterior_eps_anew_in_bf16`), so JAX's own bf16 error
would be another sample's and the rule blind.  JAX's bf16 run is traced
with that one draw made in fp32 and rounded to bf16, as the port rounds
the fp32 draw it is given; its other draws are its own.

What is compared, in the torch layout (`weights.export_state_dict`),
tensor by tensor so that no package's gradient is held twice:
  * fp32: the loss to LOSS_RTOL, every gradient element at GRAD_RTOL /
    GRAD_FLOOR, every master's move at 2% of lr at `test_torch_port_
    train.py`'s optimizer (its limits, SETTINGS['tiny']);
  * bf16: with relL2 over a group's tensors, e_jax = relL2(jax_bf16,
    jax_fp32), e_port = relL2(port_bf16, jax_fp32) and d =
    relL2(port_bf16, jax_bf16), each gradient group and the whole
    gradient, then (where the variant asks) each optimizer's move by
    group and whole, by `chip_smoke.within_bf16_rule`; the loss, one
    scalar, to `chip_smoke.TRAIN_REF_TOL`'s loss_rel of JAX's fp32.
The groups (`chip_smoke.train_group`): the extractor, the trunk's input
(conv_in and the time embedding), the FDNs, each down block, the mid
block, each down zero-conv head and the mid head.
"""

import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import resource
import threading
import time
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.controlnet import ResControlNet as JResControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule
from diffcodec_tpu.train import residue as jresidue
from diffcodec_tpu.train import trainer as jtrainer

from chip_smoke import (TRAIN_REF_TOL, GroupSums, make_trainer, train_group,
                        within_bf16_rule)
from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models.controlnet import (DualFlowControlNet,
                                                  ResControlNet)
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.train import trainer as ttrainer
from test_torch_port_fullwidth import _draw

# fp32 through the encoder, the ControlNet and the UNet, forward and
# backward: convs, matmuls and GroupNorm statistics sum in another order in
# XLA and in PyTorch's CPU kernels.  A gradient tensor is held to 1e-4 of
# its own largest value and of each element, plus 1e-6 of the largest
# gradient of all: the biases that a GroupNorm follows have an exact
# gradient of 0, which both sides compute as rounding noise of ~1e-9.  The
# loss is held to 1e-6.
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6
LOSS_RTOL = 1e-6
# a master's move after one update, as a share of lr (Adam's first step is
# ~lr a weight)
MOVE_ATOL_LR = 0.02


def _t(a):
    return torch.from_numpy(np.array(a))


def draws(rng, batch: int, res: int) -> dict:
    """JAX's loss_fn draws from `rng` (`trainer.py:207-229`), as torch
    tensors: noise, timesteps and the posterior's eps, fp32."""
    rng_noise, rng_t, rng_lat = jax.random.split(rng, 3)
    shape = (batch, res // 8, res // 8, 4)
    return dict(noise=_t(jax.random.normal(rng_noise, shape, jnp.float32)),
                timesteps=_t(jax.random.randint(rng_t, (batch,), 0, 1000)),
                latent_eps=_t(jax.random.normal(rng_lat, shape,
                                                jnp.float32)))


def grad_ratio(got: torch.Tensor, want: torch.Tensor, top: float) -> float:
    """max |got - want| / (atol + GRAD_RTOL |want|) of one gradient tensor,
    atol = GRAD_RTOL max |want| + GRAD_FLOOR top (`top`: the largest
    gradient of all): at most 1 where it holds (NaN where either is)."""
    mag = want.abs()
    atol = GRAD_RTOL * float(mag.max()) + GRAD_FLOOR * top
    return float(torch.max((got - want).abs() / (atol + GRAD_RTOL * mag)))


def assert_grads_close(got, want):
    """Every gradient tensor of `got` (torch) at `want`'s (numpy, the same
    names) by `grad_ratio`."""
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        ratio = grad_ratio(got[name], torch.from_numpy(w), top)
        assert ratio <= 1.0, (name, ratio)


# ---- one training step at SD-1.5's widths ----

H, B, L = 64, 2, 77
# scripts/bench_train.py:99-101 (weight decay 1e-2, eps 1e-8 and clip 1.0
# are TrainConfig's defaults)
OPERATING = dict(learning_rate=1e-5, lr_warmup_steps=0, max_train_steps=100)
# test_torch_port_train.py::test_train_step_matches_jax's optimizer, at
# which its element-wise limit on the move holds: lr 1e-3 with decay 0.1,
# eps 1e-6 (Adam's step g / (|g| + eps) turns the gradients' fp32
# differences into differences of up to ~lr where |g| nears eps)
SETTINGS = {"operating": OPERATING,
            "tiny": dict(OPERATING, learning_rate=1e-3, adam_weight_decay=0.1,
                         adam_epsilon=1e-6)}
# bf16 moments first: the state `make_trainer` makes lives through the
# backward, and theirs is the smaller
OPTIMIZERS = {"lowp": {"lowp_adam_moments": True}, "adamw": {}}


@dataclasses.dataclass(frozen=True)
class Variant:
    """A training step to compare: the residual ControlNet (its batch from
    JAX's `make_residue_batch`) or the DualFlow one, `train` TrainConfig's
    loss terms, `optimizers` the updates whose moves are held.  After one
    update the two optimizers move the masters alike (the moments are
    stored after their use); `alone` tells them apart."""
    name: str
    residual: bool = False
    train: tuple = ()
    optimizers: tuple = tuple(OPTIMIZERS)
    # the moves from the bf16 runs at the operating point, by groups
    bf16_moves: bool = True
    # also two updates of each optimizer given JAX's fp32 gradient
    # (`_Step.optimizer_alone`)
    alone: bool = False


def groups(cfgs, residual: bool) -> list:
    """The gradient groups of a ControlNet, in the name map's order, and
    'all'."""
    names = [e[0] for e in _name_map(cfgs, residual)]
    return list(dict.fromkeys(train_group(n) for n in names)) + ["all"]


@dataclasses.dataclass(frozen=True)
class Configs:
    ju: object
    jc: object
    jv: object
    tu: object
    tc: object
    tv: object


def configs(layers_per_block: int) -> Configs:
    """SD-1.5's UNet and ControlNet at `layers_per_block`, VAEConfig()."""
    ju = jcfg.UNetConfig(layers_per_block=layers_per_block)
    tu = tcfg.UNetConfig(layers_per_block=layers_per_block)
    return Configs(ju, jcfg.ControlNetConfig(unet=ju), jcfg.VAEConfig(),
                   tu, tcfg.ControlNetConfig(unet=tu), tcfg.VAEConfig())


def _train_config(pkg, variant: Variant, opt: str = "lowp",
                  setting: str = "operating"):
    return pkg.TrainConfig(**SETTINGS[setting], **dict(variant.train),
                           **OPTIMIZERS[opt])


def _name_map(cfgs: Configs, residual: bool):
    return (weights.rescontrolnet_name_map(cfgs.tc) if residual
            else weights.controlnet_name_map(cfgs.tc))


@functools.lru_cache(maxsize=None)
def _shapes(cfgs: Configs, residual: bool) -> dict:
    """{network: JAX's parameter tree of ShapeDtypeStructs}."""
    key, h = jax.random.PRNGKey(0), H // 8
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L, cfgs.ju.cross_attention_dim))
    cond = (jnp.zeros((1, H, H, 6)), jnp.zeros((1, H, H, 4)))
    if residual:
        cn = jax.eval_shape(JResControlNet(cfgs.jc).init, key, sample, t0,
                            ctx, *cond, jnp.zeros((1, H, H, 3)))
    else:
        cn = jax.eval_shape(JControlNet(cfgs.jc).init, key, sample, t0, ctx,
                            *cond)
    return {"unet": jax.eval_shape(JUNet(cfgs.ju).init, key, sample, t0, ctx),
            "controlnet": cn,
            "vae": jax.eval_shape(JVAE(cfgs.jv).init, key,
                                  jnp.zeros((1, H, H, 3)))}


def _params(cfgs: Configs, residual: bool, names) -> dict:
    """Seeded float32 parameters of the networks `names`, as jax arrays
    (the same values at every call)."""
    seeds = {"unet": 0, "controlnet": 3 if residual else 1, "vae": 2}
    shapes = _shapes(cfgs, residual)
    return {name: jax.tree.map(jnp.asarray, _draw(shapes[name], seeds[name]))
            for name in names}


def _batch_shapes(residual: bool, text_dim: int) -> dict:
    """The batch's arrays' shapes and dtypes (float32)."""
    shapes = dict(image=(B, H, H, 3), cond=(B, H, H, 6), flow=(B, H, H, 4),
                  text_embeds=(B, L, text_dim))
    if residual:
        shapes.update(warped=(B, H, H, 3), residual=(B, H, H, 3))
    return {k: jax.ShapeDtypeStruct(v, jnp.float32)
            for k, v in shapes.items()}


def _batch(residual: bool, text_dim: int) -> dict:
    """numpy: frames in [-1, 1], anchors in [-1, 1] (in [0, 1] for the
    residue batch, which maps them), 2 N(0, 1) px flows, 0.1 N(0, 1)
    text; the residual variant's 'warped' and 'residual' made by JAX's
    `make_residue_batch`."""
    rng = np.random.default_rng(40 + residual)
    f32 = np.float32
    batch = dict(
        image=rng.uniform(-1, 1, (B, H, H, 3)).astype(f32),
        cond=rng.uniform(0 if residual else -1, 1, (B, H, H, 6)).astype(f32),
        flow=(2 * rng.standard_normal((B, H, H, 4))).astype(f32),
        text_embeds=(0.1 * rng.standard_normal((B, L, text_dim))).astype(f32))
    if residual:
        batch = {k: np.asarray(v) for k, v in jresidue.make_residue_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    return batch


@contextlib.contextmanager
def _eps_drawn_in_fp32():
    """While inside, `jax.random.normal`'s first call (the posterior's eps
    in JAX's loss_fn) draws in fp32 and rounds to the dtype asked; yields
    the dtypes asked, call by call."""
    normal = jax.random.normal
    asked = []

    def first_in_fp32(key, shape=(), dtype=jnp.float32):
        asked.append(jnp.dtype(dtype))
        if len(asked) == 1:
            return normal(key, shape, jnp.float32).astype(dtype)
        return normal(key, shape, dtype)

    with mock.patch.object(jax.random, "normal", first_in_fp32):
        yield asked


def _abstract(tree, dtype=None):
    """ShapeDtypeStructs of a tree of arrays or of structs (`dtype` in
    place of each leaf's where given)."""
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(
        x.shape, dtype or x.dtype), tree)


class _Programs:
    """JAX's jitted programs of a comparison, lowered from shapes on the
    calling thread and each compiled on a thread of its own (XLA compiles
    without holding the GIL), so that compiling overlaps the draws and the
    other runs."""

    def __init__(self):
        self._threads, self._done = {}, {}

    def start(self, key, lowered):
        def compile_():
            try:
                self._done[key] = lowered.compile()
            except BaseException as e:  # raised where the program is used
                self._done[key] = e

        self._threads[key] = threading.Thread(target=compile_, daemon=True)
        self._threads[key].start()

    def __getitem__(self, key):
        self._threads[key].join()
        out = self._done[key]
        if isinstance(out, BaseException):
            raise out
        return out


def _jax_trainer(cfgs, variant, dtype):
    cn_cls = JResControlNet if variant.residual else JControlNet
    return jtrainer.ControlNetTrainer(
        unet=JUNet(cfgs.ju, dtype=dtype),
        controlnet=cn_cls(cfgs.jc, dtype=dtype),
        vae=JVAE(cfgs.jv, dtype=dtype),
        schedule=JSchedule.create(jcfg.SchedulerConfig()),
        config=_train_config(jcfg, variant))


def start_programs(programs: _Programs, cfgs: Configs, variant: Variant):
    """Lower a variant's programs and start compiling them: jit(value_and
    _grad(loss_fn)) in fp32 and in bf16 (`bench_train.py`'s, the eps drawn
    as the module's docstring says), and the optimizer's update under each
    setting the variant's moves are held at."""
    shapes = _shapes(cfgs, variant.residual)
    batch = _batch_shapes(variant.residual, cfgs.ju.cross_attention_dim)
    rng = jax.ShapeDtypeStruct((2,), jnp.uint32)
    frozen = {"unet": shapes["unet"], "vae": shapes["vae"]}
    for name, dtype in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        fn = jax.jit(jax.value_and_grad(
            _jax_trainer(cfgs, variant, dtype).loss_fn, has_aux=True))
        args = (shapes["controlnet"],
                _abstract(frozen, jnp.bfloat16 if name == "bf16" else None),
                batch, rng)
        if name == "bf16":
            with _eps_drawn_in_fp32() as asked:
                lowered = fn.lower(*args)
            # the posterior's eps in the VAE's dtype, then the fp32 noise
            assert asked == [jnp.dtype(jnp.bfloat16),
                             jnp.dtype(jnp.float32)], asked
        else:
            lowered = fn.lower(*args)
        programs.start((variant.name, name), lowered)
    settings = ["tiny"] + (["operating"] if variant.bf16_moves
                           or variant.alone else [])
    for setting in settings if variant.optimizers else ():
        for opt in variant.optimizers:
            tx = jtrainer.make_optimizer(jcfg.TrainConfig(
                **SETTINGS[setting], **OPTIMIZERS[opt]))
            updates = 2 if variant.alone and setting == "operating" else 1
            for n in range(1, updates + 1):
                fn = jax.jit(functools.partial(_jax_updates, tx=tx, n=n))
                programs.start((variant.name, setting, opt, n),
                               fn.lower(shapes["controlnet"],
                                        shapes["controlnet"]))


def _jax_updates(params, grads, tx, n):
    """The masters after `n` updates by JAX's optimizer `tx`, each from
    `grads`, from a fresh state."""
    state = jtrainer.TrainState.create(params, tx)
    for _ in range(n):
        state = state.apply_gradients(grads)
    return state.params


class _Torch:
    """A JAX parameter tree's tensors in the torch layout, one at a time:
    the transform `weights.export_state_dict` applies to each name-map
    entry, as a torch view of JAX's buffer (read, never written)."""

    def __init__(self, tree, name_map):
        root = tree["params"] if "params" in tree else tree
        self.root, self.entries = root, {e[0]: e for e in name_map}

    def __getitem__(self, name) -> torch.Tensor:
        _, path, kind = self.entries[name]
        node = self.root
        for key in path:
            node = node[key]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # not writable
            return torch.from_numpy(weights._inverse_transform(kind, node))


def _bridge(module, tree, name_map, pop: bool):
    """`weights.load_flax_params` child by child (each entry of a module
    list on its own), so that one child's torch-layout copy at a time is
    transient; with `pop`, each child's JAX arrays are dropped from `tree`
    once it is loaded."""
    children = {}
    for tname, fpath, kind in name_map:
        parts = tname.split(".")
        key = ".".join(parts[:2]) if parts[1].isdigit() else parts[0]
        children.setdefault(key, []).append(
            (tname[len(key) + 1:], fpath, kind))
    root = tree["params"] if "params" in tree else tree
    for key, entries in children.items():
        weights.load_flax_params(module.get_submodule(key), tree, entries)
        if pop:
            for _, fpath, _ in entries:
                node = root
                for k in fpath[:-1]:
                    node = node[k]
                del node[fpath[-1]]
    assert {f"{k}.{t}" for k, es in children.items() for t, _, _ in es} == (
        set(module.state_dict()))


def _port_models(cfgs, variant, params) -> dict:
    """The port's fp32 UNet, ControlNet and fused-conv VAE (as
    `chip_smoke.train_models` makes them), each made on the meta device
    and filled by the bridge, a thread a network; the frozen networks'
    JAX parameters are emptied from `params` as the port takes them
    over."""
    cn_cls = ResControlNet if variant.residual else DualFlowControlNet
    made = {}

    def bridge(name, make, name_map):
        with torch.device("meta"):
            module = make()
        module = module.to_empty(device="cpu")
        _bridge(module, params[name], name_map, pop=name != "controlnet")
        made[name] = module

    threads = [threading.Thread(target=bridge, args=a) for a in (
        ("vae", lambda: AutoencoderKL(cfgs.tv, fused_conv=True),
         weights.vae_name_map(cfgs.tv)),
        ("unet", lambda: UNet2DConditionModel(cfgs.tu),
         weights.unet_name_map(cfgs.tu)),
        ("controlnet", lambda: cn_cls(cfgs.tc),
         _name_map(cfgs, variant.residual)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(made) == {"vae", "unet", "controlnet"}, sorted(made)
    del params["unet"], params["vae"]
    return made


def _port_batch(batch, residual, dtype) -> dict:
    """The batch as `chip_smoke` gives the trainer: DualFlow's frames,
    anchors and text in the compute dtype, the flows fp32 (`train_batch`);
    the residue batch fp32, the text in the compute dtype
    (`build_train_residual`)."""
    out = {}
    for k, v in batch.items():
        keep = k == "flow" or (residual and k != "text_embeds")
        out[k] = _t(v) if keep else _t(v).to(dtype)
    return out


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _rss_gb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() / 2 ** 30


class _Sampler:
    """The largest resident size seen since the last `take`, read every
    50 ms on a thread of its own until `stop`."""

    def __init__(self):
        self.peak, self._stop = 0.0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, _rss_gb())

    def take(self) -> float:
        peak, self.peak = max(self.peak, _rss_gb()), 0.0
        return peak

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _trim():
    """Hand the heap's free pages back (glibc), so that each stage's
    resident size is its own."""
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def _masters(p0, tx) -> "ttrainer.TrainState":
    """A TrainState over fresh contiguous fp32 copies of the masters `p0`
    (what `TrainState.create` makes of the ControlNet's parameters)."""
    params = {n: t.clone(memory_format=torch.contiguous_format)
              for n, t in p0.items()}
    return ttrainer.TrainState(step=0, params=params,
                               opt_state=tx.init(params), tx=tx)


class _Step:
    """One variant's comparison, stage by stage (`compare_step`).  The
    order keeps the resident size down: JAX's bf16 run (whose own
    temporaries are the largest) first, beside only the ControlNet's
    parameters and the frozen networks in bf16; the frozen networks drawn
    again in fp32 for JAX's fp32 run and handed to the port's bridge."""

    def __init__(self, cfgs, variant, programs, seed):
        self.cfgs, self.variant, self.programs = cfgs, variant, programs
        self.sampler = _Sampler()
        self.t0, self.laps = time.perf_counter(), {}
        self.batch = _batch(variant.residual, cfgs.ju.cross_attention_dim)
        self.name_map = _name_map(cfgs, variant.residual)
        self.names = [e[0] for e in self.name_map]
        self.rng = jax.random.PRNGKey(seed)
        self.out = {"variant": variant.name, "loss": {}, "grad": {},
                    "move": {}}
        self.grads = {}

    def lap(self, name):
        gc.collect()
        _trim()
        now = time.perf_counter()
        self.laps[name] = [now - self.t0, _rss_gb(), self.sampler.take()]
        self.t0 = now

    def jax_grad(self, name, frozen):
        jb = {k: jnp.asarray(v) for k, v in self.batch.items()}
        (loss, _), grads = self.programs[(self.variant.name, name)](
            self.params["controlnet"], frozen, jb, self.rng)
        jax.block_until_ready(grads)
        self.out["loss"][f"jax_{name}"] = float(loss)
        self.grads[name] = grads

    def jax_grads(self):
        frozen = ("unet", "vae")
        self.params = _params(self.cfgs, self.variant.residual,
                              ("controlnet",) + frozen)
        low = {k: jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                               self.params.pop(k)) for k in frozen}
        self.lap("draw")
        self.jax_grad("bf16", low)
        del low
        self.lap("jax_bf16")
        self.params.update(_params(self.cfgs, self.variant.residual, frozen))
        self.jax_grad("fp32", {k: self.params[k] for k in frozen})
        self.lap("jax_fp32")
        self.jf, self.jb = (_Torch(self.grads[k], self.name_map)
                            for k in ("fp32", "bf16"))
        self.top = max(float(jnp.abs(x).max())
                       for x in jax.tree.leaves(self.grads["fp32"]))
        p0 = _Torch(self.params["controlnet"], self.name_map)
        self.p0 = {n: p0[n] for n in self.names}

    def jax_new(self, setting, opt, dtype_name, updates=1) -> _Torch:
        """The masters after JAX's `updates` updates from its `dtype_name`
        run's gradient."""
        new = self.programs[(self.variant.name, setting, opt, updates)](
            self.params["controlnet"], self.grads[dtype_name])
        return _Torch(new, self.name_map)

    def port(self, dtype_name, dtype):
        """The port's loss and gradient in `dtype` (the frozen networks
        left in bf16, their next use); returns the trainer."""
        models = self.models
        cn = models["controlnet"].float()
        with torch.no_grad():  # the masters' values, no gradient yet
            for n, q in cn.named_parameters():
                q.copy_(self.p0[n])
                q.grad = None
        setting = "tiny" if dtype_name == "fp32" else "operating"
        trainer, state = make_trainer(
            models["unet"], cn, models["vae"],
            _train_config(tcfg, self.variant, setting=setting), dtype)
        del state  # made again from the masters for each optimizer
        loss, _ = trainer.loss_fn(_port_batch(self.batch,
                                              self.variant.residual, dtype),
                                  **draws(self.rng, B, H))
        loss.backward()
        self.out["loss"][f"port_{dtype_name}"] = loss.item()
        del loss
        models["unet"].to(torch.bfloat16)
        models["vae"].to(torch.bfloat16)
        self.lap(f"port_{dtype_name}")
        return trainer

    def fp32_grads(self, trainer):
        got = trainer.gradients()
        self.out["grad"]["fp32"] = _fp32_summary({
            n: grad_ratio(got[n], self.jf[n], self.top)
            for n in self.names})
        self.lap("grad_fp32")

    def bf16_grads(self, trainer):
        acc = GroupSums()
        for n, q in trainer.controlnet.named_parameters():
            acc.add(train_group(n), self.jf[n], self.jb[n], q.grad.float())
        self.out["grad"]["bf16"] = acc.errors()
        self.lap("grad_bf16")

    def own_moves(self, trainer, dtype_name, dtype):
        """Each optimizer's update from the port's own gradient
        (`ControlNetTrainer.update`, what `train_step` runs after the
        backward) against JAX's from its own: fp32 at the tiny setting,
        element by element (with `alone`, also read at the operating
        point, as 'fp32_operating', and not held); bf16 at the operating
        point, by groups."""
        if dtype_name == "fp32":
            settings = ["tiny"] + (["operating"] if self.variant.alone
                                   else [])
        else:
            settings = ["operating"]
        grads = {n: q.grad for n, q in trainer.controlnet.named_parameters()}
        runs = [(s_, o) for s_ in settings for o in self.variant.optimizers]
        for i, (setting, opt) in enumerate(runs):
            if i:  # the next update from the same masters and gradient
                trainer.load_params(self.p0)
                for n, q in trainer.controlnet.named_parameters():
                    q.grad = grads[n]
            state = _masters(self.p0, ttrainer.Optimizer(_train_config(
                tcfg, self.variant, opt, setting)))
            trainer.update(state)
            working = dict(trainer.controlnet.named_parameters())
            for n in self.names:  # the working copy holds the master, cast
                assert torch.equal(working[n].detach(),
                                   state.params[n].to(dtype)), n
            moved = state.params
            del state, working
            _trim()
            row = self.out["move"].setdefault(opt, {})
            if dtype_name == "fp32":
                want = self.jax_new(setting, opt, "fp32")
                key = "fp32" if setting == "tiny" else "fp32_operating"
                row[key] = _fp32_summary({n: _move_ratio(
                    moved[n], want[n], setting) for n in self.names})
                del want
            else:
                wf = self.jax_new(setting, opt, "fp32")
                wb = self.jax_new(setting, opt, "bf16")
                acc = GroupSums()
                for n in self.names:
                    start = self.p0[n]
                    acc.add(train_group(n), wf[n] - start, wb[n] - start,
                            moved[n] - start)
                row["bf16"] = acc.errors()
                del wf, wb
            del moved
            self.lap(f"move_{opt}_{setting}_{dtype_name}")
        del grads
        for q in trainer.controlnet.parameters():
            q.grad = None

    def optimizer_alone(self):
        """Each optimizer at the operating point given JAX's fp32 gradient
        (in the torch layout) twice: the port's `Optimizer` against
        optax's chain after two updates, element by element (the second
        reads the moments as each optimizer stored them)."""
        grads = {n: self.jf[n] for n in self.names}
        for opt in self.variant.optimizers:
            state = _masters(self.p0, ttrainer.Optimizer(_train_config(
                tcfg, self.variant, opt, "operating")))
            state.apply_gradients(grads)
            state.apply_gradients(grads)
            moved = state.params
            del state
            _trim()
            want = self.jax_new("operating", opt, "fp32", updates=2)
            self.out["move"].setdefault(opt, {})["alone"] = _fp32_summary(
                {n: _move_ratio(moved[n], want[n], "operating")
                 for n in self.names})
            del moved, want
            self.lap(f"alone_{opt}")


def _move_ratio(got, want, setting) -> float:
    """max |got - want| / (MOVE_ATOL_LR lr) of two masters after an update
    from the same start."""
    lr = SETTINGS[setting]["learning_rate"]
    return float(torch.max(torch.abs(got - want))) / (MOVE_ATOL_LR * lr)


def compare_step(cfgs: Configs, variant: Variant, programs: _Programs,
                 seed: int = 7) -> dict:
    """The four runs of one training step (the module's docstring), read
    tensor by tensor against JAX's, `programs` started by
    `start_programs`: a dict of the losses, the gradient's {'fp32': worst
    element ratio to the limit and the tensors past it, 'bf16': {group:
    [e_jax, e_port, d]}}, each optimizer's moves likewise ('alone': two
    updates given JAX's gradient), seconds and RSS by stage and the peak
    RSS.  Printed as one JSON line."""
    step = _Step(cfgs, variant, programs, seed)
    try:
        _run(step)
    finally:
        step.sampler.stop()
    out = step.out
    out["seconds_rss"] = step.laps
    del step
    gc.collect()
    _trim()
    out["peak_rss_gb"] = _peak_rss_gb()
    print(json.dumps(_printable(out)), flush=True)
    return out


def _run(step: "_Step"):
    """`compare_step`'s stages in their order."""
    variant, cfgs = step.variant, step.cfgs
    step.jax_grads()
    step.models = _port_models(cfgs, variant, step.params)
    step.lap("bridge")
    trainer = step.port("fp32", torch.float32)
    step.fp32_grads(trainer)
    if variant.optimizers:
        step.own_moves(trainer, "fp32", torch.float32)
        if variant.alone:
            step.optimizer_alone()
    trainer = step.port("bf16", torch.bfloat16)
    step.bf16_grads(trainer)
    if variant.optimizers and variant.bf16_moves:
        step.own_moves(trainer, "bf16", torch.bfloat16)


def _fp32_summary(ratios: dict) -> dict:
    """{'worst': the largest ratio to the limit, 'past': the tensors past
    it (a NaN ratio counts as past)}."""
    past = sorted(n for n, r in ratios.items() if not r <= 1.0)
    return {"worst": max(ratios.values()), "past": past}


def bf16_holds(errors: list) -> bool:
    e_jax, e_port, d = errors
    return bool(np.isfinite(e_jax) and e_jax > 0
                and within_bf16_rule(e_jax, e_port, d))


def loss_holds(loss: dict, dtype: str) -> bool:
    """fp32: the port's loss at LOSS_RTOL of JAX's; bf16: within
    TRAIN_REF_TOL's loss_rel of JAX's fp32 loss."""
    want = loss["jax_fp32"]
    if dtype == "fp32":
        return abs(loss["port_fp32"] - want) <= LOSS_RTOL * abs(want)
    return (abs(loss["port_bf16"] - want)
            <= TRAIN_REF_TOL["loss_rel"] * abs(want))


def _printable(out: dict) -> dict:
    """The summary as printed: bf16 rows as [e_jax, e_port / e_jax,
    d / e_jax]."""
    def rows(errors):
        return {g: [e, p / e, d / e] for g, (e, p, d) in errors.items()}
    loss = out["loss"]
    return dict(variant=out["variant"],
                columns=["e_jax", "e_port/e_jax", "d/e_jax"], loss=loss,
                loss_bf16_rel={k: abs(loss[k] - loss["jax_fp32"])
                               / abs(loss["jax_fp32"])
                               for k in ("jax_bf16", "port_bf16")},
                grad={"fp32": out["grad"]["fp32"],
                      "bf16": rows(out["grad"]["bf16"])},
                move={o: {k: rows(v) if k == "bf16" else v
                          for k, v in m.items()}
                      for o, m in out["move"].items()},
                seconds_rss=out["seconds_rss"],
                peak_rss_gb=out["peak_rss_gb"])
