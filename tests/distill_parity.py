"""The consistency distillation step, JAX against the port, on the CPU: what
the distillation parity tests share (`test_torch_port_distill_fullwidth.py`
at SD-1.5's widths with one layer a block, `test_torch_port_distill_
fulldepth.py` at its depth).

One step at `scripts/train_distill.py`'s point (`:161-172`): DistillConfig's
defaults (Huber loss, FreeU, CFG 3.5, ControlNet scale 1.35, 50 teacher
steps, EMA decay 0.995), AdamW with no weight decay, clip 1.0, at lr 1e-3
and eps 1e-6 (`TRAIN`); frames of 64 px, batch 2, 77 x 768 text and
uncond embeddings that differ.  The teacher, the student and the EMA
target each have their own seeded float32 weights (`draw`), so that a
network used in the wrong place shows; the VAE has its own.

Runs, each package's step on the same weights, batch and draws:
  * JAX: `ConsistencyDistiller.train_step`'s work from a new state in
    its parts (`_jax_programs`): `jax.value_and_grad` of `loss_fn` at
    the step's key, then `make_optimizer`'s two stages, `apply_updates`
    and `incremental_update`.  In fp32, and in bf16 as the script runs
    it: the modules' dtype bf16, the student's and the EMA's fp32
    masters, the frozen teacher and VAE cast to bf16 (as flax casts them
    inside), the batch fp32.  Its bf16 run is traced with the posterior's
    eps drawn in fp32 and rounded (`train_parity._eps_drawn_in_fp32`);
  * the port: `ConsistencyDistiller`'s `loss_fn` and backward on the three
    networks in fp32 or cast to bf16 (the fused-conv VAE, as `chip_smoke.
    make_distiller` builds it), the batch as `chip_smoke.distill_batch`
    gives it, fed JAX's draws (the grid index, the noise, the posterior's
    eps); then the update `ConsistencyDistiller.update` applies, tensor by
    tensor: the port's `Optimizer` clipping by the whole gradient's norm
    (its `sq_norm` hook, as on a mesh) and `update_ema`.  Tensor by tensor
    so that the port's moved trees never stand beside JAX's whole: JAX's
    fp32 step holds six trees of the student's size (three networks, the
    gradient and Adam's two moments), 3.5 GB each at one layer a block.

What is held to what, tensor by tensor in JAX's layout (the port's
gradients moved into it), always the port against JAX:
  * fp32: the loss to LOSS_RTOL; every gradient element by
    `train_parity.grad_ratio`; after the update every master to
    MOVE_ATOL_LR of lr, every EMA element to MOVE_ATOL_LR of its share of
    that, (1 - decay) lr, plus two of its fp32 ulps, and Adam's moments
    by `grad_ratio` (the first moment is the clipped gradient scaled, the
    second's square root too).  With `deep` (at SD-1.5's depth) fp32
    rounding alone puts the two packages' gradients past those limits
    (DEPTH_SCALE): the gradient is held at DEPTH_SCALE times them, and
    the update is the port's applied to JAX's own gradient (`_spill`),
    held at the limits themselves, so that the optimizer and the EMA are
    held apart from the gradient's rounding;
  * bf16: by group and whole, the gradient, the masters' move and the
    EMA's move by `chip_smoke.within_bf16_rule` against JAX's fp32 and
    bf16 runs (`chip_smoke.GroupSums`), and the loss's terms (the Huber
    of f_student - f_target, element by element) the same way; the loss,
    their mean, by `chip_smoke.mean_limit` (`loss_holds`): one mean's
    bf16 error is the mean of its terms' errors, whose roundings cancel
    by chance, so its scale is their spread over the root of their count.
    A group (`chip_smoke.distill_group`) is a UNet or ControlNet part: its
    input, a down block, the mid block, an up block, the UNet's out head;
    the extractor, the FDNs and each zero-conv head.
The bf16 rule reads three runs' values of a tensor at once; `parts` > 1
runs JAX's steps again for each part of the tensors, so that only that
part of JAX's fp32 results is held beside its bf16 step.

`compare_step` runs all of it in a process of its own (`_child`), which
sets glibc's allocator for its large temporaries and gives every page
back when it ends.
"""

import concurrent.futures
import ctypes
import dataclasses
import functools
import gc
import json
import math
import multiprocessing
import os
import re
import tempfile
import time
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule
from diffcodec_tpu.train import distill as jdistill
from diffcodec_tpu.train import trainer as jtrainer

import train_parity as tp
from chip_smoke import GroupSums, distill_group, distill_loss_terms, mean_limit
from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from diffcodec_tpu_torch.train import distill as tdistill
from diffcodec_tpu_torch.train.trainer import Optimizer
from test_torch_port_fullwidth import draw_leaf

B, H, L = tp.B, tp.H, tp.L
# scripts/train_distill.py:166-172: lr 1e-6, constant, no weight decay,
# clip 1.0 (eps 1e-8 is TrainConfig's default)
OPERATING = dict(learning_rate=1e-6, lr_scheduler="constant",
                 lr_warmup_steps=100, max_train_steps=20000,
                 adam_weight_decay=0.0, max_grad_norm=1.0)
# every run's optimizer, lr 1e-3 and eps 1e-6: at the operating lr a
# first step moves a weight by 1e-6, at the fp32 rounding of the weights
# and below it for the EMA (a check at lr 1e-6 is blind), and at eps
# 1e-8 Adam's g / (|g| + eps) turns the gradients' summation-order noise
# into moves of up to ~lr where |g| nears eps (train_parity.SETTINGS)
TRAIN = dict(OPERATING, learning_rate=1e-3, adam_epsilon=1e-6)
# each network's seed (`draw`): the teacher, the student, the EMA target
ROLES = {"teacher": 10, "student": 20, "target": 30}
VAE_SEED = 40
# the step's key (`jax.random.PRNGKey`) and the batch's seed (`batch`)
KEY, BATCH_SEED = 7, 50
# at SD-1.5's depth (`compare_step(deep=True)`) the fp32 gradient is held
# at this many times the element limits.  fp32 rounding alone exceeds them
# there: against a float64 step (the port's) JAX's fp32 gradient stood 2.32
# times the limit off and the port's 1.09 times, the two packages 3.41
# times apart; at one layer a block 0.34 apart
DEPTH_SCALE = 5.0
# JAX's update runs in this many parts of the tensors (`_jax_programs`)
UPDATE_PARTS = 6
# an EMA element's fp32 rounding beyond the masters' limit: optax's
# new * s + old * (1 - s) and the port's, two products and a sum each,
# with 1 - s rounded in fp32 on one side and in float64 on the other
EMA_ULPS = 2.0 ** -22


def draw(seed: int, path, shape) -> np.ndarray:
    """One JAX parameter leaf's seeded float32 values (`draw_leaf`), from
    a generator of its own keyed by the seed and the leaf's path, so that
    any leaf can be drawn again alone."""
    rng = np.random.Generator(np.random.SFC64(
        [seed, zlib.crc32("/".join(path).encode())]))
    return draw_leaf(rng, path[-1], shape)


# the extractor's confidence heads (each level's last metric_net bias,
# one scalar): 1 in every network, as `chip_smoke.positive_confidence`
# sets them.  Drawn, half the levels' confidences are negative at every
# pixel, `soft_fuse` clamps them to 0 and those levels pass the extractor
# no gradient: at full depth JAX's own bf16 extractor gradient then read
# 258x the fp32 one's norm away from it, and the rule was blind there
CONFIDENCE = re.compile(r"controlnet\.feature_extractor\.wrapper\.\d+\."
                        r"metric_net\.2\.bias")


def _each(fn, items) -> list:
    """fn over items on as many threads as torch may use (numpy's draws and
    torch's copies let go of the GIL)."""
    with ThreadPoolExecutor(torch.get_num_threads()) as pool:
        return list(pool.map(fn, items))


@dataclasses.dataclass(frozen=True)
class Nets:
    """The configs, JAX's parameter shapes and the name maps of one size."""
    cfgs: tp.Configs

    @functools.cached_property
    def shapes(self) -> dict:
        """{'unet', 'controlnet', 'vae': JAX's tree of ShapeDtypeStructs}."""
        return tp._shapes(self.cfgs, False)

    @functools.cached_property
    def entries(self) -> list:
        """The denoiser's name map: ('unet.' or 'controlnet.' + the port's
        name, the path in a {'unet', 'controlnet'} tree, kind)."""
        c = self.cfgs
        return [(f"{net}.{t}", (net, "params") + tuple(f), k)
                for net, name_map in (
                    ("unet", weights.unet_name_map(c.tu)),
                    ("controlnet", weights.controlnet_name_map(c.tc)))
                for t, f, k in name_map]

    @functools.cached_property
    def names(self) -> list:
        return [e[0] for e in self.entries]

    def leaf_shape(self, path):
        return _leaf(self.shapes, path).shape

    def draw(self, seed: int, path, shape) -> np.ndarray:
        """`draw`, the confidence heads set to 1 (`CONFIDENCE`)."""
        if path in self._confidence:
            return np.ones(shape, np.float32)
        return draw(seed, path, shape)

    @functools.cached_property
    def _confidence(self) -> set:
        return {path for name, path, _ in self.entries
                if CONFIDENCE.fullmatch(name)}

    def jax_tree(self, seed: int, nets=("unet", "controlnet"),
                 dtype=jnp.float32) -> dict:
        """{net: JAX's parameter tree}, drawn leaf by leaf."""
        out = {}
        for net in nets:
            leaves, tree = jax.tree_util.tree_flatten_with_path(
                self.shapes[net])
            out[net] = jax.tree_util.tree_unflatten(tree, _each(
                lambda leaf: jnp.asarray(self.draw(
                    seed, (net,) + _keys(leaf[0]), leaf[1].shape), dtype),
                leaves))
        return out

    def torch_leaf(self, seed: int, name: str) -> torch.Tensor:
        """A denoiser parameter, by its port name, in the torch layout."""
        kind = self.entry(name)[2]
        return torch.from_numpy(weights._inverse_transform(
            kind, self.jax_leaf(seed, name))).contiguous()

    def jax_leaf(self, seed: int, name: str) -> np.ndarray:
        """A denoiser parameter, by its port name, in JAX's layout."""
        path = self.entry(name)[1]
        return self.draw(seed, path, self.leaf_shape(path))

    def to_jax_layout(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A port tensor of parameter `name`'s shape in JAX's layout
        (`weights._transform`), contiguous, in its dtype."""
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        moved = weights._transform(self.entry(name)[2], bits.numpy())
        return torch.from_numpy(moved).contiguous().view(t.dtype)

    def entry(self, name: str) -> tuple:
        return self._by_name[name]

    @functools.cached_property
    def _by_name(self) -> dict:
        return {e[0]: e for e in self.entries}


def _keys(path) -> tuple:
    return tuple(str(getattr(k, "key", k)) for k in path)


# ---- JAX ----

@dataclasses.dataclass(frozen=True)
class _Recording(jdistill.ConsistencyDistiller):
    """JAX's distiller, its consistency functions' values kept in `seen`
    as they are traced (the student's, then the target's)."""
    seen: list = dataclasses.field(default_factory=list, hash=False,
                                   compare=False)

    def consistency_fn(self, *args):
        out = super().consistency_fn(*args)
        self.seen.append(out)
        return out


def loss_and_terms(jd: _Recording):
    """jd.loss_fn as (loss, its terms): the terms the Huber of f_student -
    f_target element by element (the loss is their mean)."""
    def loss_fn(*args):
        jd.seen.clear()
        loss, _ = jd.loss_fn(*args)
        err = jd.seen[0] - jd.seen[1]
        c = jd.config.huber_c
        return loss, jnp.sqrt(err * err + c * c) - c
    return loss_fn


def _jax_distiller(cfgs, dtype):
    return _Recording(
        unet=JUNet(cfgs.ju, dtype=dtype),
        controlnet=JControlNet(cfgs.jc, dtype=dtype),
        vae=JVAE(cfgs.jv, dtype=dtype),
        schedule=JSchedule.create(jcfg.SchedulerConfig()),
        config=jcfg.DistillConfig())


def _top(tree):
    """The largest |element| of a tree."""
    return jnp.max(jnp.stack([jnp.max(jnp.abs(x))
                              for x in jax.tree.leaves(tree)]))


def _optimizer(cfg) -> tuple:
    """`make_optimizer(cfg)`'s two stages (`trainer.py:158-161`, AdamW
    with fp32 moments): clip_by_global_norm, then adamw.  Applied one
    after the other as `optax.chain` applies them; adamw works tensor by
    tensor, so it may be applied to parts of the tree."""
    return (optax.clip_by_global_norm(cfg.max_grad_norm),
            optax.adamw(jtrainer.make_lr_schedule(cfg), b1=cfg.adam_beta1,
                        b2=cfg.adam_beta2, eps=cfg.adam_epsilon,
                        weight_decay=cfg.adam_weight_decay))


def _jax_programs(nets: Nets, dtype_name) -> dict:
    """JAX's train_step (`distill.py:224-233`) from a new state over
    (student, ema), in its parts: 'grad', `jax.value_and_grad` of loss_fn
    at the step's key (folded with step 0); 'clip', the optimizer's first
    stage over the whole gradient; 'update', its second stage, then
    `apply_updates` and `incremental_update`, over a part of the tensors
    (`UPDATE_PARTS`: XLA holds ~3.6 trees of temporaries for the update
    of the whole tree, 11.7 GiB at one layer a block).  Trees go by port
    name, flat, past 'grad'; each program donates what it does not give
    back (the frozen trees' buffers may carry the gradient), so that JAX
    holds no more than one step's state."""
    jd = _jax_distiller(nets.cfgs, jnp.bfloat16 if dtype_name == "bf16"
                        else jnp.float32)
    clip, adam = _optimizer(jcfg.TrainConfig(**TRAIN))
    loss_fn = loss_and_terms(jd)

    def grad(student, ema, frozen, batch, rng):
        (loss, terms), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            student, ema, frozen, batch, jax.random.fold_in(rng, 0))
        return dict(loss=loss, terms=terms, grad=grads, top=_top(grads))

    def clipped(grads):
        return clip.update(grads, clip.init(grads))[0]

    def update(params, ema, grads):
        updates, state = adam.update(grads, adam.init(params), params)
        params = optax.apply_updates(params, updates)
        ema = optax.incremental_update(params, ema,
                                       1.0 - jd.config.ema_decay)
        mu, nu = state[0].mu, state[0].nu
        return dict(params=params, ema=ema, mu=mu, nu=nu,
                    top=dict(mu=_top(mu), nu=_top(nu)))

    return {"grad": jax.jit(grad, donate_argnums=(2,)),
            "clip": jax.jit(clipped, donate_argnums=(0,)),
            "update": jax.jit(update, donate_argnums=(0, 1, 2))}


def _batch_shapes(text_dim: int) -> dict:
    shapes = dict(image=(B, H, H, 3), cond=(B, H, H, 6), flow=(B, H, H, 4),
                  text_embeds=(B, L, text_dim), uncond_embeds=(B, L, text_dim))
    return {k: jax.ShapeDtypeStruct(v, jnp.float32)
            for k, v in shapes.items()}


def batch(text_dim: int, seed: int = BATCH_SEED) -> dict:
    """numpy: frames and anchors in [-1, 1], 2 N(0, 1) px flows, the text
    and uncond embeddings 0.1 N(0, 1), each its own."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        image=rng.uniform(-1, 1, (B, H, H, 3)).astype(f32),
        cond=rng.uniform(-1, 1, (B, H, H, 6)).astype(f32),
        flow=(2 * rng.standard_normal((B, H, H, 4))).astype(f32),
        text_embeds=(0.1 * rng.standard_normal((B, L, text_dim))).astype(f32),
        uncond_embeds=(0.1 * rng.standard_normal((B, L, text_dim))
                       ).astype(f32))


def start_programs(programs: tp._Programs, nets: Nets, dtypes):
    """Lower JAX's programs in each dtype and start compiling them."""
    c = nets.cfgs
    rng = jax.ShapeDtypeStruct((2,), jnp.uint32)
    student = {k: nets.shapes[k] for k in ("unet", "controlnet")}
    flat = {n: jax.ShapeDtypeStruct(nets.leaf_shape(nets.entry(n)[1]),
                                    jnp.float32) for n in nets.names}
    for name in dtypes:
        fns = _jax_programs(nets, name)
        low = jnp.bfloat16 if name == "bf16" else None
        frozen = tp._abstract(dict(student, vae=nets.shapes["vae"]), low)
        args = (student, student, frozen, _batch_shapes(
            c.ju.cross_attention_dim), rng)
        if name == "bf16":
            with tp._eps_drawn_in_fp32() as asked:
                lowered = fns["grad"].lower(*args)
            # the posterior's eps in the VAE's dtype, then the fp32 noise
            assert asked == [jnp.dtype(jnp.bfloat16),
                             jnp.dtype(jnp.float32)], asked
        else:
            lowered = fns["grad"].lower(*args)
        programs.start(("grad", name), lowered)
        programs.start(("clip", name), fns["clip"].lower(flat))
        for i, part in enumerate(partition(nets, UPDATE_PARTS)):
            sub = {n: flat[n] for n in part}
            programs.start(("update", name, i),
                           fns["update"].lower(sub, sub, sub))


def draws(rng, n_teacher: int) -> dict:
    """JAX's train_step draws at its first step (`distill.py:183-197`, the
    key folded with step 0), for the port's loss_fn: latent_eps, idx,
    noise, fp32."""
    rng_n, rng_t, rng_lat = jax.random.split(jax.random.fold_in(rng, 0), 3)
    shape = (B, H // 8, H // 8, 4)
    return dict(
        latent_eps=tp._t(jax.random.normal(rng_lat, shape, jnp.float32)),
        idx=tp._t(jax.random.randint(rng_t, (B,), 0, n_teacher - 1)),
        noise=tp._t(jax.random.normal(rng_n, shape, jnp.float32)))


# ---- the port ----

def _port_denoiser(nets: Nets, seed: int) -> torch.nn.ModuleDict:
    """A fp32 `denoiser`, made on the meta device and filled leaf by leaf."""
    c = nets.cfgs
    with torch.device("meta"):
        d = tdistill.denoiser(UNet2DConditionModel(c.tu),
                              DualFlowControlNet(c.tc))
    d = d.to_empty(device="cpu")
    params = dict(d.named_parameters())
    assert set(params) == set(nets.names)

    @torch.no_grad()  # grad mode is the thread's own
    def fill(name):
        params[name].copy_(nets.torch_leaf(seed, name))

    _each(fill, nets.names)
    return d


def _port_vae(nets: Nets, seed: int = VAE_SEED) -> AutoencoderKL:
    c = nets.cfgs
    with torch.device("meta"):
        vae = AutoencoderKL(c.tv, fused_conv=True)
    vae = vae.to_empty(device="cpu")
    weights.load_flax_params(vae, nets.jax_tree(seed, ("vae",))["vae"],
                             weights.vae_name_map(c.tv))
    return vae


def port_batch(batch: dict, dtype) -> dict:
    """The batch as `chip_smoke.distill_batch` gives the distiller: the
    anchors and embeddings in the compute dtype, the frames and the flows
    fp32."""
    return {k: tp._t(v) if k in ("image", "flow") else tp._t(v).to(dtype)
            for k, v in batch.items()}


def port_distiller(nets: Nets, dtype, roles=None, vae_seed=VAE_SEED):
    """The port's distiller over the drawn networks in `dtype` (`roles`:
    each network's seed, ROLES by default)."""
    roles = roles or ROLES
    return tdistill.ConsistencyDistiller(
        teacher=_port_denoiser(nets, roles["teacher"]).to(dtype).eval(),
        student=_port_denoiser(nets, roles["student"]).to(dtype),
        target=_port_denoiser(nets, roles["target"]).to(dtype).eval(),
        vae=_port_vae(nets, vae_seed).to(dtype).eval(),
        schedule=NoiseSchedule.create(tcfg.SchedulerConfig()),
        config=tcfg.DistillConfig())


def port_grads(nets: Nets, dtype, batch: dict, drawn: dict) -> tuple:
    """The port's loss, its terms (`chip_smoke.distill_loss_terms`) and
    the student's gradient (in `dtype`) by name, its networks dropped
    after the backward."""
    d = port_distiller(nets, dtype)
    loss, terms = distill_loss_terms(d, port_batch(batch, dtype), drawn)
    loss.backward()
    grads = d.gradients()
    assert all(p.grad is not None for p in d.student.parameters())
    assert all(p.grad is None for m in (d.teacher, d.target, d.vae)
               for p in m.parameters())
    return loss.item(), terms.numpy(), grads


class PortUpdate:
    """`ConsistencyDistiller.update`'s arithmetic on a gradient (by port
    name, in JAX's layout), one tensor at a time: the port's `Optimizer`
    (its step clipped by the whole gradient's norm, summed as its update
    sums it) and `update_ema`, from the student's and the target's drawn
    fp32 weights.  Both work element by element, so that they run in JAX's
    layout, beside JAX's results, as they run in the torch layout."""

    def __init__(self, nets: Nets, grads: dict):
        self.nets, self.grads = nets, grads
        self.tx = Optimizer(tcfg.TrainConfig(**TRAIN))
        self.sq = sum(torch.sum(g.float() ** 2) for g in grads.values())
        self.config = tcfg.DistillConfig()

    def __call__(self, name: str) -> dict:
        """{'start', 'params', 'ema_start', 'ema', 'mu', 'nu'} of one
        tensor after the update."""
        start = torch.from_numpy(self.nets.jax_leaf(ROLES["student"], name))
        ema = torch.from_numpy(self.nets.jax_leaf(ROLES["target"], name))
        state = tdistill.DistillState(
            step=0, params={name: start.clone()},
            ema_params={name: ema.clone()},
            opt_state=self.tx.init({name: start}), tx=self.tx)
        self.tx.update(state.params, {name: self.grads[name]},
                       state.opt_state, lambda _: self.sq)
        # update_ema reads the distiller's config only
        tdistill.ConsistencyDistiller.update_ema(self, state)
        return dict(start=start, params=state.params[name], ema_start=ema,
                    ema=state.ema_params[name],
                    mu=state.opt_state["mu"][name],
                    nu=state.opt_state["nu"][name])


# ---- the comparison ----

class _Flat:
    """JAX's arrays by port name, as torch tensors (no copy), in JAX's
    layout."""

    def __init__(self, leaves: dict):
        self.leaves = leaves

    def __getitem__(self, name) -> torch.Tensor:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # not writable
            return torch.from_numpy(np.asarray(self.leaves[name]))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class _Step:
    """The runs of one comparison, stage by stage (`compare_step`)."""

    def __init__(self, nets: Nets, programs: tp._Programs, dtypes, parts,
                 deep):
        self.nets, self.programs = nets, programs
        self.dtypes, self.parts, self.deep = dtypes, parts, deep
        self.sampler = tp._Sampler()
        self.t0, self.laps = time.perf_counter(), {}
        self.batch = batch(nets.cfgs.ju.cross_attention_dim)
        self.rng = jax.random.PRNGKey(KEY)
        self.draws = draws(self.rng, jcfg.DistillConfig().num_teacher_steps)
        self.out = {"loss": {}, "terms": {}, "grad": {}, "move": {}}

    lap = tp._Step.lap

    def port(self, name, dtype) -> dict:
        """The port's loss and terms, and its gradient in JAX's layout."""
        loss, terms, grads = port_grads(self.nets, dtype, self.batch,
                                        self.draws)
        self.out["loss"][f"port_{name}"] = loss
        self.out["terms"][f"port_{name}"] = terms
        grads = {n: self.nets.to_jax_layout(n, grads.pop(n))
                 for n in list(grads)}
        self.lap(f"port_{name}")
        return grads

    def jax_grad(self, name) -> tuple:
        """JAX's loss and gradient in `name`'s dtype: (the student's and
        the EMA's trees, for the update, and the gradient's tree), the
        gradient's reader (`_Flat`) and its largest element."""
        nets = self.nets
        low = jnp.bfloat16 if name == "bf16" else jnp.float32
        student = nets.jax_tree(ROLES["student"])
        ema = nets.jax_tree(ROLES["target"])
        frozen = dict(nets.jax_tree(ROLES["teacher"], dtype=low),
                      **nets.jax_tree(VAE_SEED, ("vae",), low))
        jb = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.lap("draw")
        out = self.programs[("grad", name)](student, ema, frozen, jb,
                                            self.rng)
        del frozen
        jax.block_until_ready(out)
        self.out["loss"][f"jax_{name}"] = float(out["loss"])
        self.out["terms"][f"jax_{name}"] = np.asarray(out["terms"])
        self.lap(f"jax_grad_{name}")
        grad = {n: _leaf(out["grad"], nets.entry(n)[1]) for n in nets.names}
        return (student, ema, out["grad"]), _Flat(grad), float(
            out["top"])

    def jax_update(self, name, trees) -> dict:
        """JAX's update from `jax_grad`'s trees (given up to it), part by
        part: the masters', the EMA's and the moments' readers and the
        moments' largest elements."""
        nets = self.nets
        student, ema, grads = ({n: _leaf(t, nets.entry(n)[1])
                                for n in nets.names} for t in trees)
        grads = self.programs[("clip", name)](grads)
        out = {k: {} for k in ("params", "ema", "mu", "nu")}
        top = {"mu": 0.0, "nu": 0.0}
        for i, part in enumerate(partition(nets, UPDATE_PARTS)):
            got = self.programs[("update", name, i)](
                *({n: t.pop(n) for n in part}
                  for t in (student, ema, grads)))
            for k in out:
                out[k].update(got[k])
            top = {k: max(v, float(got["top"][k])) for k, v in top.items()}
        self.lap(f"jax_update_{name}")
        got = {k: _Flat(v) for k, v in out.items()}
        got["top"] = {"mu": top["mu"], "nu": top["nu"] ** 0.5}
        return got

    def fp32_grad(self, grads, want, top):
        """The fp32 port's gradient against JAX's, element by element (with
        `deep`, at DEPTH_SCALE times the limit)."""
        scale = DEPTH_SCALE if self.deep else 1.0
        got = {n: tp.grad_ratio(grads[n], want[n], top) / scale
               for n in self.nets.names}
        self.out["grad"]["fp32"] = dict(tp._fp32_summary(got), scale=scale)
        self.lap("fp32_grad")

    def fp32_update(self, grads, got):
        """The port's update from the fp32 gradient `grads` (the port's, or
        with `deep` JAX's own) against JAX's, element by element.  Drops
        each tensor it has read."""
        lr = TRAIN["learning_rate"]
        ema_lr = (1 - tcfg.DistillConfig().ema_decay) * lr
        keys = ("params", "ema", "mu", "nu")
        update = PortUpdate(self.nets, grads)
        tops = got["top"]
        ratios = {k: {} for k in keys}
        for n in self.nets.names:
            moved = update(n)
            for k in keys:
                ratios[k][n] = _move_ratio(k, moved[k], got[k][n], tops, lr,
                                           ema_lr)
                got[k].leaves.pop(n)
            grads.pop(n)
        self.out["move"]["fp32"] = {k: tp._fp32_summary(v)
                                    for k, v in ratios.items()}
        self.out["move"]["fp32"]["given"] = "jax" if self.deep else "port"
        self.lap("fp32_update")

    def keep(self, grads: dict, got) -> dict:
        """JAX fp32's gradient (`grads`, copied before its update) and
        moves of the same tensors."""
        kept = {}
        for n, g in grads.items():
            start = torch.from_numpy(self.nets.jax_leaf(ROLES["student"], n))
            ema = torch.from_numpy(self.nets.jax_leaf(ROLES["target"], n))
            kept[n] = (g, got["params"][n] - start, got["ema"][n] - ema)
        self.lap("keep")
        return kept

    def bf16_grad(self, grads, grad, kept, groups):
        """Add the gradients of `kept`'s tensors to the bf16 rule's sums:
        JAX's fp32 (`kept`) and bf16 (`grad`) against the port's bf16."""
        for n, (jf, _, _) in kept.items():
            groups["grad"].add(distill_group(n), jf, grad[n],
                               grads[n].float())
        self.lap("bf16_grad")

    def bf16_update(self, grads, got, kept, groups):
        """Add the moves of `kept`'s tensors to the bf16 rule's sums: JAX's
        fp32 (`kept`) and bf16 (`got`) against the port's bf16."""
        update = PortUpdate(self.nets, grads)
        for n, (_, jf_p, jf_e) in kept.items():
            moved = update(n)
            group = distill_group(n)
            groups["params"].add(group, jf_p,
                                 got["params"][n] - moved["start"],
                                 moved["params"] - moved["start"])
            groups["ema"].add(group, jf_e, got["ema"][n] - moved["ema_start"],
                              moved["ema"] - moved["ema_start"])
        self.lap("bf16_update")


def _move_ratio(key, got, want, tops, lr, ema_lr) -> float:
    """One moved tensor's largest distance from `want` over its limit: a
    master's MOVE_ATOL_LR of lr, an EMA element's of (1 - decay) lr plus
    EMA_ULPS of it, a moment's `grad_ratio` (the second by its root)."""
    if key == "params":
        return float(torch.max(torch.abs(got - want))) / (
            tp.MOVE_ATOL_LR * lr)
    if key == "ema":
        return float(torch.max(torch.abs(got - want) / (
            tp.MOVE_ATOL_LR * ema_lr + EMA_ULPS * want.abs())))
    return tp.grad_ratio(_ref(key, got), _ref(key, want), tops[key])


def _ref(key: str, t: torch.Tensor) -> torch.Tensor:
    """What a moment is held as: the first as it is, the second by its
    square root (both then the clipped gradient, scaled)."""
    return t.float().sqrt() if key == "nu" else t.float()


def partition(nets: Nets, parts: int) -> list:
    """The tensor names in `parts` lists of near-equal sizes, in order."""
    sizes = {n: int(np.prod(nets.leaf_shape(nets.entry(n)[1])))
             for n in nets.names}
    total, out, acc = sum(sizes.values()), [[]], 0
    for n in nets.names:
        if acc >= (len(out)) * total / parts and len(out) < parts:
            out.append([])
        out[-1].append(n)
        acc += sizes[n]
    return out


def compare_step(cfgs: tp.Configs, dtypes=("fp32",), parts: int = 1,
                 deep: bool = False) -> dict:
    """The runs of one distillation step at `cfgs` (the module's
    docstring), in a process of its own
    (`_child`) with the caller's count of torch threads: a dict of the
    losses and their terms, the fp32 gradient's and each moved tree's
    {'worst', 'past'}, and with 'bf16' in `dtypes` each bf16 group's
    [e_jax, e_port, d] of the gradient, the masters' move ('params') and
    the EMA's ('ema'); seconds and RSS by stage and the peak RSS.  Printed
    as one JSON line."""
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool:
        return pool.submit(_child, cfgs, tuple(dtypes), parts, deep,
                           torch.get_num_threads()).result()


# glibc's mallopt parameters
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3


def _child(cfgs, dtypes, parts, deep, threads) -> dict:
    """`compare_step` in the spawned process: JAX's compile cache as the
    tests' conftest sets it; glibc serving blocks below 1 GiB from its
    heap and keeping what is freed there, so that torch's temporaries of
    up to 120 MB a tensor reuse pages instead of faulting fresh ones in at
    each op (3x the ops' own time here; `lap` hands the free pages back
    between stages)."""
    from diffcodec_tpu.utils.jax_cache import enable_persistent_cache
    enable_persistent_cache()
    torch.set_num_threads(threads)
    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except OSError:
        pass
    nets = Nets(cfgs)
    for _ in (nets.shapes, nets.names, nets._by_name, nets._confidence):
        pass  # made here, before two threads read them
    programs = tp._Programs()
    step = _Step(nets, programs, dtypes, parts, deep)
    # JAX's programs are traced on a thread of their own while the port
    # runs (the tracing holds the GIL, torch's ops let go of it)
    tracer = concurrent.futures.ThreadPoolExecutor(1)
    lowering = tracer.submit(start_programs, programs, nets, dtypes)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _run(step, tmp, lowering)
    finally:
        tracer.shutdown()
        step.sampler.stop()
    out = step.out
    out["seconds_rss"] = step.laps
    del step
    gc.collect()
    tp._trim()
    out["peak_rss_gb"] = tp._peak_rss_gb()
    print(json.dumps(_printable(out)), flush=True)
    return out


def _on_disk(grads: dict, path: str) -> dict:
    """`grads` written to `path` and read back memory-mapped: their pages
    the page cache's, out of the process's resident size until read, so
    that JAX's steps run beside no copy of them."""
    torch.save(grads, path)
    return torch.load(path, mmap=True)


def _spill(reader, names, path: str) -> dict:
    """reader's tensors (fp32) written one by one into `path` and read back
    memory-mapped, by name: out of the process's resident size until
    read."""
    where = {}
    with open(path, "wb") as f:
        for n in names:
            t = reader[n]
            where[n] = (f.tell() // 4, t.shape)
            t.numpy().tofile(f)
    mapped = np.memmap(path, np.float32, "c")
    return {n: torch.from_numpy(mapped[o:o + math.prod(shape)].reshape(
        shape)) for n, (o, shape) in where.items()}


def _run(step: _Step, tmp: str, lowering: concurrent.futures.Future):
    """The port's runs first (each keeps only its gradient, on disk), then
    JAX's fp32 step, read whole against the port's fp32 (with `deep`, its
    gradient kept on disk for the port's update); with bf16, JAX's fp32
    and bf16 steps part by part, each part read by the bf16 rule.  JAX's
    steps wait for `lowering` (`start_programs`)."""
    bf16 = "bf16" in step.dtypes
    grads32 = _on_disk(step.port("fp32", torch.float32),
                       os.path.join(tmp, "fp32.pt"))
    grads16 = _on_disk(step.port("bf16", torch.bfloat16),
                       os.path.join(tmp, "bf16.pt")) if bf16 else None
    groups = {k: GroupSums() for k in ("grad", "params", "ema")}
    lowering.result()
    step.lap("lowering")
    for i, part in enumerate(partition(step.nets, step.parts if bf16
                                       else 1)):
        trees, grad, top = step.jax_grad("fp32")
        if i == 0:
            step.fp32_grad(grads32, grad, top)
            if step.deep:  # JAX's gradient takes the port's place on disk
                del grads32
                gc.collect()
                os.remove(os.path.join(tmp, "fp32.pt"))
                grads32 = _spill(grad, step.nets.names,
                                 os.path.join(tmp, "jax_fp32.bin"))
        kept = {n: grad[n].clone() for n in part} if bf16 else None
        del grad
        got = step.jax_update("fp32", trees)  # gives the trees up
        del trees
        if bf16:
            kept = step.keep(kept, got)
        if i == 0:
            step.fp32_update(grads32, got)
            del grads32
        del got
        tp._trim()
        if bf16:
            trees, grad, _ = step.jax_grad("bf16")
            step.bf16_grad(grads16, grad, kept, groups)
            del grad
            got = step.jax_update("bf16", trees)
            del trees
            step.bf16_update(grads16, got, kept, groups)
            del got, kept
            tp._trim()
    if bf16:
        step.out["grad"]["bf16"] = groups["grad"].errors()
        step.out["move"]["bf16"] = {k: groups[k].errors()
                                    for k in ("params", "ema")}


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.float64(got) - want)
                 / np.linalg.norm(np.float64(want)))


def terms_errors(terms: dict) -> list:
    """The loss's terms' [e_jax, e_port, d] (relL2s)."""
    jf, jb, pb = (terms[k] for k in ("jax_fp32", "jax_bf16", "port_bf16"))
    return [_rel(jb, jf), _rel(pb, jf), _rel(pb, jb)]


def loss_bf16(out: dict) -> dict:
    """The bf16 loss: 'gap', the port's distance from JAX's fp32 loss;
    'limit', `chip_smoke.mean_limit` of JAX's terms; 'jax_gap', JAX's own
    bf16 distance; each relative to JAX's fp32 loss."""
    loss, terms = out["loss"], out["terms"]
    want = loss["jax_fp32"]
    return dict(
        gap=abs(loss["port_bf16"] - want) / abs(want),
        jax_gap=abs(loss["jax_bf16"] - want) / abs(want),
        limit=mean_limit(torch.from_numpy(terms["jax_fp32"]),
                         torch.from_numpy(terms["jax_bf16"])) / abs(want))


def loss_holds(out: dict, dtype: str) -> bool:
    """fp32: `train_parity.loss_holds`; bf16: the port's loss within
    `mean_limit` of JAX's fp32 loss (`loss_bf16`)."""
    if dtype == "fp32":
        return tp.loss_holds(out["loss"], dtype)
    got = loss_bf16(out)
    return bool(got["gap"] <= got["limit"])


def _printable(out: dict) -> dict:
    """The summary as printed: bf16 rows as [e_jax, e_port / e_jax,
    d / e_jax]."""
    def rows(errors):
        return {g: [e, p / e, d / e] for g, (e, p, d) in errors.items()}
    grad = dict(out["grad"])
    move = dict(out["move"])
    if "bf16" in grad:
        grad["bf16"] = rows(grad["bf16"])
        move["bf16"] = {k: rows(v) for k, v in move["bf16"].items()}
    printed = dict(columns=["e_jax", "e_port/e_jax", "d/e_jax"],
                   loss=out["loss"], grad=grad, move=move,
                   seconds_rss=out["seconds_rss"],
                   peak_rss_gb=out["peak_rss_gb"])
    if "port_bf16" in out["loss"]:
        printed["loss_bf16"] = loss_bf16(out)
        printed["terms_bf16"] = rows({"terms": terms_errors(out["terms"])})
    return printed
