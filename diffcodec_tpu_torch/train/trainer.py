"""ControlNet training: the learning-rate schedules, the optimizer written by
hand, the train state and the training step.

Counterpart: `diffcodec_tpu/train/trainer.py` (the reference's
`train_controlnet.py:1076-1166`): VAE-encode the ground truth, add noise at
a uniform random timestep per sample, run the ControlNet and the frozen
UNet with its residuals, MSE against the target (plus the pixel losses),
AdamW over the ControlNet's parameters with clipping by global norm 1.0 and
optional gradient accumulation.

The optimizer is optax's chain, computed tensor by tensor in place:
  clip_by_global_norm(max_grad_norm)    scale by max_norm / norm only when
                                        norm >= max_norm
  scale_by_adam (fp32 moments) or       bias-corrected, eps outside the
  scale_by_adam_lowp (bf16 moments,     square root
  fp32 math)
  add_decayed_weights(weight_decay)     every tensor decays
  scale_by_learning_rate(schedule)      times -lr(number of updates so far)
  MultiSteps(k)                         the running mean of k micro-steps'
                                        gradients, applied on the k-th

Mixed precision: the ControlNet module that runs the forward and backward
is a working copy in the compute dtype (bf16 on the card), the fp32 master
parameters and the moments live in the `TrainState`, and the master is
copied back into the working copy after each update.  That is flax's
cast-at-use with `dtype=bf16` over fp32 parameters: the gradient of the
cast is the bf16 gradient widened to fp32.  The frozen UNet and VAE run in
the compute dtype with `requires_grad_(False)`; gradients still flow
through the UNet's activations to the ControlNet's residuals.

On a mesh (`shard_state`, `parallel/mesh.py`) each process holds its fsdp
slice of the masters and the moments: a step averages the working copy's
gradients over the data ranks, clips by the norm of the whole gradient
(the squared sums all-reduced), updates the slices and gathers the working
copy back; every rank is given the global batch and draws the noise and
timesteps for all of it, and keeps its own rows (all of them where the data
axis does not divide the batch), so the sharded step is the one-process
step.  Checkpoints hold the gathered state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from diffcodec_tpu_torch.config import TrainConfig
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.parallel.mesh import (FsdpLayout, row_taker,
                                               shard_batch)
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from diffcodec_tpu_torch.train.losses import diffusion_loss, pixel_losses

Params = Dict[str, torch.Tensor]


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over `steps`, then held."""
    if steps <= 0:
        return lambda n: init
    return lambda n: (init - end) * (1 - min(max(n, 0), steps) / steps) + end


def _cosine(init: float, steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0."""
    return lambda n: init * 0.5 * (1 + math.cos(math.pi * min(n, steps)
                                                / steps))


def _join(first, then, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules: `then` counts from the boundary on."""
    return lambda n: first(n) if n < boundary else then(n - boundary)


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate after n updates (diffusers' `get_scheduler`
    for constant, constant_with_warmup, linear and cosine)."""
    base, warm = cfg.learning_rate, cfg.lr_warmup_steps
    rest = max(cfg.max_train_steps - warm, 1)
    if cfg.lr_scheduler == "constant":
        return lambda n: base
    warmup = _linear(0.0, base, warm)
    if cfg.lr_scheduler == "constant_with_warmup":
        return _join(warmup, lambda n: base, warm)
    if cfg.lr_scheduler == "linear":
        return _join(warmup, _linear(base, 0.0, rest), warm)
    if cfg.lr_scheduler == "cosine":
        return _join(warmup, _cosine(base, rest), warm)
    raise ValueError(f"unknown lr scheduler {cfg.lr_scheduler!r}")


class Optimizer:
    """The JAX package's `make_optimizer(cfg)`, written out.

    `init(params)` makes the state: the update count, the two moments
    (fp32, or bf16 with `lowp_adam_moments`) and, with gradient
    accumulation, the mini-step and the running mean of the gradients.
    `update(params, grads, state)` applies one micro-step in place.  The
    eager update runs tensor by tensor, so only one tensor's fp32 temporaries
    are live at a time: what `adam_update_chunks` buys the JAX package
    (grouping XLA's fused update) holds here without it."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.lr = make_lr_schedule(cfg)
        self.moment_dtype = (torch.bfloat16 if cfg.lowp_adam_moments
                             else torch.float32)

    def init(self, params: Params) -> Dict[str, Any]:
        state = {"count": 0,
                 "mu": {n: torch.zeros_like(p, dtype=self.moment_dtype)
                        for n, p in params.items()},
                 "nu": {n: torch.zeros_like(p, dtype=self.moment_dtype)
                        for n, p in params.items()}}
        if self.cfg.gradient_accumulation_steps > 1:
            state["mini_step"] = 0
            state["acc"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: Dict[str, Any],
               sq_norm: Optional[Callable[[Params], torch.Tensor]] = None):
        """`sq_norm(grads)`: the squared global norm of the gradient to clip
        by (the sum over `grads`' tensors where None; a mesh's
        `FsdpLayout.sq_norm` where they are slices)."""
        k = self.cfg.gradient_accumulation_steps
        if k > 1:
            mini = state["mini_step"]
            for n, g in grads.items():  # Welford's mean, as MultiSteps
                acc = state["acc"][n]
                acc.add_((g - acc) / (mini + 1))
            state["mini_step"] = (mini + 1) % k
            if mini + 1 < k:
                return
            grads = state["acc"]
        self._apply(params, grads, state, sq_norm)
        if k > 1:
            for acc in state["acc"].values():
                acc.zero_()

    def _apply(self, params: Params, grads: Params, state: Dict[str, Any],
               sq_norm=None):
        cfg = self.cfg
        norm = torch.sqrt(sq_norm(grads) if sq_norm is not None else
                          sum(torch.sum(g.float() ** 2)
                              for g in grads.values()))
        # optax: (g / norm) * max_norm where norm >= max_norm, else g
        clip = norm >= cfg.max_grad_norm
        lr = self.lr(state["count"])
        state["count"] += 1
        t = state["count"]
        b1, b2, eps = cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon
        c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        for n, p in params.items():
            g = grads[n].float()
            g = torch.where(clip, g / norm * cfg.max_grad_norm, g)
            mu, nu = state["mu"][n], state["nu"][n]
            if cfg.lowp_adam_moments:  # scale_by_adam_lowp's arithmetic
                m32 = b1 * mu.float() + (1 - b1) * g
                v32 = b2 * nu.float() + (1 - b2) * g * g
                u = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
                mu.copy_(m32)
                nu.copy_(v32)
            else:  # optax.scale_by_adam's
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            u = u + cfg.adam_weight_decay * p
            p.add_(-lr * u)


@dataclasses.dataclass(eq=False)
class TrainState:
    """The update count, the fp32 master parameters by name and the
    optimizer's state; `apply_gradients` updates both in place.  On a mesh
    (`layout`, set by `ControlNetTrainer.shard_state`) the tensors are this
    rank's fsdp slices."""
    step: int
    params: Params
    opt_state: Dict[str, Any]
    tx: Optimizer
    layout: Optional[Any] = None

    @classmethod
    def create(cls, params: Params, tx: Optimizer) -> "TrainState":
        params = {n: p.detach().float().clone() for n, p in params.items()}
        return cls(step=0, params=params, opt_state=tx.init(params), tx=tx)

    def apply_gradients(self, grads: Params,
                        sq_norm=None) -> "TrainState":
        self.tx.update(self.params, grads, self.opt_state, sq_norm)
        self.step += 1
        return self

    def state_dict(self) -> Dict[str, Any]:
        """The step, masters and optimizer state, gathered whole on a mesh
        (every rank must call it)."""
        return {"step": self.step, "params": gathered(self.layout,
                                                      self.params),
                "opt_state": gathered(self.layout, self.opt_state)}

    @torch.no_grad()
    def load_state_dict(self, saved: Dict[str, Any]) -> "TrainState":
        """Copy a saved (whole) state into this one's tensors (their
        devices and dtypes; this rank's slices on a mesh); the names must
        match."""
        copy_into(self.params, sliced(self.layout, saved["params"]),
                  "params")
        load_opt_state(self.opt_state, sliced(self.layout,
                                              saved["opt_state"]))
        self.step = int(saved["step"])
        return self


def gathered(layout, tree):
    """A state's tensors by name (dicts of them, beside counters) whole:
    gathered over the fsdp ranks where `layout` is a mesh's."""
    return tree if layout is None else _tensor_dicts(tree,
                                                     layout.gather_dict)


def sliced(layout, tree):
    """`gathered`'s inverse: this rank's slices of whole tensors."""
    return tree if layout is None else _tensor_dicts(tree, layout.shard_dict)


def _tensor_dicts(tree, fn):
    """fn on each dict of tensors in a state's nested dicts."""
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in tree.values()):
        return fn(tree)
    return {k: _tensor_dicts(v, fn) if isinstance(v, dict) else v
            for k, v in tree.items()}


@torch.no_grad()
def copy_into(dst: Params, src: Params, what: str):
    """Copy each tensor of `src` into `dst`'s of the same name, which must
    be the same names."""
    if set(dst) != set(src):
        raise KeyError(f"{what}: names differ: "
                       f"{sorted(set(dst) ^ set(src))[:5]}")
    for n, t in dst.items():
        t.copy_(src[n])


def load_opt_state(opt_state: Dict[str, Any], saved: Dict[str, Any]):
    """Copy a saved `Optimizer` state into `opt_state`: its moments (and
    accumulated gradients) tensor by tensor, its counters as ints."""
    for key, value in opt_state.items():
        if isinstance(value, dict):
            copy_into(value, saved[key], key)
        else:
            opt_state[key] = int(saved[key])


@dataclasses.dataclass(eq=False)
class ControlNetTrainer:
    """The frozen UNet and VAE and the trainable ControlNet (its working
    copy), bundled into a training step.

    A batch holds 'image' [B, H, W, 3] in [-1, 1] (the ground truth),
    'cond' [B, H, W, 6], 'flow' [B, H, W, 4] and 'text_embeds' [B, L, D];
    optionally 'latent_moments' [B, H/8, W/8, 8] (the encoder's mean and
    logvar, `train/latent_cache.py`) in place of the encode, and, for the
    residual variant, 'residual' (the target image) and 'warped' (passed on
    to the ControlNet).  Making the trainer freezes the UNet, the VAE and
    `lpips` (`train.lpips.LPIPS`, the perceptual term's network)
    (`requires_grad_(False)`)."""
    unet: torch.nn.Module
    controlnet: torch.nn.Module
    vae: AutoencoderKL
    schedule: NoiseSchedule
    config: TrainConfig
    lpips: Optional[torch.nn.Module] = None
    layout: Optional[Any] = None  # the mesh's, set by shard_state

    def __post_init__(self):
        self.unet.requires_grad_(False)
        self.vae.requires_grad_(False)
        if self.lpips is not None:
            self.lpips.requires_grad_(False)

    @torch.no_grad()
    def moments(self, batch) -> tuple:
        """(mean, logvar) of the ground truth's latent posterior, in the
        VAE's dtype: the cached moments, or the encoder's."""
        dtype = self.vae.quant_conv.weight.dtype
        if "latent_moments" in batch:
            return batch["latent_moments"].to(dtype).chunk(2, dim=-1)
        img = batch["residual"] if "residual" in batch else batch["image"]
        return self.vae.encode(img.to(dtype))

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None,
                noise=None, timesteps=None, latent_eps=None, moments=None):
        """(loss, metrics) of the global `batch`.  The draws (the
        posterior's eps like the mean, the fp32 noise like the latents and
        a timestep per sample in [0, num_train_timesteps)) are taken from
        `generator` in that order for the whole batch where they are not
        given; `moments` skips the encode.  On a mesh the batch, the draws
        and `moments` are the global batch's and this rank's loss is its
        data rows' (`row_taker`)."""
        cfg = self.config
        n = batch["cond"].shape[0]
        take = row_taker(self.layout, n)
        batch = shard_batch(self.layout and self.layout.mesh, batch)
        mean, logvar = (self.moments(batch) if moments is None
                        else map(take, moments))
        dev = mean.device
        if latent_eps is None:
            latent_eps = torch.randn((n, *mean.shape[1:]),
                                     generator=generator, device=dev)
        latents = (mean + torch.exp(0.5 * logvar) * take(latent_eps).to(
            mean.dtype)) * self.vae.cfg.scaling_factor
        if noise is None:
            noise = torch.randn((n, *latents.shape[1:]), generator=generator,
                                device=dev)
        if timesteps is None:
            timesteps = torch.randint(
                0, self.schedule.cfg.num_train_timesteps, (n,),
                generator=generator, device=dev)
        noise, timesteps = take(noise), take(timesteps)
        noisy = self.schedule.add_noise(latents, noise, timesteps)

        cn_args = (noisy, timesteps, batch["text_embeds"], batch["cond"],
                   batch["flow"])
        if "residual" in batch:
            cn_args = cn_args + (batch["warped"],)

        def unet_fwd(z, t, emb, down, mid):
            return self.unet(z, t, emb, down_block_additional_residuals=down,
                             mid_block_additional_residual=mid)

        if cfg.remat:
            # the reference's --gradient_checkpointing: both forwards are
            # recomputed in the backward
            down, mid = checkpoint(self.controlnet, *cn_args,
                                   use_reentrant=False)
            model_pred = checkpoint(unet_fwd, noisy, timesteps,
                                    batch["text_embeds"], down, mid,
                                    use_reentrant=False)
        else:
            down, mid = self.controlnet(*cn_args)
            model_pred = unet_fwd(noisy, timesteps, batch["text_embeds"],
                                  down, mid)

        loss_mse = diffusion_loss(self.schedule, model_pred, noise, latents,
                                  timesteps)
        loss = loss_mse
        metrics = {"loss_mse": loss_mse.detach()}
        if cfg.lpips_weight or cfg.edge_weight:
            img = batch["residual"] if "residual" in batch else batch["image"]
            lp, edge = pixel_losses(
                self.schedule, self.vae, noisy, model_pred, timesteps, img,
                lpips_model=self.lpips if cfg.lpips_weight else None)
            if cfg.lpips_weight:
                loss = loss + cfg.lpips_weight * lp
                metrics["loss_lpips"] = lp.detach()
            if cfg.edge_weight:
                loss = loss + cfg.edge_weight * edge
                metrics["loss_edge"] = edge.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics

    def gradients(self) -> Params:
        """The working copy's gradients by name, widened to fp32 (zeros
        for a parameter the loss did not reach)."""
        return {n: (p.grad.float() if p.grad is not None
                    else torch.zeros_like(p, dtype=torch.float32))
                for n, p in self.controlnet.named_parameters()}

    @torch.no_grad()
    def load_params(self, params: Params):
        """Copy the master parameters into the working copy (cast to its
        dtype; gathered from the slices on a mesh)."""
        for n, p in self.controlnet.named_parameters():
            src = params[n]
            if self.layout is not None:
                src = self.layout.gather(n, src.to(p.dtype))
            p.copy_(src)

    def shard_state(self, mesh, state: TrainState) -> TrainState:
        """Put `state` on `mesh` (`parallel/mesh.py`): this rank keeps its
        fsdp slice of each master and moment (the accumulated gradients
        too), by the JAX package's rule (`_fsdp_spec`: the largest
        dimension the fsdp size divides); later steps average gradients
        over the data ranks and gather the working copy back."""
        layout = FsdpLayout(mesh, {n: p.shape
                                   for n, p in state.params.items()})
        state.params = layout.shard_dict(state.params)
        state.opt_state = sliced(layout, state.opt_state)
        state.layout = self.layout = layout
        return state

    def update(self, state: TrainState) -> TrainState:
        """Apply the working copy's gradients (then dropped) to the master
        parameters, and copy these into the working copy."""
        grads = self.gradients()
        for p in self.controlnet.parameters():
            p.grad = None
        if self.layout is None:
            state.apply_gradients(grads)
        else:
            grads = self.layout.shard_dict(self.layout.mean_over_data(grads))
            state.apply_gradients(grads, self.layout.sq_norm)
        del grads
        self.load_params(state.params)
        return state

    def train_step(self, state: TrainState, batch,
                   generator: Optional[torch.Generator] = None, **draws):
        """One micro-step on the global `batch`: loss, backward, update.
        `draws` are `loss_fn`'s noise, timesteps and latent_eps.  Returns
        (state, metrics), the metrics the global batch's on a mesh."""
        loss, metrics = self.loss_fn(batch, generator, **draws)
        loss.backward()
        state = self.update(state)
        if self.layout is not None:
            metrics = self.layout.mean_metrics(metrics)
        return state, metrics

