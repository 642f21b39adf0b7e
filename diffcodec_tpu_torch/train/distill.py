"""Consistency distillation of the DualFlow decoder into a K-step student:
the consistency parameterization, the teacher's DDIM step, the state and
the training step.

Counterpart: `diffcodec_tpu/train/distill.py` (`boundary_scalings` :60-72,
`ddim_grid` :75-82, `ddim_step` :85-98, `DistillState` :104-116,
`ConsistencyDistiller` :119-234).  The teacher is the frozen UNet and
DualFlowControlNet under classifier-free guidance at the pinned guidance
and conditioning scales; the student and its EMA target have the same
architecture and start from the teacher's weights, and both of the
student's networks train.  The objective is consistency distillation:

    L = huber(f_student(x_{t_n}, t_n), sg[f_ema(x_{t_m}, t_m)])

with x_{t_m} the teacher's one DDIM step from x_{t_n} down the
`num_teacher_steps`-point grid, and f(x, t) = c_skip(t) x + c_out(t) x0.

Mixed precision as in `train/trainer.py`: three working copies in the
compute dtype (the frozen teacher, the student and the EMA target, each a
`denoiser(unet, controlnet)`), the student's fp32 masters and the fp32 EMA
in the `DistillState`, and both copied back into their working copies
after each update.  The teacher's and the target's forwards run under
`torch.no_grad()` (JAX's stop-gradient), so no graph and no attention
log-sum-exp is kept for them.  `shard_state` puts the state on a
`parallel/mesh.py` mesh as the JAX package's does (`distill.py:236-257`):
each rank keeps its fsdp slice of the masters, the EMA and Adam's
moments, a step averages the student's gradients over the data ranks,
clips by the whole gradient's norm, updates the slices and gathers the
student's and the target's working copies back; every rank is given the
global batch and draws for all of it, keeping its rows.  `jit_train_step` has no
counterpart (eager).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from diffcodec_tpu_torch.config import DistillConfig
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.parallel.mesh import (FsdpLayout, row_taker,
                                               shard_batch)
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule, cfg_combine
from diffcodec_tpu_torch.train import checkpoint as ckpt
from diffcodec_tpu_torch.train.trainer import (Optimizer, Params, copy_into,
                                               gathered,
                                               load_opt_state, sliced)


def boundary_scalings(timesteps, sigma_data: float = 0.5,
                      timestep_scaling: float = 10.0):
    """(c_skip, c_out), fp32 tensors shaped like `timesteps`, for the
    boundary-conditioned consistency function
    f(x_t, t) = c_skip(t) x_t + c_out(t) x0(x_t, t).

    Raw train-schedule timesteps map to a karras-like sigma axis (LCM's
    choice: sigma_data 0.5, t / 1000 * 10); c_skip(0) = 1, c_out(0) = 0."""
    s = torch.as_tensor(timesteps).float() * (timestep_scaling / 1000.0)
    c_skip = sigma_data ** 2 / (s ** 2 + sigma_data ** 2)
    c_out = s / torch.sqrt(s ** 2 + sigma_data ** 2)
    return c_skip, c_out


def ddim_grid(schedule: NoiseSchedule, num_teacher_steps: int) -> np.ndarray:
    """Descending teacher timestep grid [n], int64, in equal strides
    shifted so that it starts at T - 1."""
    T = schedule.cfg.num_train_timesteps
    stride = T // num_teacher_steps
    ts = np.arange(num_teacher_steps - 1, -1, -1, dtype=np.int64) * stride
    return ts + (T - 1 - ts[0])


def ddim_step(schedule: NoiseSchedule, sample: torch.Tensor,
              eps: torch.Tensor, t, t_prev) -> torch.Tensor:
    """Deterministic DDIM x_t -> x_{t_prev} (epsilon parameterisation,
    eta = 0), fp32; t and t_prev are ints or [B] tensors, and t_prev < 0
    means "to x0" (abar_prev = 1)."""
    x0 = schedule.pred_original_sample(sample, eps, t)
    t_prev = torch.as_tensor(t_prev, device=sample.device)
    table = torch.from_numpy(schedule.alphas_cumprod).to(sample.device)
    abar_prev = torch.where(t_prev >= 0, table[t_prev.clamp(min=0).long()],
                            torch.ones((), device=sample.device))
    abar_prev = abar_prev.reshape((-1,) + (1,) * (sample.dim() - 1))
    return (torch.sqrt(abar_prev) * x0
            + torch.sqrt(1.0 - abar_prev) * eps.float())


def denoiser(unet: nn.Module, controlnet: nn.Module) -> nn.ModuleDict:
    """A UNet and its ControlNet as one module: its parameters are named
    'unet.*' and 'controlnet.*', the layout of every parameter dict here."""
    return nn.ModuleDict({"unet": unet, "controlnet": controlnet})


@dataclasses.dataclass(eq=False)
class DistillState:
    """The update count, the student's fp32 master parameters, the fp32
    EMA target (a copy of the masters at creation) and the optimizer's
    state, all keyed by `denoiser` names; this rank's fsdp slices on a
    mesh (`layout`, set by `ConsistencyDistiller.shard_state`)."""
    step: int
    params: Params
    ema_params: Params
    opt_state: Dict[str, Any]
    tx: Optimizer
    layout: Optional[Any] = None

    @classmethod
    def create(cls, params: Params, tx: Optimizer) -> "DistillState":
        params = {n: p.detach().float().clone() for n, p in params.items()}
        return cls(step=0, params=params,
                   ema_params={n: p.clone() for n, p in params.items()},
                   opt_state=tx.init(params), tx=tx)

    def state_dict(self) -> Dict[str, Any]:
        """The whole state, gathered on a mesh (every rank must call it)."""
        return {"step": self.step,
                "params": gathered(self.layout, self.params),
                "ema_params": gathered(self.layout, self.ema_params),
                "opt_state": gathered(self.layout, self.opt_state)}

    @torch.no_grad()
    def load_state_dict(self, saved: Dict[str, Any]) -> "DistillState":
        """Copy a saved (whole) state into this one's tensors (their
        devices and dtypes; this rank's slices on a mesh); the names must
        match."""
        for key in ("params", "ema_params"):
            copy_into(getattr(self, key), sliced(self.layout, saved[key]),
                      key)
        load_opt_state(self.opt_state, sliced(self.layout,
                                              saved["opt_state"]))
        self.step = int(saved["step"])
        return self


def save_distill_checkpoint(ckpt_dir: str, state: DistillState,
                            total_limit: Optional[int] = None) -> str:
    """`checkpoint-{state.step}/state.pt` with the step, masters, EMA and
    optimizer state (`train/checkpoint.py`'s rotation)."""
    return ckpt.save_checkpoint(ckpt_dir, state.step, state.state_dict(),
                                total_limit=total_limit)


def restore_distill_checkpoint(ckpt_dir: str, state: DistillState,
                               step: Optional[int] = None
                               ) -> Tuple[Optional[DistillState], int]:
    """(state filled from checkpoint-{step}, the latest where step is None,
    step), or (None, 0) where there is none."""
    saved, step = ckpt.restore_checkpoint(ckpt_dir, step)
    if saved is None:
        return None, 0
    return state.load_state_dict(saved), step


@torch.no_grad()
def load_student(unet: nn.Module, controlnet: nn.Module,
                 params: Params) -> None:
    """Put a `denoiser`-keyed parameter dict (a state's EMA masters, as the
    decode CLIs use them) into a UNet and its ControlNet, cast to their
    dtypes on their devices; every parameter of both must be given."""
    own = dict(denoiser(unet, controlnet).named_parameters())
    copy_into(own, params, "student")


@dataclasses.dataclass(eq=False)
class ConsistencyDistiller:
    """The teacher, student and EMA-target working copies (`denoiser`s)
    and the frozen VAE, bundled into a training step.

    A batch holds 'image' [B, H, W, 3] in [-1, 1], 'cond' [B, H, W, 6],
    'flow' [B, H, W, 4], 'text_embeds' and 'uncond_embeds' [B, L, D].
    Making the distiller freezes the teacher, the target and the VAE
    (`requires_grad_(False)`) and lets every parameter of the student
    train, its UNet included."""
    teacher: nn.ModuleDict
    student: nn.ModuleDict
    target: nn.ModuleDict
    vae: AutoencoderKL
    schedule: NoiseSchedule
    config: DistillConfig
    layout: Optional[Any] = None  # the mesh's, set by shard_state

    def __post_init__(self):
        for m in (self.teacher, self.target, self.vae):
            m.requires_grad_(False)
        self.student.requires_grad_(True)

    @classmethod
    def create(cls, unet: nn.Module, controlnet: nn.Module,
               vae: AutoencoderKL, schedule: NoiseSchedule,
               config: DistillConfig, tx: Optimizer,
               dtype: torch.dtype = torch.bfloat16):
        """(distiller, state) from the teacher's modules: the student's
        masters and the EMA from the teacher's weights (the warm start),
        then the teacher cast to `dtype` and copied twice for the student
        and the target; the VAE cast to `dtype`."""
        teacher = denoiser(unet, controlnet)
        state = DistillState.create(dict(teacher.named_parameters()), tx)
        teacher = teacher.to(dtype).eval()
        student = copy.deepcopy(teacher)
        target = copy.deepcopy(teacher).eval()
        return cls(teacher=teacher, student=student, target=target,
                   vae=vae.to(dtype).eval(), schedule=schedule,
                   config=config), state

    @property
    def dtype(self) -> torch.dtype:
        return self.student["unet"].dtype

    @property
    def _freeu(self):
        c = self.config
        return ((c.freeu_s1, c.freeu_s2, c.freeu_b1, c.freeu_b2)
                if c.freeu else None)

    def _eps(self, net: nn.ModuleDict, x, t, ctx, cond, flow, cond_scale):
        cn = net["controlnet"]
        pyramid = cn.extract_pyramid(cond, flow)
        down, mid = cn.backbone(x, t, ctx, pyramid, cond_scale)
        return net["unet"](x, t, ctx, down_block_additional_residuals=down,
                           mid_block_additional_residual=mid,
                           freeu=self._freeu)

    @torch.no_grad()
    def teacher_eps(self, x, t, text, uncond, cond, flow):
        """The teacher's prediction under CFG at the pinned guidance scale:
        one call on the batch doubled as [uncond, text], then
        `cfg_combine` in the networks' dtype."""
        c = self.config
        eps = self._eps(self.teacher, torch.cat([x, x]), torch.cat([t, t]),
                        torch.cat([uncond, text]), torch.cat([cond, cond]),
                        torch.cat([flow, flow]),
                        c.controlnet_conditioning_scale)
        eps_u, eps_t = eps.chunk(2)
        return cfg_combine(eps_u, eps_t, c.guidance_scale)

    def consistency_fn(self, net: nn.ModuleDict, x, t, text, cond, flow):
        """f(x_t, t), fp32: the boundary-scaled x0 prediction at a [B]
        tensor of timesteps, with no CFG batch."""
        c = self.config
        eps = self._eps(net, x, t, text, cond, flow,
                        c.controlnet_conditioning_scale)
        x0 = self.schedule.pred_original_sample(x, eps, t)
        c_skip, c_out = boundary_scalings(t, c.sigma_data,
                                          c.timestep_scaling)
        shape = (-1,) + (1,) * (x.dim() - 1)
        return c_skip.reshape(shape) * x.float() + c_out.reshape(shape) * x0

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None,
                latent_eps=None, idx=None, noise=None):
        """(loss, metrics) of the global `batch`.  The draws (the
        posterior's eps like the mean, a grid index per sample in
        [0, n - 2] and the fp32 noise like the latents) are taken from
        `generator` in that order for the whole batch where they are not
        given.  On a mesh the batch and the draws are the global batch's
        and this rank's loss is its data rows' (`row_taker`)."""
        c = self.config
        dtype = self.dtype
        n = batch["cond"].shape[0]
        take = row_taker(self.layout, n)
        batch = shard_batch(self.layout and self.layout.mesh, batch)
        with torch.no_grad():
            mean, logvar = self.vae.encode(
                batch["image"].to(self.vae.quant_conv.weight.dtype))
        dev = mean.device
        if latent_eps is None:
            latent_eps = torch.randn((n, *mean.shape[1:]),
                                     generator=generator, device=dev)
        latents = ((mean + torch.exp(0.5 * logvar) * take(latent_eps).to(
            mean.dtype)) * self.vae.cfg.scaling_factor).float()

        grid = torch.from_numpy(ddim_grid(self.schedule,
                                          c.num_teacher_steps)).to(dev)
        if idx is None:
            idx = torch.randint(0, grid.shape[0] - 1, (n,),
                                generator=generator, device=dev)
        idx = take(idx.to(dev).long())
        t_n, t_m = grid[idx], grid[idx + 1]
        if noise is None:
            noise = torch.randn((n, *latents.shape[1:]),
                                generator=generator, device=dev)
        noise = take(noise)
        x_tn = self.schedule.add_noise(latents, noise, t_n).to(dtype)

        text, uncond = batch["text_embeds"], batch["uncond_embeds"]
        cond, flow = batch["cond"], batch["flow"]
        eps_t = self.teacher_eps(x_tn, t_n, text, uncond, cond, flow)
        x_tm = ddim_step(self.schedule, x_tn, eps_t, t_n, t_m).to(dtype)

        f_student = self.consistency_fn(self.student, x_tn, t_n, text, cond,
                                        flow)
        with torch.no_grad():
            f_target = self.consistency_fn(self.target, x_tm, t_m, text,
                                           cond, flow)
        err = f_student - f_target
        if c.loss == "huber":
            loss = torch.mean(torch.sqrt(err * err + c.huber_c ** 2)
                              - c.huber_c)
        else:
            loss = torch.mean(err * err)
        return loss, {"loss": loss.detach(), "t_mean": t_n.float().mean()}

    def gradients(self) -> Params:
        """The student working copy's gradients by name, in its dtype
        (zeros for a parameter the loss did not reach); the optimizer
        widens each to fp32 as it uses it."""
        return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                for n, p in self.student.named_parameters()}

    @torch.no_grad()
    def load_params(self, state: DistillState):
        """Copy the masters into the student and the EMA into the target
        (cast to their dtype; gathered from the slices on a mesh)."""
        for net, params in ((self.student, state.params),
                            (self.target, state.ema_params)):
            for n, p in net.named_parameters():
                src = params[n]
                if self.layout is not None:
                    src = self.layout.gather(n, src.to(p.dtype))
                p.copy_(src)

    def shard_state(self, mesh, state: DistillState) -> DistillState:
        """Put `state` on `mesh` (`parallel/mesh.py`): this rank keeps its
        fsdp slice of each master, EMA tensor and Adam moment, by the JAX
        package's rule (`_fsdp_spec`), so three SD-scale trees fit beside
        the teacher."""
        layout = FsdpLayout(mesh, {n: p.shape
                                   for n, p in state.params.items()})
        state.params = layout.shard_dict(state.params)
        state.ema_params = layout.shard_dict(state.ema_params)
        state.opt_state = sliced(layout, state.opt_state)
        state.layout = self.layout = layout
        return state

    @torch.no_grad()
    def update_ema(self, state: DistillState):
        """optax.incremental_update(new, ema, 1 - ema_decay) in fp32:
        ema <- (1 - decay) new + decay ema."""
        s = 1.0 - self.config.ema_decay
        for n, e in state.ema_params.items():
            e.copy_(s * state.params[n] + (1.0 - s) * e)

    def update(self, state: DistillState) -> DistillState:
        """Apply the student's gradients (then dropped) to the masters,
        move the EMA toward them, and copy both into their working
        copies."""
        grads = self.gradients()
        for p in self.student.parameters():
            p.grad = None
        if self.layout is None:
            state.tx.update(state.params, grads, state.opt_state)
        else:
            grads = self.layout.shard_dict(self.layout.mean_over_data(grads))
            state.tx.update(state.params, grads, state.opt_state,
                            self.layout.sq_norm)
        del grads
        state.step += 1
        self.update_ema(state)
        self.load_params(state)
        return state

    def train_step(self, state: DistillState, batch,
                   generator: Optional[torch.Generator] = None, **draws):
        """One step on the global `batch`: loss, backward, update.
        `draws` are `loss_fn`'s latent_eps, idx and noise.  Returns
        (state, metrics), the metrics the global batch's on a mesh."""
        loss, metrics = self.loss_fn(batch, generator, **draws)
        loss.backward()
        state = self.update(state)
        if self.layout is not None:
            metrics = self.layout.mean_metrics(metrics)
        return state, metrics

