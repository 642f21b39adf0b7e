"""CMP training: the flow losses, the learning-rate schedule, the SGD
optimizer, the reference's index samplers and the training step.

Counterpart: `diffcodec_tpu/train/cmp_train.py` (`quantize_flow` :34,
`discrete_flow_loss` :42, `_flow_edge` / `smooth_l1` / `edge_aware_loss`
:54-75, `cmp_lr_schedule` :81, `make_cmp_optimizer` :120, the samplers
:137-162, `CMPTrainer` :169-202, `_downsample_target` :205), itself the
reference's `cmp/losses.py` (DiscreteLoss, EdgeAwareLoss),
`cmp/utils/scheduler.py` (step decay with warmup knots) and
`cmp/utils/distributed_utils.py` (the samplers).

The optimizer is the JAX package's optax chain, written out:
  add_decayed_weights(weight_decay)  g + weight_decay * p, every tensor
  sgd(schedule, momentum)            trace = g + momentum * trace, then
                                     p += -lr(count) * trace, count from 0
The CMP trains in fp32; its BatchNorms normalise by the batch in training
mode and move their running statistics as flax's do
(`models/cmp.py::BatchNorm`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from diffcodec_tpu_torch.ops.flow import resize_bilinear
from diffcodec_tpu_torch.ops.sobel import sobel_magnitude
from diffcodec_tpu_torch.train.trainer import copy_into, load_opt_state


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def quantize_flow(target: torch.Tensor, nbins: int = 99,
                  fmax: float = 50.0) -> torch.Tensor:
    """[B, H, W, 2] flow -> int64 bin indices (`cmp/losses.py:76-79`):
    clipped to +-(fmax - 1e-3), floor((t + fmax) / step) with step =
    2 fmax / nbins, as the JAX package's jitted training step computes it:
    XLA turns the division by the constant step into a product with its
    fp32 reciprocal (0.990000069 for 99 bins over +-50), which puts 3 of the
    bin edges' fp32 neighbours in another bin than a true quotient does
    (JAX's eager call divides).  The reciprocal is a 0-dim tensor on the
    flow's device, so the card multiplies by the same fp32 value as the
    CPU."""
    inv = torch.full((), np.float32(1) / np.float32(2 * fmax / float(nbins)),
                     dtype=torch.float32, device=target.device)
    t = torch.clamp(target.float(), -fmax + 1e-3, fmax - 1e-3)
    return torch.floor((t + fmax) * inv).long()


def discrete_flow_loss(logits: torch.Tensor, target_flow: torch.Tensor,
                       nbins: int = 99, fmax: float = 50.0) -> torch.Tensor:
    """Cross-entropy over each axis's flow bins, the two means summed, in
    fp32 (or the logits' dtype where it is wider).  logits [B, H, W, 2
    nbins], target_flow [B, H, W, 2] (`cmp/losses.py:85-88`)."""
    q = quantize_flow(target_flow, nbins, fmax)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lx = torch.log_softmax(logits[..., :nbins], dim=-1)
    ly = torch.log_softmax(logits[..., nbins:], dim=-1)
    ce_x = -torch.gather(lx, -1, q[..., 0:1])
    ce_y = -torch.gather(ly, -1, q[..., 1:2])
    return ce_x.mean() + ce_y.mean()


def _flow_edge(flow: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-channel Sobel magnitude averaged over the channels
    (`cmp/losses.py:50-56`)."""
    return sobel_magnitude(flow, eps=eps).mean(-1, keepdim=True)


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


def edge_aware_loss(pred_flow: torch.Tensor,
                    target_flow: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 between the Sobel edge maps of the predicted and the
    target flow, the prediction resized to the target's size first
    (`cmp/losses.py:58-60`)."""
    th, tw = target_flow.shape[1:3]
    if tuple(pred_flow.shape[1:3]) != (th, tw):
        pred_flow = resize_bilinear(pred_flow, th, tw, align_corners=True)
    return smooth_l1(_flow_edge(pred_flow), _flow_edge(target_flow))


# ---------------------------------------------------------------------------
# learning-rate schedule and optimizer
# ---------------------------------------------------------------------------

def cmp_lr_schedule(base_lr: float, lr_steps: Sequence[int],
                    lr_mults: Sequence[float],
                    warmup_lr: Sequence[float] = (),
                    warmup_steps: Sequence[int] = ()
                    ) -> Callable[[int], float]:
    """Step decay with optional piecewise-linear warmup
    (`StepLRScheduler`): lr = base_lr times the mults of the steps passed;
    before the last warmup step, linear through the (warmup_steps[i],
    warmup_lr[i]) knots from base_lr at 0.

    Returns lr(count) as a Python float of the fp32 value of the JAX
    package's schedule under jit, as its training step computes it.  XLA
    evaluates the `jnp.where` chain in fp32 (each mult rounded in fp32 at
    its knot), folds a warmup segment's `(step - x0) / dx * dy` into one
    constant, fp32(fp32(1 / dx) * dy), and fuses the multiply and the add
    of y0 into one fma (one rounding).  A float64 schedule, or one that
    divides, lands an ulp off in places (`ROADMAP.md` C1)."""
    lr_steps, lr_mults = list(lr_steps), list(lr_mults)
    warmup_lr, warmup_steps = list(warmup_lr), list(warmup_steps)
    assert len(lr_steps) == len(lr_mults)
    assert len(warmup_lr) == len(warmup_steps)
    f32 = np.float32
    knots_x = [0.0] + [float(s) for s in warmup_steps]
    knots_y = [base_lr] + [float(v) for v in warmup_lr]
    # (x0, x1, y0 in fp32, the folded slope) of each warmup segment
    segments = [(f32(x0), f32(x1), f32(y0),
                 f32(f32(1 / f32(max(x1 - x0, 1.0))) * f32(y1 - y0)))
                for x0, x1, y0, y1 in zip(knots_x, knots_x[1:], knots_y,
                                          knots_y[1:])]

    def schedule(count: int) -> float:
        step = f32(count)
        lr = f32(base_lr)
        for s, m in zip(lr_steps, lr_mults):
            if step >= f32(s):
                lr = f32(lr * f32(m))
        if warmup_steps and step < f32(warmup_steps[-1]):
            lr = f32(knots_y[-1])
            for x0, x1, y0, slope in segments:
                if x0 <= step < x1:  # the product exact in float64, then
                    # the sum rounded as the fma rounds it
                    lr = f32(np.float64(step - x0) * np.float64(slope)
                             + np.float64(y0))
        return float(lr)

    return schedule


class SGD:
    """The JAX package's `make_cmp_optimizer` chain over a parameter dict:
    `init(params)` makes the state (the update count and the momentum
    trace, in the parameters' dtype), `update(params, grads, state)` applies one step in place."""

    def __init__(self, schedule: Callable[[int], float],
                 momentum: float = 0.9, weight_decay: float = 1e-4):
        self.lr, self.momentum, self.weight_decay = (schedule, momentum,
                                                     weight_decay)

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: Dict[str, Any]):
        lr = self.lr(state["count"])
        state["count"] += 1
        for n, p in params.items():
            g = grads[n] + self.weight_decay * p
            t = state["trace"][n]
            t.copy_(g + self.momentum * t)
            p.add_(-lr * t)


def make_cmp_optimizer(base_lr: float = 0.1,
                       lr_steps: Sequence[int] = (24000, 36000),
                       lr_mults: Sequence[float] = (0.1, 0.1),
                       momentum: float = 0.9,
                       weight_decay: float = 1e-4) -> SGD:
    """SGD with momentum on the reference config's step schedule."""
    return SGD(cmp_lr_schedule(base_lr, lr_steps, lr_mults), momentum,
               weight_decay)


# ---------------------------------------------------------------------------
# the reference's samplers (host-side index generators)
# ---------------------------------------------------------------------------

def distributed_sequential_indices(n: int, world_size: int,
                                   rank: int) -> np.ndarray:
    """Padded even split, sequential (`distributed_utils.py:113-134`)."""
    per_rank = -(-n // world_size)
    padded = np.arange(per_rank * world_size) % n
    return padded[rank * per_rank:(rank + 1) * per_rank]


def distributed_given_iteration_indices(n: int, total_iter: int,
                                        batch_size: int, world_size: int,
                                        rank: int,
                                        last_iter: int = -1) -> np.ndarray:
    """Seed-0 global shuffle (numpy's legacy RandomState(0)), this rank's
    slice, resumed after `last_iter` (`distributed_utils.py:176-227`)."""
    total_size = total_iter * batch_size
    all_size = total_size * world_size
    indices = np.arange(n)[:all_size]
    num_repeat = (all_size - 1) // indices.shape[0] + 1
    indices = np.tile(indices, num_repeat)[:all_size]
    rs = np.random.RandomState(0)
    rs.shuffle(indices)
    beg = total_size * rank
    indices = indices[beg:beg + total_size]
    return indices[(last_iter + 1) * batch_size:]


# ---------------------------------------------------------------------------
# training step
# ---------------------------------------------------------------------------

def _downsample_target(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if tuple(flow.shape[1:3]) != (h, w):
        return resize_bilinear(flow, h, w, align_corners=True)
    return flow


@dataclasses.dataclass(eq=False)
class CMPTrainer:
    """The CMP and its optimizer, bundled into a training step
    (DiscreteLoss; `cmp/models/cmp.py:57-64`).  The optimizer's state is
    `opt_state`; the parameters and the BatchNorm statistics live in the
    model.

    A batch holds 'image' [B, H, W, 3], 'sparse' [B, H, W, 4] (flow and
    mask) and 'flow_target' [B, H, W, 2]."""
    model: nn.Module
    tx: SGD
    nbins: int = 99
    fmax: float = 50.0

    def __post_init__(self):
        self.opt_state = self.tx.init(self.params())

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorms' running means and variances by name."""
        return {n: b for n, b in self.model.named_buffers()
                if n.endswith(("running_mean", "running_var"))}

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None):
        """The DiscreteLoss of the model in training mode (its BatchNorm
        statistics move); for the flownet decoder the mean over its four
        scales of the loss against the target resized to each.
        `generator` draws the AlexNet's dropout masks."""
        self.model.train()
        logits = self.model.logits(batch["image"], batch["sparse"],
                                   generator)
        scales = logits if isinstance(logits, list) else [logits]
        return sum(
            discrete_flow_loss(lg, _downsample_target(
                batch["flow_target"], lg.shape[1], lg.shape[2]),
                self.nbins, self.fmax)
            for lg in scales) / len(scales)

    def train_step(self, batch,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """One step: loss, backward, SGD update.  Returns the loss."""
        loss = self.loss_fn(batch, generator)
        loss.backward()
        params = self.params()
        grads = {n: p.grad for n, p in params.items()}
        self.tx.update(params, grads, self.opt_state)
        for p in params.values():
            p.grad = None
        return loss.detach()

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params(), "batch_stats": self.batch_stats(),
                "opt_state": self.opt_state}

    @torch.no_grad()
    def load_state_dict(self, saved: Dict[str, Any]) -> "CMPTrainer":
        """Copy a saved state into the model's tensors and the optimizer's
        (their devices); the names must match."""
        copy_into(self.params(), saved["params"], "params")
        copy_into(self.batch_stats(), saved["batch_stats"], "batch_stats")
        load_opt_state(self.opt_state, saved["opt_state"])
        return self
