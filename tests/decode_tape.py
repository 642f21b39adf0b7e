"""A whole decode read from inside each package's sample call, for the
tests that hold the port's decode against JAX's step by step
(`test_torch_port_fulldepth.py`, `test_torch_port_longrun.py`,
`test_torch_port_fulldepth_longrun.py`).

Neither sampler shows its inside to its caller: JAX's denoise loop is one
`lax.fori_loop` inside a jitted function, the port's a Python loop.  Both
are read at the same points, each package on its own side:

- the ControlNet trunk (`backbone`) at every call: its input latents,
  timestep, down residuals and mid residual.  JAX's through
  `jax.debug.callback` in a subclass of its `DualFlowControlNet` (inside
  `lax.cond` where an interval skips the network, so only the calls that
  run are sent); the port's by wrapping the instance's method;
- every UniPC step: its timestep and the latents it returns.  JAX's
  through a subclass of its `UniPC` that its pipeline module uses in place
  of its own while the sampler is traced; the port's the same on the
  port's pipeline module;
- the distilled decode's consistency function (`_f`) at every step: its
  timestep and the x0 it returns, through a subclass of JAX's
  `DistilledPipeline` and a wrapper of the port's instance.

Each run is that package's own entry point (`sample`), JAX's jitted, in
fp32 or in bf16 as `bench.py` runs it: the modules' dtype bf16, the
parameters cast inside the jitted function, the prompts, conditioning and
flows cast, the noise (and the distilled decode's re-noises) fp32.
`result` turns what a run recorded into one dict of float32 arrays.
"""

import contextlib
import gc
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.sampling import pipeline as jpipeline
from diffcodec_tpu.sampling.distilled import DistilledPipeline as JDistilled
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule
from diffcodec_tpu.sampling.schedulers import UniPC as JUniPC

from chip_smoke import within_bf16_rule
from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.sampling import pipeline as tpipeline
from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule, UniPC
from test_torch_port_fullwidth import rel_l2

# the inputs that bench.py casts to the compute dtype
CAST = ("text", "uncond", "cond", "flow")


def n_down(unet_cfg) -> int:
    """The ControlNet's down residuals: conv_in's, one a layer, one a
    downsampler (every level but the last)."""
    levels = len(unet_cfg.block_out_channels)
    return 1 + levels * unet_cfg.layers_per_block + levels - 1


def result(calls, steps, images) -> dict:
    """{name: float32 array}: the first ControlNet call's down residuals
    (`down0`, ...) and mid residual, the latents after each step
    (`latents_step1`, ...) and the images; `timesteps` the steps'
    timesteps and `controlnet_timesteps` the ControlNet calls', each in
    the order the loop ran them (timesteps descend over a decode).

    calls: [(sample, t, down, mid)]; steps: [(t, latents)]."""
    calls = sorted(calls, key=lambda c: -float(np.max(c[1])))
    steps = sorted(steps, key=lambda s: -float(np.max(s[0])))
    out = {f"down{i}": d for i, d in enumerate(calls[0][2])}
    out["mid"] = calls[0][3]
    for k, (_, z) in enumerate(steps):
        out[f"latents_step{k + 1}"] = z
    out["images"] = images
    out["timesteps"] = np.asarray([int(np.max(t)) for t, _ in steps])
    out["controlnet_timesteps"] = np.asarray([int(np.max(c[1]))
                                              for c in calls])
    return out


# ---- JAX's side ----

_TAPE = {"controlnet": [], "step": []}


def _record(kind):
    def record(*args):
        _TAPE[kind].append(jax.tree.map(
            lambda a: np.array(a, np.float32), args))
    return record


class RecordingControlNet(JControlNet):
    """JAX's DualFlowControlNet, its backbone's inputs and outputs sent to
    the host at every call that runs."""

    def backbone(self, sample, timesteps, encoder_hidden_states, pyramid,
                 conditioning_scale=1.0):
        down, mid = super().backbone(sample, timesteps, encoder_hidden_states,
                                     pyramid, conditioning_scale)
        jax.debug.callback(_record("controlnet"), sample, timesteps,
                           list(down), mid)
        return down, mid


class _RecordingUniPC(JUniPC):
    """JAX's UniPC, each step's timestep and result sent to the host."""

    def step(self, tables, state, model_output, i):
        state = super().step(tables, state, model_output, i)
        jax.debug.callback(_record("step"), tables.timesteps[i],
                           state.sample)
        return state


class _RecordingDistilled(JDistilled):
    """JAX's DistilledPipeline, each consistency step's timestep and x0
    sent to the host."""

    def _f(self, params, pyramid, x, t, text):
        x0 = super()._f(params, pyramid, x, t, text)
        jax.debug.callback(_record("step"), t, x0)
        return x0


def _cast(params, dtype):
    """The parameters in the compute dtype, as bench.py casts them (inside
    the jitted function: no second copy on the host)."""
    return jax.tree.map(lambda a: a.astype(dtype), params)


def _jax_inputs(x, dtype):
    return {k: jnp.asarray(v).astype(dtype) if k in CAST else jnp.asarray(v)
            for k, v in x.items()}


def _take_tape():
    jax.effects_barrier()
    taken = {k: list(v) for k, v in _TAPE.items()}
    for v in _TAPE.values():
        v.clear()
    return taken


def _jax_nets(cfgs, dtype) -> dict:
    unet_cfg, controlnet_cfg, vae_cfg = cfgs
    return dict(unet=JUNet(unet_cfg, dtype=dtype),
                controlnet=RecordingControlNet(controlnet_cfg, dtype=dtype),
                vae=JVAE(vae_cfg, dtype=dtype),
                schedule=JSchedule.create(jcfg.SchedulerConfig()))


def _jax_call(sample, params, x, dtype) -> dict:
    """sample(params, inputs) jitted, with the recording UniPC in JAX's
    pipeline module while it is traced; -> `result`."""
    _take_tape()
    with mock.patch.object(jpipeline, "UniPC", _RecordingUniPC):
        images = np.array(jax.jit(sample)(params, _jax_inputs(x, dtype)),
                          np.float32)
    tape = _take_tape()
    jax.clear_caches()
    return result(tape["controlnet"], tape["step"], images)


def jax_sample(cfgs, sampler: dict, params, x, dtype) -> dict:
    """JAX's jitted DualFlowPipeline.sample in `dtype`.  cfgs: JAX's
    (UNet, ControlNet, VAE) configs; sampler: SamplerConfig's fields; x:
    numpy inputs (latents, text, uncond, cond, flow)."""
    pipe = jpipeline.DualFlowPipeline(sampler=jcfg.SamplerConfig(**sampler),
                                      **_jax_nets(cfgs, dtype))

    def sample(p, x):
        return pipe.sample(_cast(p, dtype), jax.random.PRNGKey(0), x["text"],
                           x["uncond"], x["cond"], x["flow"],
                           latents=x["latents"])
    return _jax_call(sample, params, x, dtype)


def jax_distilled(cfgs, distill: dict, params, x, dtype, rng) -> dict:
    """JAX's jitted DistilledPipeline.sample in `dtype`, its re-noises
    drawn from `rng` (`jax_noises` gives the same draws)."""
    pipe = _RecordingDistilled(config=jcfg.DistillConfig(**distill),
                               **_jax_nets(cfgs, dtype))

    def sample(p, x):
        return pipe.sample(_cast(p, dtype), rng, x["text"], x["cond"],
                           x["flow"], latents=x["latents"])
    return _jax_call(sample, params, x, dtype)


def jax_noises(rng, K, shape) -> list:
    """The K - 1 re-noises JAX's `DistilledPipeline.sample` draws from
    `rng` (its key splits, `distilled.py:96` and `:83-85`)."""
    _, rng_steps = jax.random.split(rng)
    out = []
    for _ in range(1, K):
        rng_steps, rk = jax.random.split(rng_steps)
        out.append(np.asarray(jax.random.normal(rk, shape, jnp.float32)))
    return out


# ---- the port's side ----

def port_pipeline(cfgs, sampler: dict, params) -> DualFlowPipeline:
    """The port's pipeline in fp32 on the CPU, each network made on the
    meta device, allocated and filled by the bridge
    (`weights.load_flax_params`); `params` is emptied network by network
    as the port takes it over.  cfgs: the port's (UNet, ControlNet, VAE)
    configs."""
    unet_cfg, controlnet_cfg, vae_cfg = cfgs
    made = {}
    for name, make, name_map in (
            ("vae", lambda: AutoencoderKL(vae_cfg),
             weights.vae_name_map(vae_cfg)),
            ("controlnet", lambda: DualFlowControlNet(controlnet_cfg),
             weights.controlnet_name_map(controlnet_cfg)),
            ("unet", lambda: UNet2DConditionModel(unet_cfg),
             weights.unet_name_map(unet_cfg))):
        with torch.device("meta"):
            module = make()
        module = module.to_empty(device="cpu")
        weights.load_flax_params(module, params.pop(name), name_map)
        made[name] = module.eval().requires_grad_(False)
        gc.collect()
    return DualFlowPipeline(
        schedule=NoiseSchedule.create(tcfg.SchedulerConfig()),
        sampler=tcfg.SamplerConfig(**sampler), **made)


@contextlib.contextmanager
def _port_recording(controlnet):
    """Records the port's ControlNet calls and UniPC steps while inside:
    yields (calls, steps), filled as `result` takes them."""
    calls, steps = [], []
    backbone = controlnet.backbone

    def recording_backbone(sample, t, *args):
        down, mid = backbone(sample, t, *args)
        calls.append((sample.float().numpy(), np.asarray(t),
                      [d.float().numpy() for d in down],
                      mid.float().numpy()))
        return down, mid

    class RecordingUniPC(UniPC):
        def step(self, tables, state, model_output, i):
            state = super().step(tables, state, model_output, i)
            steps.append((np.asarray(tables.timesteps[i]),
                          state.sample.float().numpy()))
            return state

    controlnet.backbone = recording_backbone
    try:
        with mock.patch.object(tpipeline, "UniPC", RecordingUniPC):
            yield calls, steps
    finally:
        del controlnet.backbone


def _port_inputs(x, dtype):
    return {k: torch.from_numpy(v).to(dtype) if k in CAST
            else torch.from_numpy(v) for k, v in x.items()}


@torch.no_grad()
def port_sample(pipe, x, dtype) -> dict:
    """The port's DualFlowPipeline.sample with its modules in `dtype`
    (cast in place)."""
    for m in (pipe.unet, pipe.controlnet, pipe.vae):
        m.to(dtype)
    t = _port_inputs(x, dtype)
    with _port_recording(pipe.controlnet) as (calls, steps):
        images = pipe.sample(t["latents"], t["text"], t["uncond"], t["cond"],
                             t["flow"])
    return result(calls, steps, images.float().numpy())


@torch.no_grad()
def port_distilled(pipe: DistilledPipeline, x, dtype, noises) -> dict:
    """The port's DistilledPipeline.sample with its modules in `dtype`
    (cast in place), fed the re-noises `noises` (numpy, fp32)."""
    for m in (pipe.unet, pipe.controlnet, pipe.vae):
        m.to(dtype)
    t = _port_inputs(x, dtype)
    with _port_recording(pipe.controlnet) as (calls, steps):
        f = pipe._f

        def recording_f(pyramid, sample, timestep, text):
            x0 = f(pyramid, sample, timestep, text)
            steps.append((np.asarray(timestep), x0.float().numpy()))
            return x0

        pipe._f = recording_f
        try:
            images = pipe.sample(
                t["latents"], t["text"], t["cond"], t["flow"],
                noises=[torch.from_numpy(n.copy()) for n in noises])
        finally:
            del pipe._f
    return result(calls, steps, images.float().numpy())


# ---- the comparison ----

def bf16_errors(runs, name) -> tuple:
    """(e_jax, e_port, d) of one output: relL2 of JAX's bf16 and of the
    port's bf16 against JAX's fp32, and of the port's bf16 against JAX's
    bf16."""
    jf, jb, pb = (runs[k][name] for k in ("jax_fp32", "jax_bf16",
                                          "port_bf16"))
    return rel_l2(jb, jf), rel_l2(pb, jf), rel_l2(pb, jb)


def within_jax_rounding(runs, name) -> tuple:
    """(holds, e_jax, e_port, d): the port's bf16 output by
    `chip_smoke.within_bf16_rule`, JAX's bf16 error its scale."""
    e_jax, e_port, d = bf16_errors(runs, name)
    ok = bool(np.isfinite(e_jax) and e_jax > 0
              and within_bf16_rule(e_jax, e_port, d))
    return ok, e_jax, e_port, d


def step_ratios(runs, steps: int) -> np.ndarray:
    """e_port / e_jax on the latents after each step."""
    return np.asarray([e_port / e_jax for e_jax, e_port, _ in (
        bf16_errors(runs, f"latents_step{k}") for k in range(1, steps + 1))])


def summary(label: str, runs, steps: int, **extra) -> dict:
    """What a comparison read, printed as one JSON line (shown by pytest's
    `-s`): for each output [e_jax, e_port / e_jax, d / e_jax] and the fp32
    port's largest difference from JAX beside JAX's largest magnitude;
    the latents' e_port / e_jax over the steps; `extra` as given."""
    names = [k for k in runs["jax_fp32"] if not k.endswith("timesteps")]
    bf16 = {}
    for name in names:
        e_jax, e_port, d = bf16_errors(runs, name)
        bf16[name] = [e_jax, e_port / e_jax, d / e_jax]
    fp32 = {name: [float(np.abs(runs["port_fp32"][name]
                                - runs["jax_fp32"][name]).max()),
                   float(np.abs(runs["jax_fp32"][name]).max())]
            for name in names}
    out = dict(label=label, columns=["e_jax", "e_port/e_jax", "d/e_jax"],
               bf16=bf16, fp32_max_diff_and_max_abs=fp32,
               step_ratios=step_ratios(runs, steps).tolist(), **extra)
    print(json.dumps(out), flush=True)
    return out
