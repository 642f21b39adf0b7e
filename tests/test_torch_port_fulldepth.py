"""The main path at SD-1.5's real depth, JAX against the port, on the CPU:
the whole decode (`DualFlowPipeline.sample`) with CFG over UniPC steps, in
fp32 and in bf16, and the name maps whole.

Configs: `UNetConfig()`, `ControlNetConfig()` and `VAEConfig()` with no cut:
2 layers a block (3 resnets a level in the up path), widths
320/640/1280/1280, 8 heads, cross-attention over 77 x 768 tokens, the
ControlNet's 12 zero-conv residual heads and its mid head.  The sampler at
`bench.py`'s point (guidance 3.5, ControlNet scale 1.35, FreeU on) with 3
UniPC steps: the predictor, the corrector and the multistep history all
act.  One inter frame at 64 px (8 x 8 latents), so CFG runs batch 2.
Parameters take their shapes from `jax.eval_shape(model.init, ...)` and
seeded float32 values (`test_torch_port_fullwidth._draw`), carried into the
port by `weights.load_flax_params`; the conditioning (uniform in [-1, 1]),
the flows (2 N(0, 1) px), the two prompt embeddings (0.1 N(0, 1)) and the
initial noise (N(0, 1)) are drawn by numpy from a seed, the noise passed
in on both sides.

Each package runs its own entry point: JAX's jitted `DualFlowPipeline.
sample` (the loop one `lax.fori_loop`) and the port's eager one, in fp32
and in bf16 as `bench.py` runs it (the modules' dtype bf16, the parameters
cast inside the jitted function, the prompts, conditioning and flows cast,
the noise fp32).  What is compared is taken from inside those calls: every
ControlNet call's input latents, timestep, 12 down residuals and mid
residual (JAX's through `jax.debug.callback` in a subclass of its
ControlNet, the port's by wrapping `backbone`), the final latents (JAX's
VAE input times the scaling factor, the port's `denoise` output) and the
images.

fp32: the port against JAX element by element at the tiny pipeline test's
limits, atol 1e-3 and rtol 1e-3 (`test_torch_port_pipeline.py`: UniPC's
x0 prediction divides by sqrt(abar_t), 0.07 at t = 999, which magnifies
the networks' summation-order differences).  bf16: every output held to
`chip_smoke.within_bf16_rule` against JAX's fp32 and bf16 runs, as
`test_torch_port_fullwidth.py` holds one network call, and the latents
after each step too.  Read on an 8-core x86 host: e_port / e_jax 0.94-0.97
on the 13 residuals (e_jax 0.0057-0.025), 0.94, 0.95 and 0.94 on the
latents after steps 1, 2 and 3 (e_jax 0.021, 0.019, 0.019; d / e_jax
1.41, 1.41, 1.39) and 1.02 on the images (d / e_jax 1.29); the fp32 port
at most 2.9e-4 from JAX, on latents of up to 58.  The file takes ~100 s
and ~14 GB at its peak (JAX's bf16 run) in one process.

The name maps: every leaf of JAX's parameter tree at the three full
configs maps to exactly one port parameter, of the transposed shape, and
every port parameter is mapped; the checkpoint-directory loader
(`models/weights.py`) reads exactly the port's parameter names, the JAX
loader's names too.  Shapes only (the port's modules on the meta device).
"""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models import hf_import
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.sampling.pipeline import DualFlowPipeline as JPipeline
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule

from chip_smoke import within_bf16_rule
from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models import weights as checkpoints
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from test_torch_port_fullwidth import _draw, rel_l2

H, FRAMES, L, STEPS = 64, 1, 77, 3
# the tiny pipeline test's limits (test_torch_port_pipeline.py)
FP32_ATOL, FP32_RTOL = 1e-3, 1e-3
SAMPLER = dict(num_inference_steps=STEPS, guidance_scale=3.5,
               controlnet_conditioning_scale=1.35, freeu=True)
JU, TU = jcfg.UNetConfig(), tcfg.UNetConfig()
JC, TC = jcfg.ControlNetConfig(), tcfg.ControlNetConfig()
JV, TV = jcfg.VAEConfig(), tcfg.VAEConfig()
N_DOWN = 12
# the inputs that bench.py casts to the compute dtype
CAST = ("text", "uncond", "cond", "flow")


def _inputs():
    rng = np.random.default_rng(20)
    f32, h, D = np.float32, H // 8, JU.cross_attention_dim
    return dict(
        latents=rng.standard_normal((FRAMES, h, h, 4)).astype(f32),
        text=(0.1 * rng.standard_normal((FRAMES, L, D))).astype(f32),
        uncond=(0.1 * rng.standard_normal((FRAMES, L, D))).astype(f32),
        cond=rng.uniform(-1, 1, (FRAMES, H, H, 6)).astype(f32),
        flow=(2 * rng.standard_normal((FRAMES, H, H, 4))).astype(f32))


X = _inputs()


@functools.lru_cache(maxsize=None)
def _shapes():
    """{network: JAX's parameter tree of ShapeDtypeStructs}."""
    key, h = jax.random.PRNGKey(0), H // 8
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L, JU.cross_attention_dim))
    return {
        "unet": jax.eval_shape(JUNet(JU).init, key, sample, t0, ctx),
        "controlnet": jax.eval_shape(
            JControlNet(JC).init, key, sample, t0, ctx,
            jnp.zeros((1, H, H, 6)), jnp.zeros((1, H, H, 4))),
        "vae": jax.eval_shape(JVAE(JV).init, key, jnp.zeros((1, H, H, 3))),
    }


# ---- what each run records from inside its sample call ----

_TAPE = {"controlnet": [], "vae": []}


def _tape(kind):
    def record(*args):
        _TAPE[kind].append(jax.tree.map(
            lambda a: np.array(a, np.float32), args))
    return record


class _RecordingControlNet(JControlNet):
    """JAX's DualFlowControlNet, its backbone's inputs and outputs sent to
    the host at every call (one a UniPC step, inside the fori_loop)."""

    def backbone(self, sample, timesteps, encoder_hidden_states, pyramid,
                 conditioning_scale=1.0):
        down, mid = super().backbone(sample, timesteps, encoder_hidden_states,
                                     pyramid, conditioning_scale)
        jax.debug.callback(_tape("controlnet"), sample, timesteps, down, mid)
        return down, mid


class _RecordingVAE(JVAE):
    """JAX's AutoencoderKL, the latents it decodes sent to the host."""

    def decode(self, z):
        jax.debug.callback(_tape("vae"), z)
        return super().decode(z)


def _result(calls, final, images):
    """{name: float32 array}: the first ControlNet call's 12 down
    residuals and mid residual, the latents after each step and the
    images; `timesteps` the ControlNet calls' timesteps."""
    first_down, first_mid = calls[0][2], calls[0][3]
    out = {f"down{i}": d for i, d in enumerate(first_down)}
    out["mid"] = first_mid
    # a step's ControlNet input is the last step's latents, CFG-doubled
    for i, call in enumerate(calls[1:]):
        out[f"latents_step{i + 1}"] = call[0][:FRAMES]
    out[f"latents_step{len(calls)}"] = final
    out["images"] = images
    out["timesteps"] = np.asarray([int(c[1]) for c in calls])
    return out


def _cast(params, dtype):
    return jax.tree.map(lambda a: a.astype(dtype), params)


def _jax_run(params, dtype):
    """JAX's jitted DualFlowPipeline.sample in `dtype`."""
    pipe = JPipeline(unet=JUNet(JU, dtype=dtype),
                     controlnet=_RecordingControlNet(JC, dtype=dtype),
                     vae=_RecordingVAE(JV, dtype=dtype),
                     schedule=JSchedule.create(jcfg.SchedulerConfig()),
                     sampler=jcfg.SamplerConfig(**SAMPLER))

    def sample(p, x):
        return pipe.sample(_cast(p, dtype), jax.random.PRNGKey(0), x["text"],
                           x["uncond"], x["cond"], x["flow"],
                           latents=x["latents"])

    x = {k: jnp.asarray(v).astype(dtype) if k in CAST else jnp.asarray(v)
         for k, v in X.items()}
    for tape in _TAPE.values():
        tape.clear()
    images = np.array(jax.jit(sample)(params, x), np.float32)
    jax.effects_barrier()
    (z,) = _TAPE["vae"][-1]
    out = _result(list(_TAPE["controlnet"]),
                  z * np.float32(JV.scaling_factor), images)
    jax.clear_caches()
    return out


def _port_pipeline(params):
    """The port's pipeline in fp32 on the CPU, each network made on the
    meta device, allocated and filled by the bridge; `params` is emptied
    network by network as the port takes it over."""
    made = {}
    for name, make, name_map in (
            ("vae", lambda: AutoencoderKL(TV), weights.vae_name_map(TV)),
            ("controlnet", lambda: DualFlowControlNet(TC),
             weights.controlnet_name_map(TC)),
            ("unet", lambda: UNet2DConditionModel(TU),
             weights.unet_name_map(TU))):
        with torch.device("meta"):
            module = make()
        module = module.to_empty(device="cpu")
        weights.load_flax_params(module, params.pop(name), name_map)
        made[name] = module.eval().requires_grad_(False)
        gc.collect()
    return DualFlowPipeline(
        unet=made["unet"], controlnet=made["controlnet"], vae=made["vae"],
        schedule=NoiseSchedule.create(tcfg.SchedulerConfig()),
        sampler=tcfg.SamplerConfig(**SAMPLER))


def _port_run(pipe, dtype):
    """The port's DualFlowPipeline.sample with its modules in `dtype`."""
    for m in (pipe.unet, pipe.controlnet, pipe.vae):
        m.to(dtype)
    calls, finals = [], []
    backbone, denoise = pipe.controlnet.backbone, pipe.denoise

    def recording_backbone(sample, t, *args):
        down, mid = backbone(sample, t, *args)
        calls.append((sample.float().numpy(), t,
                      [d.float().numpy() for d in down],
                      mid.float().numpy()))
        return down, mid

    def recording_denoise(*args):
        final = denoise(*args)
        finals.append(final.float().numpy())
        return final

    pipe.controlnet.backbone = recording_backbone
    pipe.denoise = recording_denoise
    try:
        x = {k: torch.from_numpy(v).to(dtype) if k in CAST
             else torch.from_numpy(v) for k, v in X.items()}
        images = pipe.sample(x["latents"], x["text"], x["uncond"], x["cond"],
                             x["flow"])
    finally:
        del pipe.controlnet.backbone, pipe.denoise
    return _result(calls, finals[0], images.float().numpy())


@pytest.fixture(scope="module")
def runs():
    """{'jax_fp32', 'jax_bf16', 'port_fp32', 'port_bf16': _result}."""
    # one copy of the parameters, JAX's, which both JAX runs share and
    # the port's bridge reads network by network (~5.2 GB in fp32)
    params = {name: jax.tree.map(jnp.asarray, _draw(shapes, seed))
              for seed, (name, shapes) in enumerate(_shapes().items())}
    out = {"jax_fp32": _jax_run(params, jnp.float32),
           "jax_bf16": _jax_run(params, jnp.bfloat16)}
    pipe = _port_pipeline(params)
    del params
    with torch.no_grad():
        out["port_fp32"] = _port_run(pipe, torch.float32)
        out["port_bf16"] = _port_run(pipe, torch.bfloat16)
    del pipe
    gc.collect()
    return out


STEP_LATENTS = [f"latents_step{i}" for i in range(1, STEPS + 1)]
OUTPUTS = ([f"down{i}" for i in range(N_DOWN)] + ["mid"] + STEP_LATENTS[-1:]
           + ["images"])


def test_each_package_calls_the_controlnet_once_a_step(runs):
    """Three ControlNet calls, at the same UniPC timesteps in every run."""
    want = runs["jax_fp32"]["timesteps"]
    assert len(want) == STEPS and len(set(want.tolist())) == STEPS
    for name, run in runs.items():
        np.testing.assert_array_equal(run["timesteps"], want, err_msg=name)


def test_shapes_are_sd15s_at_full_depth(runs):
    """12 down residuals at CFG batch 2 (the conv_in skip, 2 layers and a
    downsampler a level, 2 layers at the last), the mid residual, latents
    and images of one frame."""
    b, h = 2 * FRAMES, H // 8
    want = ([(b, h, h, 320)] * 3 + [(b, h // 2, h // 2, 320)]
            + [(b, h // 2, h // 2, 640)] * 2 + [(b, h // 4, h // 4, 640)]
            + [(b, h // 4, h // 4, 1280)] * 2
            + [(b, h // 8, h // 8, 1280)] * 3)
    for name, run in runs.items():
        assert [run[f"down{i}"].shape for i in range(N_DOWN)] == want, name
        assert run["mid"].shape == (b, 1, 1, 1280), name
        for key in STEP_LATENTS:
            assert run[key].shape == (FRAMES, h, h, 4), (name, key)
        assert run["images"].shape == (FRAMES, H, H, 3), name
        assert all(np.isfinite(v).all() for v in run.values()), name
    # neither flat nor saturated (the tiny pipeline test's check)
    assert 0.05 < np.abs(runs["jax_fp32"]["images"]).mean() < 0.95


@pytest.mark.parametrize("name", OUTPUTS + STEP_LATENTS[:-1])
def test_fp32_matches_jax(runs, name):
    np.testing.assert_allclose(runs["port_fp32"][name],
                               runs["jax_fp32"][name], atol=FP32_ATOL,
                               rtol=FP32_RTOL, err_msg=name)


def bf16_errors(runs, name):
    """(e_jax, e_port, d) of one output."""
    jf, jb, pb = (runs[k][name] for k in ("jax_fp32", "jax_bf16",
                                          "port_bf16"))
    return rel_l2(jb, jf), rel_l2(pb, jf), rel_l2(pb, jb)


@pytest.mark.parametrize("name", OUTPUTS + STEP_LATENTS[:-1])
def test_bf16_within_jax_rounding(runs, name):
    e_jax, e_port, d = bf16_errors(runs, name)
    assert np.isfinite(e_jax) and e_jax > 0, name
    assert within_bf16_rule(e_jax, e_port, d), (name, e_jax, e_port, d)


# ---- the name maps at full depth, shapes only ----

PORT_NETWORKS = {
    "unet": (lambda: UNet2DConditionModel(TU),
             lambda: weights.unet_name_map(TU),
             lambda: hf_import.unet_name_map(JU)),
    "controlnet": (lambda: DualFlowControlNet(TC),
                   lambda: weights.controlnet_name_map(TC),
                   lambda: hf_import.controlnet_name_map(JC)),
    "vae": (lambda: AutoencoderKL(TV), lambda: weights.vae_name_map(TV),
            lambda: hf_import.vae_name_map(JV)),
}

# flax layout -> torch layout of one map entry's shape
_TO_TORCH = {"conv_kernel": (3, 2, 0, 1), "linear_kernel": (1, 0)}


def _meta_module(name):
    with torch.device("meta"):
        return PORT_NETWORKS[name][0]()


@pytest.mark.parametrize("name", sorted(PORT_NETWORKS))
def test_name_map_covers_both_trees_once(name):
    """Every leaf of JAX's tree is named by exactly one entry, whose torch
    name is a port parameter of the leaf's shape transposed; every port
    parameter is named once."""
    tree = _shapes()[name]["params"]
    leaves = {tuple(str(getattr(k, "key", k)) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    own = {k: tuple(v.shape)
           for k, v in _meta_module(name).state_dict().items()}
    entries = PORT_NETWORKS[name][1]()
    tnames = [t for t, _, _ in entries]
    fpaths = [f for _, f, _ in entries]
    assert len(set(tnames)) == len(tnames), "a torch name mapped twice"
    assert len(set(fpaths)) == len(fpaths), "a flax leaf mapped twice"
    assert set(tnames) == set(own), (sorted(set(own) - set(tnames))[:5],
                                     sorted(set(tnames) - set(own))[:5])
    assert set(fpaths) == set(leaves), (
        sorted(set(leaves) - set(fpaths))[:5],
        sorted(set(fpaths) - set(leaves))[:5])
    for tname, fpath, kind in entries:
        shape = leaves[fpath]
        perm = _TO_TORCH.get(kind, tuple(range(len(shape))))
        assert tuple(shape[i] for i in perm) == own[tname], (tname, kind)


@pytest.mark.parametrize("name", sorted(PORT_NETWORKS))
def test_checkpoint_loader_reads_every_parameter(name):
    """The checkpoint-directory loader reads, for a full-depth network,
    exactly the port's parameter names, once each, and the JAX loader's
    names (`hf_import`'s maps) in the same order."""
    module = _meta_module(name)
    names = checkpoints.module_names(name, module)
    assert len(set(names)) == len(names)
    assert set(names) == set(module.state_dict())
    assert names == [t for t, _, _ in PORT_NETWORKS[name][2]()]
