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
the noise fp32).  What is compared is taken from inside those calls by
`decode_tape` (JAX's through `jax.debug.callback` in subclasses of its
ControlNet and UniPC, the port's by wrapping `backbone` and UniPC's
`step`): the first ControlNet call's 12 down residuals and mid residual,
the latents after each step and the images.

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

import decode_tape as tape
from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models import weights as checkpoints
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from test_torch_port_fullwidth import _draw
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(2)

H, FRAMES, L, STEPS = 64, 1, 77, 3
# the tiny pipeline test's limits (test_torch_port_pipeline.py)
FP32_ATOL, FP32_RTOL = 1e-3, 1e-3
SAMPLER = dict(num_inference_steps=STEPS, guidance_scale=3.5,
               controlnet_conditioning_scale=1.35, freeu=True)
JU, TU = jcfg.UNetConfig(), tcfg.UNetConfig()
JC, TC = jcfg.ControlNetConfig(), tcfg.ControlNetConfig()
JV, TV = jcfg.VAEConfig(), tcfg.VAEConfig()
N_DOWN = tape.n_down(JU)


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


@pytest.fixture(scope="module")
def runs():
    """{'jax_fp32', 'jax_bf16', 'port_fp32', 'port_bf16':
    decode_tape.result}."""
    # one copy of the parameters, JAX's, which both JAX runs share and
    # the port's bridge reads network by network (~5.2 GB in fp32)
    params = {name: jax.tree.map(jnp.asarray, _draw(shapes, seed))
              for seed, (name, shapes) in enumerate(_shapes().items())}
    out = {f"jax_{n}": tape.jax_sample((JU, JC, JV), SAMPLER, params, X,
                                       dtype)
           for n, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16))}
    pipe = tape.port_pipeline((TU, TC, TV), SAMPLER, params)
    del params
    out["port_fp32"] = tape.port_sample(pipe, X, torch.float32)
    out["port_bf16"] = tape.port_sample(pipe, X, torch.bfloat16)
    del pipe
    gc.collect()
    tape.summary("fulldepth", out, STEPS)
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
        np.testing.assert_array_equal(run["controlnet_timesteps"], want,
                                      err_msg=name)


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


@pytest.mark.parametrize("name", OUTPUTS + STEP_LATENTS[:-1])
def test_bf16_within_jax_rounding(runs, name):
    ok, *errors = tape.within_jax_rounding(runs, name)
    assert ok, (name, errors)


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
