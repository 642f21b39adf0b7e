"""The port's whole decode against JAX's at SD-1.5's real depth and width
over `bench.py`'s 30 UniPC steps, and the distilled K = 4 decode, on the
CPU.  Marked slow: the lane leaves it out.

Configs: `UNetConfig()`, `ControlNetConfig()` and `VAEConfig()` uncut, as
`test_torch_port_fulldepth.py` takes them (its parameter shapes and
seeded values, carried into the port by `weights.load_flax_params`), at
64 px, 2 frames.  The exact decode at bench's point: 30 UniPC steps, CFG
3.5 (batch 4), ControlNet scale 1.35, FreeU.  The distilled decode:
`DistilledPipeline` with K = 4 consistency steps over the same networks
(no CFG, batch 2; ControlNet scale and FreeU at `DistillConfig`'s
values), against JAX's `sampling/distilled.py` `sample`, its three
re-noises JAX's own draws (`decode_tape.jax_noises`) handed to the port.

Each package runs its own `sample` in fp32 and in bf16 as bench.py runs
it; `decode_tape` reads from inside each call the first ControlNet call's
12 down residuals and mid residual, the latents after every step (x0
after every consistency step) and the images.  The limits are
`test_torch_port_longrun.py`'s: fp32 element by element at atol 1e-3,
rtol 1e-3; bf16 by `chip_smoke.within_bf16_rule` against JAX's fp32 and
bf16 runs; the exact decode's e_port / e_jax on the latents over steps
21-30 at most 1.25 times its worst over steps 1-10.  One copy of the
parameters (JAX's, ~5.2 GB in fp32) serves the four JAX runs and the
bridge, which empties it network by network.  What each decode read, the
seconds of each run and the process's peak resident memory are printed
as one JSON line a decode (`pytest -s`).
"""

import gc
import resource
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import decode_tape as tape
from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
from test_torch_port_fulldepth import JC, JU, JV, TC, TU, TV, _shapes
from test_torch_port_fullwidth import _draw
from test_torch_port_longrun import FP32_ATOL, FP32_RTOL, GROWTH

pytestmark = pytest.mark.slow

H, FRAMES, L, STEPS, K = 64, 2, 77, 30, 4
SAMPLER = dict(num_inference_steps=STEPS, guidance_scale=3.5,
               controlnet_conditioning_scale=1.35, freeu=True)
DISTILL = dict(num_student_steps=K)
N_DOWN = tape.n_down(JU)
RESIDUALS = [f"down{i}" for i in range(N_DOWN)] + ["mid"]
OUTPUTS = {
    decode: RESIDUALS + [f"latents_step{k}" for k in range(1, n + 1)]
    + ["images"] for decode, n in (("exact", STEPS), ("distilled", K))}
CASES = [(decode, name) for decode, names in OUTPUTS.items()
         for name in names]


def _inputs():
    rng = np.random.default_rng(30)
    f32, h, D = np.float32, H // 8, JU.cross_attention_dim
    return dict(
        latents=rng.standard_normal((FRAMES, h, h, 4)).astype(f32),
        text=(0.1 * rng.standard_normal((FRAMES, L, D))).astype(f32),
        uncond=(0.1 * rng.standard_normal((FRAMES, L, D))).astype(f32),
        cond=rng.uniform(-1, 1, (FRAMES, H, H, 6)).astype(f32),
        flow=(2 * rng.standard_normal((FRAMES, H, H, 4))).astype(f32))


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


@pytest.fixture(scope="module")
def runs():
    """{'exact' | 'distilled': {'jax_fp32', 'jax_bf16', 'port_fp32',
    'port_bf16': decode_tape.result}}."""
    x, rng = _inputs(), jax.random.PRNGKey(K)
    noises = tape.jax_noises(rng, K, x["latents"].shape)
    seconds, out = {}, {"exact": {}, "distilled": {}}

    def timed(decode, run, fn):
        t = time.perf_counter()
        out[decode][run] = fn()
        seconds[f"{decode}_{run}"] = time.perf_counter() - t

    params = {name: jax.tree.map(jnp.asarray, _draw(shapes, seed))
              for seed, (name, shapes) in enumerate(_shapes().items())}
    jcfgs = (JU, JC, JV)
    for n, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        timed("exact", f"jax_{n}", lambda: tape.jax_sample(
            jcfgs, SAMPLER, params, x, dtype))
        timed("distilled", f"jax_{n}", lambda: tape.jax_distilled(
            jcfgs, DISTILL, params, x, dtype, rng))
    pipe = tape.port_pipeline((TU, TC, TV), SAMPLER, params)
    del params
    distilled = DistilledPipeline.from_pipeline(
        pipe, tcfg.DistillConfig(**DISTILL))
    # fp32 first: the bf16 runs cast the shared modules in place
    for n, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        timed("exact", f"port_{n}", lambda: tape.port_sample(pipe, x, dtype))
        timed("distilled", f"port_{n}", lambda: tape.port_distilled(
            distilled, x, dtype, noises))
    del pipe, distilled
    gc.collect()
    for decode, n in (("exact", STEPS), ("distilled", K)):
        tape.summary(decode, out[decode], n, seconds=seconds,
                     peak_rss_gb=_peak_rss_gb())
    return out


def test_every_run_steps_through_the_same_timesteps(runs):
    """30 UniPC timesteps and K = 4 consistency timesteps, distinct and
    descending, the same in every run, the ControlNet called once a step."""
    for decode, n in (("exact", STEPS), ("distilled", K)):
        want = runs[decode]["jax_fp32"]["timesteps"]
        assert len(want) == n and (np.diff(want) < 0).all(), decode
        for run, got in runs[decode].items():
            np.testing.assert_array_equal(got["timesteps"], want,
                                          err_msg=(decode, run))
            np.testing.assert_array_equal(got["controlnet_timesteps"], want,
                                          err_msg=(decode, run))


def test_shapes_and_values(runs):
    """SD-1.5's 12 down residuals at the ControlNet's batch (CFG-doubled
    in the exact decode), latents and images of 2 frames, finite; the
    images neither flat nor saturated."""
    h = H // 8
    for decode, b in (("exact", 2 * FRAMES), ("distilled", FRAMES)):
        want = ([(b, h, h, 320)] * 3 + [(b, h // 2, h // 2, 320)]
                + [(b, h // 2, h // 2, 640)] * 2
                + [(b, h // 4, h // 4, 640)]
                + [(b, h // 4, h // 4, 1280)] * 2
                + [(b, h // 8, h // 8, 1280)] * 3)
        for run, got in runs[decode].items():
            assert [got[f"down{i}"].shape for i in range(N_DOWN)] == want
            assert got["mid"].shape == (b, 1, 1, 1280), (decode, run)
            assert got["images"].shape == (FRAMES, H, H, 3), (decode, run)
            for name in OUTPUTS[decode]:
                assert np.isfinite(got[name]).all(), (decode, run, name)
                if name.startswith("latents"):
                    assert got[name].shape == (FRAMES, h, h, 4), name
        images = runs[decode]["jax_fp32"]["images"]
        assert 0.05 < np.abs(images).mean() < 0.95, decode


@pytest.mark.parametrize("decode,name", CASES)
def test_fp32_matches_jax(runs, decode, name):
    np.testing.assert_allclose(runs[decode]["port_fp32"][name],
                               runs[decode]["jax_fp32"][name],
                               atol=FP32_ATOL, rtol=FP32_RTOL,
                               err_msg=(decode, name))


@pytest.mark.parametrize("decode,name", CASES)
def test_bf16_within_jax_rounding(runs, decode, name):
    ok, *errors = tape.within_jax_rounding(runs[decode], name)
    assert ok, (decode, name, errors)


def test_bf16_error_does_not_grow_over_the_steps(runs):
    ratios = tape.step_ratios(runs["exact"], STEPS)
    early, late = ratios[:10].max(), ratios[20:].max()
    assert late <= GROWTH * early, (early, late, ratios.round(3).tolist())
