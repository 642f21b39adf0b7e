"""The port's whole decode against JAX's over `bench.py`'s 30 UniPC steps,
at the tiny configs, on the CPU.

The configs and weights of `test_torch_port_pipeline.py` (UNet and
ControlNet `tiny()`: 3 levels of 32/64/64, one layer a level, 6 down
residuals; the VAE at 8 base channels, widths (1, 1, 2, 2), one layer a
block), 64 px frames, 2 frames (CFG batch 4).  The sampler at bench's
point: 30 steps, guidance 3.5, ControlNet scale 1.35, FreeU; and the
interval-cached decode that `cli/approx_drift.py` times, in guess mode
(the ControlNet on the text half only), its residuals kept for the first
60% of the steps, the ControlNet and the UNet's down path recomputed
every second step.  Weights, prompts, conditioning, flows and noise are
drawn by numpy from a seed; the port takes the weights through
`weights.load_pipeline_params`.

Each package runs its own `sample` (JAX's jitted) in fp32 and in bf16 as
bench.py runs it; `decode_tape` reads from inside each call the first
ControlNet call's residuals, the latents after every step and the
images.  fp32: the port against JAX element by element at the pipeline
test's limits (atol 1e-3, rtol 1e-3: UniPC's x0 prediction divides by
sqrt(abar_t), 0.07 at t = 999).  bf16: each output by
`chip_smoke.within_bf16_rule` against JAX's fp32 and bf16 runs, and the
port's error on the latents, in units of JAX's own (e_port / e_jax), no
more than 1.25 times larger over steps 21-30 than over steps 1-10: the
port's rounding does not compound over the steps faster than JAX's does.
What each sampler read is printed as one JSON line (`pytest -s`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE

import decode_tape as tape
from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.weights import load_pipeline_params
from test_torch_port_pipeline import VAE_KW, _randomize
from torch_threads import few_torch_threads

FRAMES, H, L, STEPS = 2, 64, 5, 30
# the tiny pipeline test's limits (test_torch_port_pipeline.py)
FP32_ATOL, FP32_RTOL = 1e-3, 1e-3
# the late steps' worst e_port / e_jax against the early steps' worst
GROWTH = 1.25
BENCH = dict(num_inference_steps=STEPS, guidance_scale=3.5,
             controlnet_conditioning_scale=1.35, freeu=True)
SAMPLERS = {
    "exact": BENCH,
    "guess_intervals": dict(BENCH, guess_mode=True, control_guidance_end=0.6,
                            controlnet_interval=2, unet_encoder_interval=2),
}
JCFGS = (jcfg.UNetConfig.tiny(), jcfg.ControlNetConfig.tiny(),
         jcfg.VAEConfig(**VAE_KW))
TCFGS = (tcfg.UNetConfig.tiny(), tcfg.ControlNetConfig.tiny(),
         tcfg.VAEConfig(**VAE_KW))
N_DOWN = tape.n_down(JCFGS[0])
STEP_LATENTS = [f"latents_step{k}" for k in range(1, STEPS + 1)]
OUTPUTS = ([f"down{i}" for i in range(N_DOWN)] + ["mid"] + STEP_LATENTS
           + ["images"])


_one_torch_thread = few_torch_threads(1)


@functools.lru_cache(maxsize=None)
def _params():
    """{network: seeded float32 numpy tree}, as the pipeline test draws
    them."""
    unet, controlnet, vae = (JUNet(JCFGS[0]), JControlNet(JCFGS[1]),
                             JVAE(JCFGS[2]))
    h, key = H // 8, jax.random.PRNGKey(0)
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L, JCFGS[0].cross_attention_dim))
    shapes = {
        "unet": jax.eval_shape(unet.init, key, sample, t0, ctx),
        "controlnet": jax.eval_shape(controlnet.init, key, sample, t0, ctx,
                                     jnp.zeros((1, H, H, 6)),
                                     jnp.zeros((1, H, H, 4))),
        "vae": jax.eval_shape(vae.init, key, jnp.zeros((1, H, H, 3))),
    }
    return {k: _randomize(v, i) for i, (k, v) in enumerate(shapes.items())}


def _inputs():
    rng = np.random.default_rng(21)
    f32, h, D = np.float32, H // 8, JCFGS[0].cross_attention_dim
    return dict(
        latents=rng.standard_normal((FRAMES, h, h, 4)).astype(f32),
        text=(0.5 * rng.standard_normal((FRAMES, L, D))).astype(f32),
        uncond=(0.1 * rng.standard_normal((FRAMES, L, D))).astype(f32),
        cond=rng.uniform(-1, 1, (FRAMES, H, H, 6)).astype(f32),
        flow=(3 * rng.standard_normal((FRAMES, H, H, 4))).astype(f32))


@pytest.fixture(scope="module", params=sorted(SAMPLERS))
def runs(request):
    """(sampler, {'jax_fp32', 'jax_bf16', 'port_fp32', 'port_bf16':
    decode_tape.result})."""
    sampler, params, x = SAMPLERS[request.param], _params(), _inputs()
    out = {f"jax_{n}": tape.jax_sample(JCFGS, sampler, params, x, dtype)
           for n, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16))}
    pipe = DualFlowPipeline.create(*TCFGS, tcfg.SamplerConfig(**sampler),
                                   dtype=torch.float32, device="cpu")
    load_pipeline_params(pipe, params)
    out["port_fp32"] = tape.port_sample(pipe, x, torch.float32)
    out["port_bf16"] = tape.port_sample(pipe, x, torch.bfloat16)
    tape.summary(request.param, out, STEPS)
    return request.param, out


def test_every_run_steps_through_the_same_timesteps(runs):
    """30 distinct descending timesteps, the same in every run; the
    ControlNet at every step, or at every second one under the interval."""
    name, out = runs
    want = out["jax_fp32"]["timesteps"]
    assert len(want) == STEPS and (np.diff(want) < 0).all()
    every = SAMPLERS[name].get("controlnet_interval", 1)
    for run, got in out.items():
        np.testing.assert_array_equal(got["timesteps"], want, err_msg=run)
        np.testing.assert_array_equal(got["controlnet_timesteps"],
                                      want[::every], err_msg=run)


def test_shapes_and_values(runs):
    """The residuals at the ControlNet's batch (CFG-doubled, or the text
    half in guess mode), the latents and images of 2 frames, finite; the
    images neither flat nor saturated."""
    name, out = runs
    b = FRAMES if SAMPLERS[name].get("guess_mode") else 2 * FRAMES
    for run, got in out.items():
        assert got["down0"].shape == (b, H // 8, H // 8, 32), run
        assert got["mid"].shape[0] == b, run
        for key in STEP_LATENTS:
            assert got[key].shape == (FRAMES, H // 8, H // 8, 4), (run, key)
        assert got["images"].shape == (FRAMES, H, H, 3), run
        assert all(np.isfinite(got[k]).all() for k in OUTPUTS), run
    assert 0.05 < np.abs(out["jax_fp32"]["images"]).mean() < 0.95


@pytest.mark.parametrize("output", OUTPUTS)
def test_fp32_matches_jax(runs, output):
    _, out = runs
    np.testing.assert_allclose(out["port_fp32"][output],
                               out["jax_fp32"][output], atol=FP32_ATOL,
                               rtol=FP32_RTOL, err_msg=output)


@pytest.mark.parametrize("output", OUTPUTS)
def test_bf16_within_jax_rounding(runs, output):
    _, out = runs
    ok, *errors = tape.within_jax_rounding(out, output)
    assert ok, (output, errors)


def test_bf16_error_does_not_grow_over_the_steps(runs):
    _, out = runs
    ratios = tape.step_ratios(out, STEPS)
    early, late = ratios[:10].max(), ratios[20:].max()
    assert late <= GROWTH * early, (early, late, ratios.round(3).tolist())
