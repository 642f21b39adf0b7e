"""The port's whole decode (`DualFlowPipeline.sample`) against the JAX
pipeline at a tiny config, on the CPU.

Both sides get the same seeded weights (through the port's bridge), the
same prompt embeddings, conditioning, flow and initial `latents`, and run a
few UniPC steps with CFG, the ControlNet and FreeU, then the VAE decode.
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
from diffcodec_tpu.sampling.pipeline import DualFlowPipeline as JPipeline
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.weights import load_pipeline_params
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
B, H, L = 2, 64, 5


def _randomize(params, seed):
    """Seeded float32 values for a tree of shapes: norm scales near 1,
    small biases, kernels ~ N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            v = rng.uniform(0.7, 1.3, p.shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, p.shape)
        else:
            fan_in = int(np.prod(p.shape[:-1])) if len(p.shape) > 1 else 1
            v = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def setup():
    unet = JUNet(jcfg.UNetConfig.tiny())
    controlnet = JControlNet(jcfg.ControlNetConfig.tiny())
    vae = JVAE(jcfg.VAEConfig(**VAE_KW))
    h = H // 8
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L, 32))
    key = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(unet.init, key, sample, t0, ctx),
        "controlnet": jax.eval_shape(controlnet.init, key, sample, t0, ctx,
                                     jnp.zeros((1, H, H, 6)),
                                     jnp.zeros((1, H, H, 4))),
        "vae": jax.eval_shape(vae.init, key, jnp.zeros((1, H, H, 3))),
    }
    params = {k: _randomize(v, i) for i, (k, v) in enumerate(shapes.items())}
    rng = np.random.default_rng(42)
    inputs = dict(
        latents=rng.standard_normal((B, h, h, 4)).astype(np.float32),
        text=(rng.standard_normal((B, L, 32)) * 0.5).astype(np.float32),
        uncond=(rng.standard_normal((B, L, 32)) * 0.1).astype(np.float32),
        cond=rng.uniform(-1, 1, (B, H, H, 6)).astype(np.float32),
        flow=(rng.standard_normal((B, H, H, 4)) * 3).astype(np.float32))
    return (unet, controlnet, vae), params, inputs


SAMPLERS = {
    # the exact point of the decode (CFG, ControlNet scale, FreeU)
    "exact": dict(num_inference_steps=3, guidance_scale=3.5,
                  controlnet_conditioning_scale=1.35),
    # guess mode, a keep window and both interval caches
    "guess_intervals": dict(num_inference_steps=3, guidance_scale=2.0,
                            guess_mode=True, control_guidance_end=0.6,
                            controlnet_interval=2, unet_encoder_interval=2),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sample_matches_jax_pipeline(setup, name):
    (unet, controlnet, vae), params, x = setup
    jpipe = JPipeline(unet=unet, controlnet=controlnet, vae=vae,
                      schedule=JSchedule.create(jcfg.SchedulerConfig()),
                      sampler=jcfg.SamplerConfig(**SAMPLERS[name]))
    sample = jax.jit(functools.partial(jpipe.sample,
                                       latents=jnp.asarray(x["latents"])))
    want = np.asarray(sample(params, jax.random.PRNGKey(0),
                             jnp.asarray(x["text"]), jnp.asarray(x["uncond"]),
                             jnp.asarray(x["cond"]), jnp.asarray(x["flow"])))

    pipe = DualFlowPipeline.create(
        tcfg.UNetConfig.tiny(), tcfg.ControlNetConfig.tiny(),
        tcfg.VAEConfig(**VAE_KW), tcfg.SamplerConfig(**SAMPLERS[name]),
        dtype=torch.float32, device="cpu")
    load_pipeline_params(pipe, params)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got = pipe.sample(t["latents"], t["text"], t["uncond"], t["cond"],
                      t["flow"])
    assert got.shape == want.shape == (B, H, H, 3)
    assert torch.isfinite(got).all()
    assert 0.05 < np.abs(want).mean() < 0.95  # neither flat nor saturated
    # fp32 on both sides; UniPC's x0 prediction divides by sqrt(abar_t)
    # (0.07 at t = 999), which magnifies the ~1e-6 differences of summation
    # order in the networks
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)
