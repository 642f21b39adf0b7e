"""The port's K-step distilled decoder (`DistilledPipeline`) and its helpers
against the JAX package, on the CPU.

The helpers are held exactly (c_out to 1 ulp, for the reason given at
its check).  The whole decode runs the tiny models on the
same seeded weights, conditioning and initial latents on both sides; the
K - 1 re-noises are JAX's own draws, made by repeating the key splits of
`DistilledPipeline.sample` (`distilled.py:96`, `:83-85`), and handed to
the port.
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
from diffcodec_tpu.sampling.distilled import DistilledPipeline as JDistilled
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule
from diffcodec_tpu.train import distill as jdistill

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
from diffcodec_tpu_torch.train import distill as tdistill
from diffcodec_tpu_torch.weights import load_pipeline_params

VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
B, H, L = 2, 64, 5


def _schedules():
    return (JSchedule.create(jcfg.SchedulerConfig()),
            NoiseSchedule.create(tcfg.SchedulerConfig()))


def test_boundary_scalings_match_jax():
    ts = np.arange(0, 1000, dtype=np.int32)
    want = jdistill.boundary_scalings(jnp.asarray(ts), 0.5, 10.0)
    got = tdistill.boundary_scalings(torch.from_numpy(ts), 0.5, 10.0)
    assert all(g.dtype == torch.float32 for g in got)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # c_out = s / sqrt(s^2 + 0.25): the port's square root is IEEE's,
    # correctly rounded; XLA's CPU square root is not (and under jit XLA
    # turns the division into a product with an rsqrt), so 5 of these
    # 1000 values differ by 1 ulp (2^-23 relative), none by more
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2.0 ** -23, atol=0)
    c_skip, c_out = tdistill.boundary_scalings(0)
    assert float(c_skip) == 1.0 and float(c_out) == 0.0


@pytest.mark.parametrize("n", [50, 30, 7])
def test_ddim_grid_matches_jax(n):
    jsched, tsched = _schedules()
    np.testing.assert_array_equal(tdistill.ddim_grid(tsched, n),
                                  np.asarray(jdistill.ddim_grid(jsched, n)))


@pytest.mark.parametrize("n,K", [(n, K) for n in (50, 30)
                                 for K in range(1, n + 1)])
def test_step_schedule_matches_jax(n, K):
    """Every K of the default 50 teacher steps and of 30: numpy's float64
    linspace picks other timesteps than jnp's float32 one at K = 15, 29,
    31, 35, 43 (n = 50) and 23, 27 (n = 30), exactly."""
    jsched, tsched = _schedules()
    want = JDistilled(unet=None, controlnet=None, vae=None, schedule=jsched,
                      config=jcfg.DistillConfig(num_teacher_steps=n,
                                                num_student_steps=K))
    got = DistilledPipeline(unet=None, controlnet=None, vae=None,
                            schedule=tsched,
                            config=tcfg.DistillConfig(num_teacher_steps=n,
                                                      num_student_steps=K))
    np.testing.assert_array_equal(got.step_schedule(),
                                  np.asarray(want.step_schedule()))


def test_add_noise_and_velocity_match_jax():
    jsched, tsched = _schedules()
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    for t in (999, 500, 19, 0):
        jt = jnp.full((2,), t, jnp.int32)
        for name in ("add_noise", "velocity"):
            want = getattr(jsched, name)(jnp.asarray(x0), jnp.asarray(eps),
                                         jt)
            got = getattr(tsched, name)(torch.from_numpy(x0),
                                        torch.from_numpy(eps), t)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
    params = {k: _randomize(v, 10 + i)
              for i, (k, v) in enumerate(shapes.items())}
    rng = np.random.default_rng(43)
    inputs = dict(
        latents=rng.standard_normal((B, h, h, 4)).astype(np.float32),
        text=(rng.standard_normal((B, L, 32)) * 0.5).astype(np.float32),
        cond=rng.uniform(-1, 1, (B, H, H, 6)).astype(np.float32),
        flow=(rng.standard_normal((B, H, H, 4)) * 3).astype(np.float32))
    pipe = DistilledPipeline.create(
        tcfg.UNetConfig.tiny(), tcfg.ControlNetConfig.tiny(),
        tcfg.VAEConfig(**VAE_KW), dtype=torch.float32, device="cpu",
        fused_conv=True)
    load_pipeline_params(pipe, params)
    return (unet, controlnet, vae), params, inputs, pipe


def _jax_noises(rng, K, shape):
    """The re-noises `DistilledPipeline.sample` draws from `rng`."""
    _, rng_steps = jax.random.split(rng)
    out = []
    for _ in range(1, K):
        rng_steps, rk = jax.random.split(rng_steps)
        out.append(np.asarray(jax.random.normal(rk, shape, jnp.float32)))
    return out


@pytest.mark.parametrize("K", [2, 4])
def test_distilled_sample_matches_jax(setup, K):
    (unet, controlnet, vae), params, x, pipe = setup
    jpipe = JDistilled(unet=unet, controlnet=controlnet, vae=vae,
                       schedule=JSchedule.create(jcfg.SchedulerConfig()),
                       config=jcfg.DistillConfig(num_student_steps=K))
    rng = jax.random.PRNGKey(K)
    sample = jax.jit(functools.partial(jpipe.sample,
                                       latents=jnp.asarray(x["latents"])))
    want = np.asarray(sample(params, rng, jnp.asarray(x["text"]),
                             jnp.asarray(x["cond"]), jnp.asarray(x["flow"])))

    pipe = DistilledPipeline.from_pipeline(
        pipe, tcfg.DistillConfig(num_student_steps=K))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    noises = [torch.from_numpy(n.copy())
              for n in _jax_noises(rng, K, x["latents"].shape)]
    got = pipe.sample(t["latents"], t["text"], t["cond"], t["flow"],
                      noises=noises)
    assert got.shape == want.shape == (B, H, H, 3)
    assert torch.isfinite(got).all()
    assert 0.05 < np.abs(want).mean() < 0.95  # neither flat nor saturated
    # fp32 on both sides; each step's x0 prediction divides by
    # sqrt(abar_t) (0.068 at t = 999), which magnifies the ~1e-6
    # differences of summation order in the networks, as in the 30-step
    # pipeline (tests/test_torch_port_pipeline.py)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)


def test_distilled_denoise_draws_from_its_generator(setup):
    _, _, x, pipe = setup
    pipe = DistilledPipeline.from_pipeline(
        pipe, tcfg.DistillConfig(num_student_steps=2))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    args = (t["latents"], t["text"], t["cond"], t["flow"])
    default = pipe.denoise(*args)
    seeded = pipe.denoise(*args, generator=torch.Generator().manual_seed(0))
    noise = torch.randn(t["latents"].shape,
                        generator=torch.Generator().manual_seed(0))
    given = pipe.denoise(*args, noises=[noise])
    torch.testing.assert_close(default, seeded, atol=0, rtol=0)
    torch.testing.assert_close(default, given, atol=0, rtol=0)
    assert default.dtype == torch.float32 and default.shape == (B, 8, 8, 4)
    with pytest.raises(ValueError, match="2 steps take 1 noises"):
        pipe.denoise(*args, noises=[noise, noise])
