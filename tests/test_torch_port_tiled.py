"""The port's overlap-tiled decode (`sampling/tiled.py`) and its host
tiling (`ops/tiling.py`) against the JAX package's, on the CPU.

Tiling and merging are held bit for bit: the tile grid, the reflect-padded
crops (edge tiles whose pad exceeds their width included, as at 1080p), the
feathered merge, and `sample_tiled` around a stand-in pipeline written for
both frameworks (sums, and products by powers of 2: no rounding can
differ), in fp32 and bf16, with float and uint8 conditioning.  The tiny
pipelines (exact with CFG, and the distilled student) run the same seeded
weights and JAX's own per-chunk draws on both sides, fp32: held to
atol = rtol = 1e-3, the whole decode's tolerance in
`tests/test_torch_port_pipeline.py`.
"""

import types

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
from diffcodec_tpu.ops import tiling as jtiling
from diffcodec_tpu.sampling import tiled as jtiled
from diffcodec_tpu.sampling.distilled import DistilledPipeline as JDistilled
from diffcodec_tpu.sampling.pipeline import DualFlowPipeline as JPipeline
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.ops import tiling
from diffcodec_tpu_torch.sampling import tiled
from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.weights import load_pipeline_params
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)


@pytest.mark.parametrize("h,w,tile,overlap", [
    (1080, 1920, 512, 64), (1080, 1920, 512, 32), (40, 58, 32, 8),
    (32, 32, 32, 8), (20, 70, 32, 0)])
def test_tile_grid_matches_jax(h, w, tile, overlap):
    got = tiled.tile_grid(h, w, (tile, tile), overlap)
    assert got == jtiled.tile_grid(h, w, (tile, tile), overlap)
    if (h, w, tile, overlap) == (1080, 1920, 512, 64):
        # 3 x 5 tiles; the edge tiles are 184 rows and 128 columns wide
        assert len(got) == 15
        assert {y2 - y1 for y1, y2, _, _ in got} == {512, 184}
        assert {x2 - x1 for _, _, x1, x2 in got} == {512, 128}


@pytest.mark.parametrize("h,w,tile,overlap", [
    (40, 58, 32, 8),       # last tiles 16 rows and 10 columns: pads of 16
                           # and 22 exceed them, so numpy reflects twice
    (1080, 1920, 512, 64), (23, 9, 16, 4)])
def test_crop_batch_matches_jax(h, w, tile, overlap):
    rng = np.random.default_rng(h + w)
    arr = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
    coords = tiled.tile_grid(h, w, (tile, tile), overlap)
    want = jtiled._crop_batch(arr, coords, tile, tile)
    got = tiled._crop_batch(arr, coords, tile, tile)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # a tensor is cropped where it lies, the same way
    np.testing.assert_array_equal(
        tiled._crop_batch(torch.from_numpy(arr), coords, tile, tile).numpy(),
        want)


def test_tiling_helpers_match_jax():
    rng = np.random.default_rng(0)
    img = rng.random((40, 58, 3)).astype(np.float32)
    for args in [((32, 32), 8), ((16, 24), 0), ((40, 58), 4)]:
        got, gc, gs = tiling.crop_into_tiles(img, *args)
        want, wc, ws = jtiling.crop_into_tiles(img, *args)
        assert (gc, gs) == (wc, ws)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g, w_)
    for h, w, f, edges in [(32, 32, 8, (True,) * 4), (16, 10, 8,
                                                      (False, True, True,
                                                       False)),
                           (5, 7, 3, (True,) * 4)]:
        np.testing.assert_array_equal(tiling._cosine_mask(h, w, f, edges),
                                      jtiling._cosine_mask(h, w, f, edges))
    tile = rng.random((10, 14, 3)).astype(np.float32)
    np.testing.assert_array_equal(tiling._resize_bilinear_np(tile, 17, 9),
                                  jtiling._resize_bilinear_np(tile, 17, 9))
    tiles, coords, shape = tiling.crop_into_tiles(img, (32, 32), 8)
    tiles = [t * 2 - 1 for t in tiles]
    tiles[1] = tiling._resize_bilinear_np(tiles[1], 30, 28)  # resized back
    for feather, u8 in [(0, False), (8, False), (8, True), (64, False)]:
        np.testing.assert_array_equal(
            tiling.merge_tiles(tiles, coords, shape, feather, u8),
            jtiling.merge_tiles(tiles, coords, shape, feather, u8))
    lat = [rng.random((1, 4, 4, 4)).astype(np.float32) for _ in coords]
    px = [(x1, x2, y1, y2) for y1, y2, x1, x2 in coords]
    np.testing.assert_array_equal(
        tiling.merge_latent_tiles(lat, px, (5, 7), shape),
        jtiling.merge_latent_tiles(lat, px, (5, 7), shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unit_from_uint8_is_jax_quotient(dtype):
    """Every uint8 value divided by 255 as JAX divides it (correctly
    rounded in fp32, then cast); a product with the reciprocal differs at
    126 of the 256 values."""
    u8 = np.arange(256, dtype=np.uint8)
    want = np.asarray((jnp.asarray(u8).astype(jnp.float32) / 255.0)
                      .astype(getattr(jnp, dtype))).astype(np.float32)
    got = tiled.unit_from_uint8(torch.from_numpy(u8), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _standin_jax(c, f, t, u=None):
    x = c.astype(jnp.float32)[..., :3] * 2.0 - 1.0
    x = x + f.astype(jnp.float32)[..., :1] * 0.25
    x = x + t.astype(jnp.float32)[:, 0, 0][:, None, None, None] * 0.5
    if u is not None:
        x = x - u.astype(jnp.float32)[:, 0, 0][:, None, None, None] * 0.25
    return x


def _standin_torch(c, f, t, u=None):
    x = c.float()[..., :3] * 2.0 - 1.0
    x = x + f.float()[..., :1] * 0.25
    x = x + t.float()[:, 0, 0][:, None, None, None] * 0.5
    if u is not None:
        x = x - u.float()[:, 0, 0][:, None, None, None] * 0.25
    return x


class _JaxStandin:
    """The JAX package's view of a pipeline: `jit_sample`, `unet.dtype`,
    `takes_uncond`."""

    def __init__(self, dtype, takes_uncond):
        self.unet = types.SimpleNamespace(dtype=dtype)
        self.takes_uncond = takes_uncond

    def jit_sample(self):
        dt = self.unet.dtype
        if self.takes_uncond:
            return jax.jit(lambda p, r, t, u, c, f:
                           _standin_jax(c, f, t, u).astype(dt))
        return jax.jit(lambda p, r, t, c, f: _standin_jax(c, f, t)
                       .astype(dt))


class _StandinUNet(torch.nn.Module):
    def __init__(self, dtype):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1, dtype=dtype))
        self.cfg = types.SimpleNamespace(in_channels=4)

    @property
    def dtype(self):
        return self.w.dtype


class _Standin:
    def __init__(self, dtype, takes_uncond, calls):
        self.unet = _StandinUNet(dtype)
        self.takes_uncond = takes_uncond
        self.calls = calls

    def sample(self, latents, t, *rest, noises=None, generator=None):
        if self.takes_uncond:
            u, c, f = rest
        else:
            (c, f), u = rest, None
        assert latents.shape == (c.shape[0], c.shape[1] // 8,
                                 c.shape[2] // 8, 4)
        self.calls.append(c.shape[0])
        return _standin_torch(c, f, t, u).to(self.unet.dtype)


@pytest.mark.parametrize("h,w,dtype,u8,takes_uncond,tile_batch,feather", [
    (40, 58, "float32", False, True, None, 8),
    (40, 58, "float32", True, False, 4, 8),
    (40, 58, "bfloat16", True, True, 5, 8),
    (40, 58, "bfloat16", False, False, None, 0),
    (32, 32, "bfloat16", True, True, None, 8),   # exactly one tile
    (1080, 1920, "bfloat16", True, False, 7, 64),
])
def test_sample_tiled_tiles_and_merges_like_jax(h, w, dtype, u8,
                                                takes_uncond, tile_batch,
                                                feather):
    B = 2 if h < 1080 else 1
    tile, overlap = (512, 64) if h == 1080 else (32, 8)
    rng = np.random.default_rng(h + w)
    cond = rng.integers(0, 256, (B, h, w, 6)).astype(np.uint8)
    if not u8:
        cond = cond.astype(np.float32) / 255.0
    flow = rng.normal(0, 3, (B, h, w, 4)).astype(np.float32)
    text = rng.normal(0, 1, (B, 5, 8)).astype(np.float32)
    uncond = rng.normal(0, 1, (B, 5, 8)).astype(np.float32)
    kw = dict(tile=(tile, tile), overlap=overlap, feather=feather,
              tile_batch=tile_batch)
    want = jtiled.sample_tiled(
        _JaxStandin(getattr(jnp, dtype), takes_uncond), None,
        jax.random.PRNGKey(0), text, uncond, cond, flow, **kw)
    calls = []
    got = tiled.sample_tiled(
        _Standin(getattr(torch, dtype), takes_uncond, calls), text,
        uncond, cond, flow, generator=torch.Generator().manual_seed(0),
        **kw)
    assert got.dtype == np.float32 and got.shape == (B, h, w, 3)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    if (h, w) == (tile, tile):  # one call with every frame as it is
        n = step = B
    else:
        n = B * len(tiled.tile_grid(h, w, (tile, tile), overlap))
        step = tile_batch or n
    assert calls == [min(step, n - s) for s in range(0, n, step)]
    if (h, w) != (tile, tile):
        assert np.abs(got).max() == 1.0      # clipped
    # tensors (as the codec's decoder passes them) crop on their device
    again = tiled.sample_tiled(
        _Standin(getattr(torch, dtype), takes_uncond, []),
        torch.from_numpy(text), torch.from_numpy(uncond),
        torch.from_numpy(cond), torch.from_numpy(flow),
        generator=torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(again, got)


def test_sample_tiled_wants_its_noise():
    pipe = _Standin(torch.float32, False, [])
    cond = np.zeros((1, 40, 58, 6), np.float32)
    flow = np.zeros((1, 40, 58, 4), np.float32)
    text = np.zeros((1, 5, 8), np.float32)
    kw = dict(tile=(32, 32), overlap=8)
    with pytest.raises(ValueError, match="initial latents"):
        tiled.sample_tiled(pipe, text, None, cond, flow, **kw)
    lat = np.zeros((6, 4, 4, 4), np.float32)
    with pytest.raises(ValueError, match="re-noises"):
        tiled.sample_tiled(pipe, text, None, cond, flow, latents=lat, **kw)
    with pytest.raises(ValueError, match="5 tiles"):
        tiled.sample_tiled(pipe, text, None, cond, flow, latents=lat[:5],
                           noises=[lat], **kw)


VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
TILE, L = 32, 5


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
def tiny():
    unet = JUNet(jcfg.UNetConfig.tiny())
    controlnet = JControlNet(jcfg.ControlNetConfig.tiny())
    vae = JVAE(jcfg.VAEConfig(**VAE_KW))
    h = TILE // 8
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L, 32))
    key = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(unet.init, key, sample, t0, ctx),
        "controlnet": jax.eval_shape(controlnet.init, key, sample, t0, ctx,
                                     jnp.zeros((1, TILE, TILE, 6)),
                                     jnp.zeros((1, TILE, TILE, 4))),
        "vae": jax.eval_shape(vae.init, key, jnp.zeros((1, TILE, TILE, 3))),
    }
    params = {k: _randomize(v, 20 + i)
              for i, (k, v) in enumerate(shapes.items())}
    sampler = dict(num_inference_steps=2, guidance_scale=2.0)
    pipe = DualFlowPipeline.create(
        tcfg.UNetConfig.tiny(), tcfg.ControlNetConfig.tiny(),
        tcfg.VAEConfig(**VAE_KW), tcfg.SamplerConfig(**sampler),
        dtype=torch.float32, device="cpu")
    load_pipeline_params(pipe, params)
    jpipe = JPipeline(unet=unet, controlnet=controlnet, vae=vae,
                      schedule=JSchedule.create(jcfg.SchedulerConfig()),
                      sampler=jcfg.SamplerConfig(**sampler))
    rng = np.random.default_rng(9)
    x = dict(cond=rng.integers(0, 256, (1, 40, 58, 6)).astype(np.uint8),
             flow=rng.normal(0, 2, (1, 40, 58, 4)).astype(np.float32),
             text=(rng.normal(0, 0.5, (1, L, 32))).astype(np.float32),
             uncond=(rng.normal(0, 0.5, (1, L, 32))).astype(np.float32))
    return params, jpipe, pipe, x


def _jax_draws(rng, n_tiles, tile_batch, K):
    """The initial latents and K - 1 re-noises that JAX's sample_tiled
    draws, chunk by chunk (`fold_in(rng, s)`), in tile order; K = 0 is the
    exact pipeline (`prepare_latents` from the chunk's key)."""
    shape = (TILE // 8, TILE // 8, 4)
    lat, noises = [], [[] for _ in range(max(K - 1, 0))]
    for s in range(0, n_tiles, tile_batch):
        n = min(tile_batch, n_tiles - s)
        key = jax.random.fold_in(rng, s)
        if K:
            key, steps = jax.random.split(key)
            for k in range(K - 1):
                steps, rk = jax.random.split(steps)
                noises[k].append(jax.random.normal(rk, (n,) + shape))
        lat.append(jax.random.normal(key, (n,) + shape))
    return (np.concatenate(lat),
            [np.concatenate(n) for n in noises])


@pytest.mark.parametrize("K", [0, 2])
def test_tiny_sample_tiled_matches_jax(tiny, K):
    """A 40 x 58 frame in 6 tiles of 32 (overlap 8) in two chunks of 3, the
    exact pipeline (2 UniPC steps, CFG 2) or the distilled one with K = 2,
    fed JAX's own draws."""
    params, jpipe, pipe, x = tiny
    if K:
        dcfg = dict(num_teacher_steps=10, num_student_steps=K)
        jpipe = JDistilled(unet=jpipe.unet, controlnet=jpipe.controlnet,
                           vae=jpipe.vae, schedule=jpipe.schedule,
                           config=jcfg.DistillConfig(**dcfg))
        pipe = DistilledPipeline.from_pipeline(pipe,
                                               tcfg.DistillConfig(**dcfg))
    kw = dict(tile=(TILE, TILE), overlap=8, feather=8, tile_batch=3)
    rng = jax.random.PRNGKey(4)
    want = jtiled.sample_tiled(jpipe, params, rng, x["text"], x["uncond"],
                               x["cond"], x["flow"], **kw)
    latents, noises = _jax_draws(rng, 6, 3, K)
    got = tiled.sample_tiled(pipe, x["text"], x["uncond"], x["cond"],
                             x["flow"], latents=latents,
                             noises=noises if K else None, **kw)
    assert got.shape == want.shape == (1, 40, 58, 3)
    assert 0.05 < np.abs(want).mean() < 0.95  # neither flat nor saturated
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
