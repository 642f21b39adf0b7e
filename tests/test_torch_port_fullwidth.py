"""The denoise path at SD-1.5 widths, JAX against the port, on the CPU, in
bf16 and in fp32.

Configs: `UNetConfig()` and `ControlNetConfig()` at their published widths
with one depth cut, `layers_per_block=1` (SD-1.5 has 2): block widths
320/640/1280/1280, 8 heads of 40/80/160, cross-attention over 77 x 768
tokens in the first three blocks, transformer depth 1, the ControlNet's
inject widths (320, 320, 640, 1280).  `VAEConfig()` whole: widths
128/256/512/512, 2 layers a block.  Frames of 64 px (8 x 8 latents),
batch 1, timestep 500; the conditioning (uniform in [-1, 1]), the flows
(2 N(0, 1) px), the text (0.1 N(0, 1)) and the noise latent (N(0, 1)) are
drawn by numpy from a seed.  Parameters take their shapes from
`jax.eval_shape(model.init, ...)` and seeded float32 values (kernels
uniform with variance 1 / fan_in, norm scales in [0.7, 1.3], biases in
[-0.1, 0.1]), carried into the port by `weights.load_flax_params`.

Each network is computed four times: JAX in fp32; JAX in bf16 as
`bench.py` runs it (the module's dtype bf16, its parameters, the
conditioning, the flows and the text cast to bf16); the port in bf16
(`.to(torch.bfloat16)`, the same inputs cast); the port in fp32.  The
outputs: the `DualFlowControlNet` call (the extractor's four pyramid
features, through the fp32 splats and occlusion checks, then the trunk's
8 down residuals and its mid residual at conditioning scale 1.35); the
`UNet2DConditionModel` call with JAX's fp32 residuals (rounded to bf16 in
the bf16 runs) and FreeU at `SamplerConfig`'s values; the VAE decoder on
the noise latent, unfused, and the port's fused-conv decoder (its kernels'
plain versions here) against JAX's unfused one.

bf16: with relL2(a, b) = ||a - b|| / ||b||, e_jax = relL2(jax_bf16,
jax_fp32), e_port = relL2(port_bf16, jax_fp32) and d = relL2(port_bf16,
jax_bf16), every output holds e_port <= 1.5 e_jax + 1e-3 and
d <= 2.5 e_jax + 1e-3 (`chip_smoke.within_bf16_rule`, which the card's
`fullwidth` phase holds too).  The first source is JAX's own bf16 error:
two roundings of equal size, independent, put d near 1.41 e_jax.  The
second is the torch build's CPU rounding, which moved bf16 results by up
to 0.02 in cosine between two builds.  fp32: the port against JAX element
by element (FP32_ATOL, FP32_RTOL below).

What the rule sees: a wiring fault, or a cast that loses more than JAX's
own bf16 error (the timestep embedding's arguments in bf16 read e_port
2.6-4.3 e_jax).  What it does not: one extra bf16 rounding at one site
(the GroupNorm's statistics or its affine, the attention logits, the VAE
attention's, FreeU's filter, the decoder's latents, the fused conv's
prologue, the splat's weights) reads at most 1.11 e_jax, and 1.22 e_jax
for d, within what sound runs read (up to 1.07 and 1.20 on the card
against the CPU); each tried once in a copy of the port.
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
from diffcodec_tpu.models.vae import decode_from_latents as j_decode

from chip_smoke import within_bf16_rule
from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models import layers
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL, decode_from_latents

H, B, L, T = 64, 1, 77, 500
# fp32: the tiny configs' limits (`test_torch_port_models.py`), not
# loosened for full width: sums over up to 11,520 terms (3 x 3 x 1280)
# here against 576 there, on outputs up to ~13, left the port's largest
# error at 0.13 of them on the host tried
FP32_ATOL, FP32_RTOL = 1e-4, 1e-3

JU = jcfg.UNetConfig(layers_per_block=1)
TU = tcfg.UNetConfig(layers_per_block=1)
JC, TC = jcfg.ControlNetConfig(unet=JU), tcfg.ControlNetConfig(unet=TU)
JV, TV = jcfg.VAEConfig(), tcfg.VAEConfig()
SAMPLER = jcfg.SamplerConfig()
FREEU = (SAMPLER.freeu_s1, SAMPLER.freeu_s2, SAMPLER.freeu_b1,
         SAMPLER.freeu_b2)
SCALE = SAMPLER.controlnet_conditioning_scale


def _draw(shapes, seed):
    """Seeded float32 values for a tree of shapes, drawn as float32."""
    rng = np.random.default_rng(seed)

    def uniform(shape, lo, hi):
        v = rng.random(shape, np.float32)
        v *= np.float32(hi - lo)
        v += np.float32(lo)
        return v

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return uniform(s.shape, 0.7, 1.3)
        if name == "bias":
            return uniform(s.shape, -0.1, 0.1)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        bound = float(np.sqrt(3.0 / fan_in))
        return uniform(s.shape, -bound, bound)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    return dict(
        cond=rng.uniform(-1, 1, (B, H, H, 6)).astype(f32),
        flow=(2 * rng.standard_normal((B, H, H, 4))).astype(f32),
        text=(0.1 * rng.standard_normal((B, L, JU.cross_attention_dim))
              ).astype(f32),
        noise=rng.standard_normal((B, H // 8, H // 8, 4)).astype(f32),
        latents=rng.standard_normal((B, H // 8, H // 8, 4)).astype(f32))


X = _inputs()
# the inputs that bench.py casts to the compute dtype
CAST = ("cond", "flow", "text")


def _jax_inputs(dtype):
    return {k: jnp.asarray(v).astype(dtype) if k in CAST else jnp.asarray(v)
            for k, v in X.items()}


def _port_inputs(dtype):
    return {k: torch.from_numpy(v).to(dtype) if k in CAST
            else torch.from_numpy(v) for k, v in X.items()}


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _torch_np(tree):
    return [t.float().numpy() for t in tree]


def _cast(params, dtype):
    """The parameters in the compute dtype, as bench.py casts them (inside
    the jitted function: no second copy on the host)."""
    return jax.tree.map(lambda a: a.astype(dtype), params)


def _jax_twice(params, run):
    """run(params, dtype) in JAX fp32 and bf16, as float32 numpy."""
    return {"jax_fp32": _np(run(params, jnp.float32)),
            "jax_bf16": _np(run(params, jnp.bfloat16))}


def _port_twice(make, params, name_map, run):
    """A port module from `make` with `params` carried in by the bridge,
    then run(module, dtype) in fp32 and, the module cast, in bf16.  The
    module is made without PyTorch's initialisation (on the meta device,
    then allocated): the strict load overwrites every parameter, and no
    module of the port holds another tensor."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device="cpu")
    weights.load_flax_params(module, params, name_map)
    out = {"port_fp32": run(module, torch.float32)}
    module.to(torch.bfloat16)
    out["port_bf16"] = run(module, torch.bfloat16)
    return out


@pytest.fixture(scope="module")
def controlnet_out():
    """{run: [4 pyramid features, 8 down residuals, mid residual]}."""
    key = jax.random.PRNGKey(0)
    h = H // 8
    shapes = jax.eval_shape(
        JControlNet(JC).init, key, jnp.zeros((B, h, h, 4)),
        jnp.asarray([0]), jnp.zeros((B, L, JU.cross_attention_dim)),
        jnp.zeros((B, H, H, 6)), jnp.zeros((B, H, H, 4)))
    params = _draw(shapes, 2)

    def jax_run(p, dtype):
        m = JControlNet(JC, dtype=dtype)

        def f(p, x):
            p = _cast(p, dtype)
            pyr = m.apply(p, x["cond"], x["flow"], method=m.extract_pyramid)
            down, mid = m.apply(p, x["noise"], jnp.int32(T), x["text"], pyr,
                                SCALE, method=m.backbone)
            return [*pyr, *down, mid]
        return jax.jit(f)(p, _jax_inputs(dtype))

    @torch.no_grad()
    def port_run(m, dtype):
        x = _port_inputs(dtype)
        pyr = m.extract_pyramid(x["cond"], x["flow"])
        down, mid = m.backbone(x["noise"], T, x["text"], pyr, SCALE)
        return _torch_np([*pyr, *down, mid])

    out = _jax_twice(params, jax_run)
    out.update(_port_twice(lambda: DualFlowControlNet(TC), params,
                           weights.controlnet_name_map(TC), port_run))
    return out


@pytest.fixture(scope="module")
def unet_out(controlnet_out):
    """{run: [eps]}: JAX's fp32 residuals into every run, FreeU on."""
    residuals = controlnet_out["jax_fp32"][len(TC.inject_channels):]
    key = jax.random.PRNGKey(0)
    h = H // 8
    shapes = jax.eval_shape(JUNet(JU).init, key, jnp.zeros((B, h, h, 4)),
                            jnp.asarray([0]),
                            jnp.zeros((B, L, JU.cross_attention_dim)))
    params = _draw(shapes, 1)

    def jax_run(p, dtype):
        m = JUNet(JU, dtype=dtype)

        def f(p, x, res):
            return [m.apply(_cast(p, dtype), x["noise"], jnp.int32(T), x["text"],
                            down_block_additional_residuals=tuple(res[:-1]),
                            mid_block_additional_residual=res[-1],
                            freeu=FREEU)]
        res = [jnp.asarray(r).astype(dtype) for r in residuals]
        return jax.jit(f)(p, _jax_inputs(dtype), res)

    @torch.no_grad()
    def port_run(m, dtype):
        x = _port_inputs(dtype)
        res = [torch.from_numpy(r).to(dtype) for r in residuals]
        return _torch_np([m(x["noise"], T, x["text"],
                            down_block_additional_residuals=res[:-1],
                            mid_block_additional_residual=res[-1],
                            freeu=FREEU)])

    out = _jax_twice(params, jax_run)
    out.update(_port_twice(lambda: UNet2DConditionModel(TU), params,
                           weights.unet_name_map(TU), port_run))
    return out


@pytest.fixture(scope="module")
def vae_out():
    """{run: [images]}, and the port's fused-conv decoder as `port_*_fused`
    beside its unfused `port_*`."""
    shapes = jax.eval_shape(JVAE(JV).init, jax.random.PRNGKey(0),
                            jnp.zeros((B, H, H, 3)))
    params = _draw(shapes, 3)

    def jax_run(p, dtype):
        def f(p, z):
            return j_decode(JVAE(JV, dtype=dtype), _cast(p, dtype), z)
        return [jax.jit(f)(p, jnp.asarray(X["latents"]))]

    out = _jax_twice(params, jax_run)
    z = torch.from_numpy(X["latents"])

    @torch.no_grad()
    def port_run(m, dtype):
        return _torch_np([decode_from_latents(m, z)])

    for tag, fused in (("", False), ("_fused", True)):
        got = _port_twice(functools.partial(AutoencoderKL, TV, fused),
                          params, weights.vae_name_map(TV), port_run)
        out.update({k + tag: v for k, v in got.items()})
    return out


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_errors(out, port="port_bf16"):
    """[(e_jax, e_port, d)] output by output."""
    return [(rel_l2(jb, jf), rel_l2(pb, jf), rel_l2(pb, jb))
            for jf, jb, pb in zip(out["jax_fp32"], out["jax_bf16"],
                                  out[port])]


def _check_bf16(out, names, port="port_bf16"):
    errs = bf16_errors(out, port)
    assert len(errs) == len(names)
    for name, (e_jax, e_port, d) in zip(names, errs):
        assert np.isfinite(e_jax) and e_jax > 0, name
        assert within_bf16_rule(e_jax, e_port, d), (name, e_jax, e_port, d)


def _check_fp32(out, names, port="port_fp32"):
    for name, got, want in zip(names, out[port], out["jax_fp32"]):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=FP32_ATOL,
                                   rtol=FP32_RTOL, err_msg=name)


CONTROLNET_OUTPUTS = ([f"pyramid{i}" for i in range(4)]
                      + [f"down{i}" for i in range(8)] + ["mid"])


def test_controlnet_shapes_are_sd15s(controlnet_out):
    """Four pyramid levels at the inject widths, then the 8 down residuals
    of one layer a block and the mid residual."""
    h = H // 8
    want = ([(B, h >> i, h >> i, c) for i, c in enumerate(TC.inject_channels)]
            + [(B, 8, 8, 320)] * 2 + [(B, 4, 4, 320), (B, 4, 4, 640),
                                       (B, 2, 2, 640), (B, 2, 2, 1280),
                                       (B, 1, 1, 1280), (B, 1, 1, 1280)]
            + [(B, 1, 1, 1280)])
    for run in ("jax_fp32", "jax_bf16", "port_fp32", "port_bf16"):
        assert [a.shape for a in controlnet_out[run]] == want, run


def test_controlnet_bf16_within_jax_rounding(controlnet_out):
    _check_bf16(controlnet_out, CONTROLNET_OUTPUTS)


def test_controlnet_fp32_matches_jax(controlnet_out):
    _check_fp32(controlnet_out, CONTROLNET_OUTPUTS)


def test_unet_bf16_within_jax_rounding(unet_out):
    _check_bf16(unet_out, ["eps"])


def test_unet_fp32_matches_jax(unet_out):
    assert unet_out["port_fp32"][0].shape == (B, H // 8, H // 8, 4)
    _check_fp32(unet_out, ["eps"])


@pytest.mark.parametrize("tag", ["", "_fused"])
def test_vae_decoder_bf16_within_jax_rounding(vae_out, tag):
    _check_bf16(vae_out, ["images"], "port_bf16" + tag)


@pytest.mark.parametrize("tag", ["", "_fused"])
def test_vae_decoder_fp32_matches_jax(vae_out, tag):
    assert vae_out["port_fp32" + tag][0].shape == (B, H, H, 3)
    _check_fp32(vae_out, ["images"], "port_fp32" + tag)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("channels,side", [(320, 8), (640, 4), (1280, 2),
                                           (1280, 1)])
def test_attention_operands_take_the_kernels_layout(monkeypatch, batch,
                                                    channels, side):
    """The q, k and v that a transformer at SD-1.5's widths hands to
    `ops.attention.attention` are contiguous and 16-byte aligned, as the
    card's kernel takes them, at batch 1 too (no CFG: a distilled decode
    of one frame), where the heads' reshape alone is a strided view."""
    seen = []

    def recording(q, k, v, scale):
        seen.extend((tuple(t.shape), t.is_contiguous(), t.data_ptr() % 16)
                    for t in (q, k, v))
        return plain(q, k, v, scale)
    plain = layers.attention
    monkeypatch.setattr(layers, "attention", recording)
    g = torch.Generator().manual_seed(0)
    block = layers.Transformer2D(channels, JU.attention_heads,
                                 JU.cross_attention_dim)
    x = torch.randn((batch, side, side, channels), generator=g)
    text = torch.randn((batch, L, JU.cross_attention_dim), generator=g)
    with torch.no_grad():
        block(x, text)
    assert len(seen) == 6
    for shape, contiguous, offset in seen:
        assert contiguous and offset == 0, shape
