"""Each fp32 island of the main path, JAX against the port, on the same bf16
input, on the CPU: the one bf16 rounding that each side makes of the
island's result is the whole difference allowed.

`test_torch_port_fullwidth.py` and `test_torch_port_fulldepth.py` hold whole
network outputs to `chip_smoke.within_bf16_rule`, which passes a port that
rounds to bf16 once more at one island (GroupNorm's statistics, the
attention logits, FreeU's filter, the splat's weights: at most 1.11 x JAX's
own bf16 error).  Here each island runs alone, as the bf16 path calls it,
in both packages: the same bf16 tensors in (the parameters bf16 too, as
`bench.py` casts them), and the outputs compared in bf16 ulps of JAX's
output.  Where a layer around the island would round too, it is made exact
on both sides (signed permutations and identities for the attention's
projections, no bias where flax adds one after rounding, the VAE
attention without its GroupNorm).

The islands: GroupNorm (`GroupNorm32` against JAX's, its folded affine
too), the attention logits and softmax (the UNet's and ControlNet's
attention, the plain version against JAX's einsum path), FreeU's Fourier
filter, the timestep embedding, the splat with its bilinear weights (the
warper's soft splat) and the occlusion check, the VAE's mid-block
attention, the decoder's latent cast (the division
by the scaling factor before the first conv) and the fused conv's prologue
(the plain version against JAX's Pallas kernel in interpret mode).

`ulps(got, want)`: |got - want| over the spacing of bf16 numbers at
|want|, 2^(e - 7) for |want| in [2^e, 2^(e+1)); a value under the RMS of
the output takes the spacing at the RMS (a result that cancels to near
zero carries the fp32 error of its terms, which no rounding of it can
hide).  Each island is held to two limits:
  * max 1 ulp: both sides compute the island in fp32 and round its result
    once; their fp32 values differ in their last bits (sums in other
    orders, XLA's and PyTorch's exp, sin and rsqrt), so a rounding may
    land one ulp apart, not two;
  * mean 0.005 ulp: two fp32 results a few fp32 ulps apart round to
    different bf16 numbers only where a rounding boundary falls between
    them, for a few elements in ten thousand; one more bf16 rounding
    inside the island moves its result by up to half an ulp, and a few
    percent to a half of the elements change.
Read on an 8-core x86 host (max / mean), sound and with one bf16 cast
added to a copy of the port at the island:
  GroupNorm (UNet, VAE, affine)  1 / 0.0002 at most; statistics cast
      1 / 0.14-0.18, affine cast 2 / 0.21-0.22
  attention (self 40 and 160, cross 40)  1 / 0.0003 at most; logits
      cast 7-8.5 / 0.48-0.64, the softmax's sum cast 2-3 / 0.22-0.24
  FreeU (s1, s2)  1 / 0.00001 at most; the low band cast 1 / 0.030, 0.19
  timestep embedding  0.016 / 0.00005; arguments or frequencies cast
      415-431 / 11.8-12.4
  splat  1 / 0.00001; exp of the metric cast 2 / 0.081, bilinear weights
      2 / 0.078, stacked input 2 / 0.20, the flow grid 744 / 7.6
  VAE attention  0 / 0; logits cast 6.5 / 0.47
  decoder latent cast  0 / 0; latents cast before the division 3.8 / 0.24
  fused conv prologue  1 / 0.00006; the affine's product cast 3 / 0.47
The occlusion check's output is a 0/1 mask: it is held equal, pixel for
pixel, on flows whose magnitudes spread around the threshold (24% of the
pixels occluded, 0.13% within 0.1% of the threshold); sound 0 pixels
differ, the magnitude's square cast 11, the splatted flow cast 107.

On the card the islands that a kernel computes are held to the plain
versions by `chip_smoke.py`'s kernel phases: the attention logits and
softmax by `kernel` (attention), the splat by `kernel` (splat_sum), the
fused conv's prologue by `kernel` (gn_silu_conv3x3, conv3x3_head); the
others run the same plain PyTorch on the card as here.
"""

from unittest import mock

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu.models import layers as jlayers
from diffcodec_tpu.models import unet2d_condition as junet
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.models.vae import decode_from_latents as j_decode
from diffcodec_tpu.ops import conv_pallas as jconv
from diffcodec_tpu.ops.flow import compute_occlusion_mask as j_occlusion
from diffcodec_tpu.ops.softsplat import softsplat as j_softsplat

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.models import layers
from diffcodec_tpu_torch.models.unet2d_condition import fourier_filter
from diffcodec_tpu_torch.models.vae import AutoencoderKL, decode_from_latents
from diffcodec_tpu_torch.ops.conv import gn_silu_conv3x3
from diffcodec_tpu_torch.ops.flow import compute_occlusion_mask
from diffcodec_tpu_torch.ops.softsplat import softsplat

BF16 = torch.bfloat16


def ulps(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps of want (see the module's docstring)."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    floor = np.sqrt(np.mean(want ** 2))
    mag = np.maximum(np.abs(want), floor)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _bf16(x):
    """One bf16 tensor for each package from float32 numpy: (torch, jax)."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


# ---- the islands: each returns (port, jax) as float32 numpy ----

def groupnorm(C, eps, affine_only=False):
    """GroupNorm32 on UNet-like features (an offset mean, so that flax's
    E[x^2] - E[x]^2 and the port's two-pass variance see cancellation);
    affine_only: the folded (scale, shift) that the fused conv takes."""
    rng = np.random.default_rng(C)
    x = 1.5 + 2.0 * rng.standard_normal((2, 8, 8, C))
    xt, xj = _bf16(x)
    wt, wj = _bf16(rng.uniform(0.7, 1.3, C))
    bt, bj = _bf16(rng.uniform(-0.1, 0.1, C))
    m = jlayers.GroupNorm32(eps=eps, dtype=jnp.bfloat16)
    params = {"params": {"norm": {"scale": wj, "bias": bj}}}
    port = layers.GroupNorm32(C, eps).to(BF16)
    port.load_state_dict({"weight": wt, "bias": bt})
    if affine_only:
        want = m.apply(params, xj, return_affine=True)
        got = port.affine(xt)
        return (np.concatenate([_np(a) for a in got]),
                np.concatenate([_np(a) for a in want]))
    return _np(port(xt)), _np(m.apply(params, xj))


def _dense(kernel, bias):
    """A flax Dense's parameters and the port's Linear's: bf16, the bias
    zero (flax adds a bias to its bf16 product, a second rounding, and
    PyTorch inside its fp32 sum: a difference of every biased bf16 layer,
    not of an island)."""
    kt, kj = _bf16(kernel)
    zt, zj = (torch.zeros(kernel.shape[1], dtype=BF16),
              jnp.zeros(kernel.shape[1], jnp.bfloat16))
    return (({"kernel": kj, "bias": zj} if bias else {"kernel": kj}),
            ({"weight": kt.T, "bias": zt} if bias else {"weight": kt.T}))


def _projections(rng, n, bias):
    """{name: (flax params, port state)}: the q and k projections two
    random signed permutations (so that no logit is a query's product with
    itself), the v and out projections identities; every product with them
    is exact in bf16, so the attention core is all that rounds."""
    def signed_permutation():
        w = np.zeros((n, n), np.float32)
        w[np.arange(n), rng.permutation(n)] = rng.choice([-1.0, 1.0], n)
        return w

    eye = np.eye(n, dtype=np.float32)
    return {"to_q": _dense(signed_permutation(), bias),
            "to_k": _dense(signed_permutation(), bias),
            "to_v": _dense(eye, bias), "to_out": _dense(eye, True)}


def _port_state(proj):
    return {f"{'to_out.0' if name == 'to_out' else name}.{k}": v
            for name, (_, state) in proj.items() for k, v in state.items()}


def attention(Lq, Lk, D, heads=8):
    """The UNet's attention: q, k and v bf16 [B, L, heads * D] (Lk keys of
    a context as wide as the queries where Lk != Lq), logits and softmax in
    fp32, the probabilities rounded to bf16 for the product with v.  The
    port's module runs the plain version here."""
    inner = heads * D
    rng = np.random.default_rng(Lq * D + Lk)
    xt, xj = _bf16(1.5 * rng.standard_normal((2, Lq, inner)))
    ct, cj = (None, None) if Lk == Lq else _bf16(
        1.5 * rng.standard_normal((2, Lk, inner)))
    proj = _projections(rng, inner, bias=False)
    want = jlayers.Attention(heads, D, dtype=jnp.bfloat16).apply(
        {"params": {k: v[0] for k, v in proj.items()}}, xj, cj)
    port = layers.Attention(inner, heads, D, context_dim=inner).to(BF16)
    port.load_state_dict(_port_state(proj))
    return _np(port(xt, ct)), _np(want)


def freeu_filter(side, C, scale):
    """FreeU's filter of a skip, threshold 1, at the 512 px decode's
    up-block resolutions 0 and 1 (8 x 8 and 16 x 16); the
    features carry a mean, as a resnet's output does, so that the low
    frequencies that the filter scales are large."""
    rng = np.random.default_rng(side)
    xt, xj = _bf16(3.0 + 2.0 * rng.standard_normal((2, side, side, C)))
    return (_np(fourier_filter(xt, 1, scale)),
            _np(junet.fourier_filter(xj, 1, scale)))


def timestep_embedding():
    """The sinusoidal embedding of every training timestep at the UNet's
    320 channels, fp32 (rounded to bf16 by the first linear's cast)."""
    t = np.arange(1000, dtype=np.int32)
    return (_np(layers.timestep_embedding(torch.from_numpy(t), 320)),
            _np(jlayers.timestep_embedding(jnp.asarray(t), 320)))


def splat():
    """The warper's soft splat: bf16 features, flow and metric in, the fp32
    splat, its result rounded to bf16 (`FeatureWarperSoftsplat`, both
    packages); the features' half-width at the 64 x 64 level."""
    rng = np.random.default_rng(5)
    feat = _bf16(rng.standard_normal((2, 32, 32, 160)))
    flow = _bf16(2.0 * rng.standard_normal((2, 32, 32, 2)))
    metric = _bf16(rng.standard_normal((2, 32, 32, 1)))
    got = softsplat(feat[0].float(), flow[0].float(), metric[0].float(),
                    "soft").to(BF16)
    want = j_softsplat(feat[1].astype(jnp.float32),
                       flow[1].astype(jnp.float32),
                       metric[1].astype(jnp.float32),
                       "soft").astype(jnp.bfloat16)
    return _np(got), _np(want)


class _NoNorm(flax_nn.Module):
    """Stands in for JAX's GroupNorm32 inside the VAE's attention block."""
    num_groups: int = 32
    eps: float = 1e-6
    dtype: jnp.dtype = jnp.float32

    def __call__(self, x):
        return x


def vae_attention(side=16, C=512):
    """The VAE mid block's attention (one head of 512, fp32 logits and
    softmax, the residual).  Its GroupNorm, an island of its own above, is
    left out on both sides: a GroupNorm result one ulp apart moves the q and
    k products of its row, and through them the softmax of many rows."""
    rng = np.random.default_rng(6)
    xt, xj = _bf16(2.0 * rng.standard_normal((1, side, side, C)))
    proj = _projections(rng, C, bias=True)
    with mock.patch.object(jlayers, "GroupNorm32", _NoNorm):
        want = jlayers.AttentionBlock2D(dtype=jnp.bfloat16).apply(
            {"params": {k: v[0] for k, v in proj.items()}}, xj)
    port = layers.AttentionBlock2D(C).to(BF16)
    port.group_norm = torch.nn.Identity()
    port.load_state_dict(_port_state(proj))
    return _np(port(xt)), _np(want)


class _PostQuantVAE(JVAE):
    """JAX's AutoencoderKL whose decode stops after its first conv."""

    def decode(self, z):
        return self.post_quant_conv(z)


def decoder_latent_cast():
    """`decode_from_latents` up to the decoder's first conv (the 1 x 1
    post-quant conv, bf16): the fp32 latents divided by the scaling factor
    and rounded to bf16 once."""
    rng = np.random.default_rng(7)
    z = (3.0 * rng.standard_normal((4, 32, 32, 4))).astype(np.float32)
    wt, wj = _bf16(rng.uniform(-0.5, 0.5, (4, 4)))
    # no bias: flax's conv adds it to its bf16 result (a second rounding)
    # and PyTorch's in the fp32 sum, in every biased conv, not only here
    cfg = tcfg.VAEConfig(base_channels=8, channel_mults=(1,),
                         layers_per_block=1)
    vae = AutoencoderKL(cfg).to(BF16)
    vae.post_quant_conv.weight.data.copy_(wt.T[:, :, None, None])
    vae.post_quant_conv.bias.data.zero_()
    vae.decode = lambda z: vae.post_quant_conv(z)
    want = j_decode(_PostQuantVAE(dtype=jnp.bfloat16),
                    {"params": {"post_quant_conv": {
                        "kernel": wj[None, None],
                        "bias": jnp.zeros(4, jnp.bfloat16)}}},
                    jnp.asarray(z))
    return _np(decode_from_latents(vae, torch.from_numpy(z))), _np(want)


def fused_conv_prologue():
    """GN affine (fp32 scale and shift) + SiLU + conv3x3 without a
    residual: the port's plain version against JAX's Pallas kernel in
    interpret mode; each rounds the affine once, its SiLU once and the
    conv with its bias once."""
    rng = np.random.default_rng(8)
    C = O = 64
    xt, xj = _bf16(1.0 + 2.0 * rng.standard_normal((1, 16, 16, C)))
    scale = rng.uniform(0.2, 0.6, (1, C)).astype(np.float32)
    shift = rng.uniform(-0.5, 0.5, (1, C)).astype(np.float32)
    kt, kj = _bf16(rng.standard_normal((3, 3, C, O)) / np.sqrt(9 * C))
    bt, bj = _bf16(rng.uniform(-0.1, 0.1, O))
    want = jconv.gn_silu_conv3x3_pallas(xj, jnp.asarray(scale),
                                        jnp.asarray(shift), kj, bj,
                                        interpret=True)
    got = gn_silu_conv3x3(xt, torch.from_numpy(scale),
                          torch.from_numpy(shift),
                          kt.permute(3, 2, 0, 1).contiguous(), bt)
    return _np(got), _np(want)


# the limits in ulps (see the module's docstring)
MAX_ULP, MEAN_ULP = 1.0, 0.005
SITES = {
    "groupnorm_unet": lambda: groupnorm(320, 1e-5),
    "groupnorm_vae": lambda: groupnorm(512, 1e-6),
    "groupnorm_affine": lambda: groupnorm(320, 1e-5, affine_only=True),
    "attention_self_d40": lambda: attention(64, 64, 40),
    "attention_cross_d40": lambda: attention(64, 77, 40),
    "attention_self_d160": lambda: attention(16, 16, 160),
    "freeu_filter_s1": lambda: freeu_filter(8, 1280, 0.9),
    "freeu_filter_s2": lambda: freeu_filter(16, 1280, 0.2),
    "timestep_embedding": timestep_embedding,
    "splat": splat,
    "vae_attention": vae_attention,
    "decoder_latent_cast": decoder_latent_cast,
    "fused_conv_prologue": fused_conv_prologue,
}


@pytest.mark.parametrize("name", sorted(SITES))
@torch.no_grad()
def test_island_rounds_once_as_jax_does(name):
    got, want = SITES[name]()
    assert got.shape == want.shape, name
    assert np.isfinite(want).all() and np.abs(want).max() > 0, name
    u = ulps(got, want)
    assert u.max() <= MAX_ULP and u.mean() <= MEAN_ULP, (
        name, float(u.max()), float(u.mean()))


@torch.no_grad()
def test_occlusion_mask_equals_jax():
    """compute_occlusion_mask on bf16 flows (its fp32 splat, the forward
    and backward flows' sum, its magnitude against 0.3): the same mask,
    pixel for pixel.  A translation with small disagreements between the
    two directions, so that the magnitudes spread around the threshold."""
    rng = np.random.default_rng(9)
    shape = (2, 128, 128, 2)
    fwd = np.asarray([1.3, -0.7]) + 0.15 * rng.standard_normal(shape)
    bwd = -np.asarray([1.3, -0.7]) + 0.15 * rng.standard_normal(shape)
    (ft, fj), (bt, bj) = _bf16(fwd), _bf16(bwd)
    got = _np(compute_occlusion_mask(bt, ft))
    want = _np(j_occlusion(bj, fj))
    assert got.shape == want.shape == shape[:3] + (1,)
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got, want)
