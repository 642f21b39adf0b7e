"""The port's fused conv path against the JAX package, on the CPU.

The plain versions behind the conv kernel wrappers of
`diffcodec_tpu_torch/ops/conv.py` are held against the JAX package's Pallas
kernels run in interpret mode (as `tests/test_conv_pallas.py` runs them),
and the modules that route to the kernels in fused mode (`ResnetBlock2D`,
`Upsample2D`, the VAE `Decoder`) against their JAX modules, which on the
CPU compute the same function unfused (the JAX gates need a TPU,
`conv_pallas.py:402`).  fp32 on both sides, inputs from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models import layers as jlayers
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.models.vae import decode_from_latents as j_decode
from diffcodec_tpu.ops import conv_pallas as jconv

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models import layers as tlayers
from diffcodec_tpu_torch.models.vae import AutoencoderKL, decode_from_latents
from diffcodec_tpu_torch.ops import conv as tconv

# the Pallas kernels against their XLA references, fp32 (JAX's own limits,
# tests/test_conv_pallas.py:129): the same sums in another order
KERNEL_TOL = dict(atol=2e-5, rtol=1e-5)
# fp32 through whole modules: convs and GroupNorm statistics accumulate in
# another order in XLA and in PyTorch's CPU kernels (the limits of
# tests/test_torch_port_models.py)
MODULE_TOL = dict(atol=1e-4, rtol=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(k):
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _conv_inputs(seed, B=2, H=16, W=16, C=8, O=8):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, H, W, C)).astype(np.float32),
        scale=(rng.random((B, C)) + 0.5).astype(np.float32),
        # nonzero shifts: a pad ring that is not zeroed after the affine
        # would read silu(shift) there
        shift=rng.standard_normal((B, C)).astype(np.float32),
        k=(rng.standard_normal((3, 3, C, O)) * 0.1).astype(np.float32),
        b=(rng.standard_normal(O) * 0.1).astype(np.float32),
        res=rng.standard_normal((B, H, W, O)).astype(np.float32))


@pytest.mark.parametrize("O", [8, 3])
def test_silu_conv3x3_matches_pallas_interpret(O):
    d = _conv_inputs(0, O=O)
    want = jconv.fused_silu_conv3x3_pallas(
        jnp.asarray(d["x"]), jnp.asarray(d["k"]), jnp.asarray(d["b"]), th=8,
        interpret=True)
    got = tconv.silu_conv3x3(_t(d["x"]), _oihw(d["k"]), _t(d["b"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("O,residual", [(8, False), (8, True), (3, False)])
def test_gn_silu_conv3x3_matches_pallas_interpret(O, residual):
    d = _conv_inputs(1, O=O)
    res = d["res"] if residual else None
    want = jconv.gn_silu_conv3x3_pallas(
        *map(jnp.asarray, (d["x"], d["scale"], d["shift"], d["k"], d["b"])),
        residual=None if res is None else jnp.asarray(res), th=8,
        interpret=True)
    got = tconv.gn_silu_conv3x3(_t(d["x"]), _t(d["scale"]), _t(d["shift"]),
                                _oihw(d["k"]), _t(d["b"]),
                                None if res is None else _t(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("H,W,C,O", [(8, 8, 8, 8), (16, 8, 16, 3)])
def test_upsample_conv3x3_matches_pallas_interpret(H, W, C, O):
    d = _conv_inputs(2, H=H, W=W, C=C, O=O)
    want = jconv.upsample_conv3x3_pallas(
        jnp.asarray(d["x"]), jnp.asarray(d["k"]), jnp.asarray(d["b"]), th=8,
        interpret=True)
    got = tconv.upsample_conv3x3(_t(d["x"]), _oihw(d["k"]), _t(d["b"]))
    assert got.shape == (2, 2 * H, 2 * W, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_collapsed_upsample_taps_match_jax(chunk):
    """The kernel's [4, O, 4, C] taps are JAX's [2, 2, 2, 2, C, O]
    `_collapse_upsample_kernel`, re-laid out; both sum in fp32 here.  The
    chunked layout is pinned at two chunk widths: 64, the Hopper loop's TMA
    rows, which every entry takes now, and 16, what the mma.sync loop's
    upsample took before (`scripts/conv_kernel_ab.py` lays an older
    source's weights out so)."""
    k = _conv_inputs(3, C=8, O=5)["k"]
    want = np.asarray(jconv._collapse_upsample_kernel(jnp.asarray(k)))
    want = want.transpose(0, 1, 5, 2, 3, 4).reshape(4, 5, 4, 8)
    got = tconv.collapse_upsample_taps(_oihw(k))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
    taps = tconv.conv3x3_taps(_oihw(k))
    np.testing.assert_array_equal(
        taps.numpy(), k.transpose(3, 0, 1, 2).reshape(5, 9, 8))
    # the kernel reads chunk j's weights as one run [taps][O][chunk], C
    # zero-padded to a multiple of the chunk
    chunked = tconv.chunk_taps(got, chunk).numpy()
    assert chunked.shape == (4, 1, 4, 5, chunk)
    np.testing.assert_array_equal(chunked[..., :8],
                                  got.numpy().transpose(0, 2, 1, 3)[:, None])
    assert not chunked[..., 8:].any()


def _upsample_walk(x, weight, bias):
    """The Hopper loop's upsample (`conv3x3.cu`, mode S = 0), written out
    in torch: x padded by one pixel (the TMA box's zero fill) and to Cp
    channels; for each phase (di, dj), the sum over chunks k of 64 input
    channels and collapsed taps (a, b) of the window at offset (di + a,
    dj + b) times the weights at depth (p * n_chunks + k) * 4 + t of the
    kernel's [4, Cp / 64, 4, O, 64] layout, read as the weight tensor
    map's [depth][O][64]; plus the bias; the phases interleaved."""
    B, H, W, C = x.shape
    O = weight.shape[0]
    taps = tconv.chunk_taps(tconv.collapse_upsample_taps(weight),
                            tconv.CONV_CHUNK)
    n_chunks = taps.shape[1]
    depth = taps.reshape(-1, O, tconv.CONV_CHUNK)
    xp = torch.nn.functional.pad(
        x, (0, n_chunks * tconv.CONV_CHUNK - C, 1, 1, 1, 1))
    out = torch.empty(B, 2 * H, 2 * W, O)
    for p in range(4):
        di, dj = p >> 1, p & 1
        acc = torch.zeros(B, H, W, O)
        for k in range(n_chunks):
            chans = slice(k * tconv.CONV_CHUNK, (k + 1) * tconv.CONV_CHUNK)
            for t in range(4):
                a, b = t >> 1, t & 1
                win = xp[:, di + a:di + a + H, dj + b:dj + b + W, chans]
                acc += win @ depth[(p * n_chunks + k) * 4 + t].T
        out[:, di::2, dj::2] = acc + bias
    return out


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla_ref"])
@pytest.mark.parametrize("B,H,W,C,O", [(2, 8, 8, 16, 8),
                                       (1, 8, 16, 72, 12)])
def test_upsample_walk_matches_jax(B, H, W, C, O, reference):
    """The indexing of the upsample's Hopper walk (phases, shifted windows,
    weight depths, chunks of 64 with C = 72 past one, interleave) against
    the JAX package's Pallas kernel in interpret mode and its XLA
    reference, fp32."""
    d = _conv_inputs(5, B=B, H=H, W=W, C=C, O=O)
    args = (jnp.asarray(d["x"]), jnp.asarray(d["k"]), jnp.asarray(d["b"]))
    if reference == "pallas_interpret":
        want = jconv.upsample_conv3x3_pallas(*args, th=8, interpret=True)
    else:
        want = jconv.upsample_conv3x3_ref(*args)
    got = _upsample_walk(_t(d["x"]), _oihw(d["k"]), _t(d["b"]))
    assert got.shape == (B, 2 * H, 2 * W, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_chunk_taps_spans_chunks():
    """C = 96 at the Hopper loop's chunk of 64: two chunks, the second
    holding channels 64-95 and then zeros, each [taps][O][64] one run."""
    taps = torch.arange(2 * 9 * 96, dtype=torch.float32).reshape(1, 2, 9, 96)
    got = tconv.chunk_taps(taps, tconv.CONV_CHUNK)
    assert got.shape == (1, 2, 9, 2, 64) and got.is_contiguous()
    want = taps.permute(0, 2, 1, 3)  # [1, 9, O, 96]
    torch.testing.assert_close(got[:, 0], want[..., :64], rtol=0, atol=0)
    torch.testing.assert_close(got[:, 1, ..., :32], want[..., 64:], rtol=0,
                               atol=0)
    assert not got[:, 1, ..., 32:].any()


def test_conv_wrappers_take_plain_versions_on_cpu_only():
    d = _conv_inputs(4, C=8, O=8)
    x, k, b = _t(d["x"]), _oihw(d["k"]), _t(d["b"])
    before = (tconv.silu_conv3x3.launches, tconv.gn_silu_conv3x3.launches,
              tconv.upsample_conv3x3.launches)
    torch.testing.assert_close(tconv.silu_conv3x3(x, k, b),
                               tconv.silu_conv3x3_ref(x, k, b), atol=0,
                               rtol=0)
    args = (x, _t(d["scale"]), _t(d["shift"]), k, b, _t(d["res"]))
    torch.testing.assert_close(tconv.gn_silu_conv3x3(*args),
                               tconv.gn_silu_conv3x3_ref(*args), atol=0,
                               rtol=0)
    torch.testing.assert_close(tconv.upsample_conv3x3(x, k, b),
                               tconv.upsample_conv3x3_ref(x, k, b), atol=0,
                               rtol=0)
    assert (tconv.silu_conv3x3.launches, tconv.gn_silu_conv3x3.launches,
            tconv.upsample_conv3x3.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        tconv.gn_silu_conv3x3(x.to("meta"), *args[1:])
    with pytest.raises(ValueError, match="unsupported device"):
        tconv.upsample_conv3x3(x.to("meta"), k, b)


def _randomize(tree, seed):
    """Seeded float32 values for every leaf: norm scales near 1, small
    biases, kernels ~ N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            v = rng.uniform(0.7, 1.3, p.shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, p.shape)
        else:
            v = rng.standard_normal(p.shape) / np.sqrt(np.prod(p.shape[:-1]))
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _resnet_state_dict(p):
    """A JAX ResnetBlock2D's params -> the port's state dict."""
    sd = {}
    for i in (1, 2):
        sd[f"norm{i}.weight"] = p[f"norm{i}"]["norm"]["scale"]
        sd[f"norm{i}.bias"] = p[f"norm{i}"]["norm"]["bias"]
        sd[f"conv{i}.weight"] = np.asarray(
            p[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"conv{i}.bias"] = p[f"conv{i}"]["bias"]
    if "conv_shortcut" in p:
        sd["conv_shortcut.weight"] = np.asarray(
            p["conv_shortcut"]["kernel"]).transpose(3, 2, 0, 1)
        sd["conv_shortcut.bias"] = p["conv_shortcut"]["bias"]
    return {k: _t(v) for k, v in sd.items()}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 24)])
def test_resnet_block_matches_jax(fused, cin, cout):
    x = np.random.default_rng(5).standard_normal((2, 8, 12, cin)).astype(
        np.float32) * 1.5 + 0.3
    jmod = jlayers.ResnetBlock2D(cout, use_time_emb=False, eps=1e-6)
    params = _randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                       jnp.asarray(x)), 6)
    want = jmod.apply(params, jnp.asarray(x))
    tmod = tlayers.ResnetBlock2D(cin, cout, None, eps=1e-6, fused_conv=fused)
    tmod.load_state_dict(_resnet_state_dict(params["params"]), strict=True)
    with torch.no_grad():
        got = tmod(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_upsample_module_matches_jax(fused):
    x = np.random.default_rng(7).standard_normal((2, 5, 6, 16)).astype(
        np.float32)
    jmod = jlayers.Upsample2D(16)
    params = _randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                       jnp.asarray(x)), 8)
    want = jmod.apply(params, jnp.asarray(x))
    tmod = tlayers.Upsample2D(16, fused_conv=fused)
    p = params["params"]["conv"]
    tmod.load_state_dict({"conv.weight": _oihw(p["kernel"]),
                          "conv.bias": _t(p["bias"])}, strict=True)
    with torch.no_grad():
        got = tmod(_t(x))
    assert got.shape == (2, 10, 12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def test_fused_vae_decoder_matches_jax():
    kw = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
    jvae = JVAE(jcfg.VAEConfig(**kw))
    params = _randomize(jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                                       jnp.zeros((1, 32, 32, 3))), 9)
    z = np.random.default_rng(10).standard_normal((2, 4, 4, 4)).astype(
        np.float32)
    want = jax.jit(functools.partial(j_decode, jvae))(params, jnp.asarray(z))
    tvae_cfg = tcfg.VAEConfig(**kw)
    fused = AutoencoderKL(tvae_cfg, fused_conv=True)
    weights.load_flax_params(fused, params, weights.vae_name_map(tvae_cfg))
    plain = AutoencoderKL(tvae_cfg)
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        got = decode_from_latents(fused, _t(z))
        unfused = decode_from_latents(plain, _t(z))
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    # on the CPU both modes compute one function in other op orders
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), **MODULE_TOL)
