"""The port's checkpoint files against the JAX package's, on the CPU.

  * `utils.safetensors_io` against the `safetensors` library: each reads
    what the other writes (F32, F16, BF16, I64, I32, `__metadata__`),
    bit for bit; a truncated file and an offset out of range raise;
  * an SD-1.5 diffusers root (tiny configs) written by JAX's
    `synthesize_sd_checkpoint_dir` and loaded by both packages' loaders:
    the port's state dicts equal JAX's loaded params bit for bit; one
    written by the port's and loaded by JAX strictly; extra, missing and
    misshapen names as JAX treats them; a `.bin` with a `state_dict`
    wrapper;
  * the auxiliary roots (LPIPS, I3D, the FID-64 prefix, the CMP) written
    by JAX's `synthesize_aux_checkpoints`, loaded by both and run forward
    on the same inputs (fp32: atol 2e-5 of the output's largest
    magnitude, rtol 1e-4); written again by the port's and loaded by
    JAX's to the same values, bit for bit.

JAX's writers and loaders read only the shapes and dtypes of the flax
`init` results they start from (the writers re-randomise every leaf from
a numpy seed, the loaders replace every leaf), so the fixtures run `init`
through `jax.eval_shape` (zeros of its shapes): the files are the same
bytes, without compiling every op of the eager inits (~90 s on one
core).
"""

import contextlib
import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as st
import torch
from safetensors import safe_open

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.eval.inception import InceptionFID64 as JInception
from diffcodec_tpu.models import hf_import
from diffcodec_tpu.models import weights as jweights
from diffcodec_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from diffcodec_tpu.models.cmp import CMP as JCMP
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.i3d import InceptionI3D as JI3D
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.train.lpips import LPIPS as JLPIPS

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights as bridge
from diffcodec_tpu_torch.models import weights
from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.utils import safetensors_io

OUT_RTOL, OUT_ATOL_REL = 1e-4, 2e-5
VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}


def _zeros_of(fn, *args, **kw):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                        jax.eval_shape(fn, *args, **kw))


@contextlib.contextmanager
def _shape_only_init():
    """flax's `Module.init` through `jax.eval_shape` while a JAX writer
    runs (see the module docstring)."""
    orig = nn.Module.init

    def init(self, *args, **kw):
        return _zeros_of(functools.partial(orig, self), *args, **kw)

    nn.Module.init = init
    try:
        yield
    finally:
        nn.Module.init = orig


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        make = lambda *s: (torch.randn(s, generator=g) * 3).to(dtype)
    else:
        make = lambda *s: torch.randint(-2 ** 31, 2 ** 31 - 1, s,
                                        generator=g).to(dtype)
    return {"a.weight": make(3, 5), "b": make(7), "c.d": make(2, 1, 4),
            "scalar": make(), "empty": make(0, 3)}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_reads_what_the_library_writes(tmp_path, name):
    want = _tensors(DTYPES[name])
    want["ids"] = torch.arange(5)  # an I64 beside every dtype
    path = str(tmp_path / "x.safetensors")
    st.save_file(want, path, metadata={"format": "pt", "step": "9"})
    got = safetensors_io.load_file(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert safetensors_io.load_metadata(path) == {"format": "pt",
                                                  "step": "9"}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_library_reads_what_the_port_writes(tmp_path, name):
    want = _tensors(DTYPES[name], 1)
    path = str(tmp_path / "x.safetensors")
    n = safetensors_io.save_file(want, path, metadata={"k": "v"})
    assert n == os.path.getsize(path)
    got = st.load_file(path)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with safe_open(path, "pt") as f:
        assert f.metadata() == {"k": "v"}
    if name != "BF16":  # numpy has no bfloat16
        import safetensors.numpy as sn
        for k, v in sn.load_file(path).items():
            np.testing.assert_array_equal(v, want[k].numpy())


def _library_file(tmp_path):
    path = str(tmp_path / "x.safetensors")
    st.save_file({"a": torch.ones(64), "b": torch.zeros(8)}, path)
    return path


def test_truncated_file_raises(tmp_path):
    path = _library_file(tmp_path)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-4])
    with pytest.raises(ValueError, match="past"):
        safetensors_io.load_file(path)
    with open(path, "wb") as f:
        f.write(data[:12])  # the header itself cut short
    with pytest.raises(ValueError, match="header"):
        safetensors_io.load_file(path)


def test_offset_out_of_range_raises(tmp_path):
    path = _library_file(tmp_path)
    data = open(path, "rb").read()
    n = int.from_bytes(data[:8], "little")
    header = data[8:8 + n].decode()
    # stretch one end offset past the data: same length, same file size
    end = str(64 * 4 + 8 * 4)
    bad = header.replace(end, str(int(end) + 4).rjust(len(end)), 1)
    assert bad != header and len(bad) == len(header)
    with open(path, "wb") as f:
        f.write(data[:8] + bad.encode() + data[8 + n:])
    with pytest.raises(ValueError):
        safetensors_io.load_file(path)


# ---------------------------------------------------------------------------
# SD-1.5 checkpoint roots
# ---------------------------------------------------------------------------

def _port_modules():
    return {"unet": UNet2DConditionModel(tcfg.UNetConfig.tiny()),
            "controlnet": DualFlowControlNet(tcfg.ControlNetConfig.tiny()),
            "vae": AutoencoderKL(tcfg.VAEConfig(**VAE_KW)),
            "text": CLIPTextEncoder(tcfg.CLIPTextConfig.tiny())}


def _jax_templates():
    H, h, L = 64, 8, 8
    z, k = jnp.zeros, jax.random.PRNGKey(0)
    ucfg, ccfg = jcfg.UNetConfig.tiny(), jcfg.ControlNetConfig.tiny()
    clip = jcfg.CLIPTextConfig.tiny()
    D = ucfg.cross_attention_dim
    args = (z((1, h, h, 4)), z((1,), jnp.int32), z((1, L, D)))
    return (
        {"unet": _zeros_of(JUNet(ucfg).init, k, *args),
         "controlnet": _zeros_of(JControlNet(ccfg).init, k, *args,
                                 z((1, H, H, 6)), z((1, H, H, 4))),
         "vae": _zeros_of(JVAE(jcfg.VAEConfig(**VAE_KW)).init, k,
                          z((1, H, H, 3))),
         "text": _zeros_of(JCLIP(clip).init, k,
                           z((1, clip.max_length), jnp.int32))},
        {"unet": ucfg, "controlnet": ccfg,
         "vae": jcfg.VAEConfig(**VAE_KW), "text": clip})


def _port_map(name, module):
    return {"unet": bridge.unet_name_map, "vae": bridge.vae_name_map,
            "controlnet": bridge.controlnet_name_map,
            "text": bridge.clip_text_name_map}[name](module.cfg)


@pytest.fixture(scope="module")
def jax_sd_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sd"))
    with _shape_only_init():
        jweights.synthesize_sd_checkpoint_dir(
            d, jcfg.UNetConfig.tiny(), jcfg.ControlNetConfig.tiny(),
            jcfg.VAEConfig(**VAE_KW), jcfg.CLIPTextConfig.tiny(), seed=3)
    return d


@pytest.fixture(scope="module")
def jax_loaded(jax_sd_dir):
    templates, configs = _jax_templates()
    return jweights.load_sd_checkpoint_dir(jax_sd_dir, templates, configs)


@pytest.mark.parametrize("name", ["unet", "controlnet", "vae", "text"])
def test_sd_dir_written_by_jax_loads_bit_for_bit(jax_sd_dir, jax_loaded,
                                                 name):
    module = _port_modules()[name]
    report = weights.load_sd_checkpoint_dir(jax_sd_dir, {name: module})
    assert report[name]["missing"] == [] and report[name]["unused"] == []
    want = bridge.export_state_dict(jax_loaded[name],
                                    _port_map(name, module))
    got = module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_sd_dir_written_by_port_loads_in_jax(tmp_path):
    modules = _port_modules()
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for m in modules.values():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    n = weights.synthesize_sd_checkpoint_dir(str(tmp_path), modules)
    assert n == sum(os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(tmp_path) for f in fs)
    assert os.path.exists(tmp_path / "text_encoder" / "model.safetensors")
    templates, configs = _jax_templates()
    loaded = jweights.load_sd_checkpoint_dir(str(tmp_path), templates,
                                             configs, strict=True)
    for name, module in modules.items():
        want = module.state_dict()
        got = bridge.export_state_dict(loaded[name],
                                       _port_map(name, module))
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k].numpy(), err_msg=k)


def _edited_vae_dir(src_dir, dst, edit):
    sd = st.load_file(os.path.join(src_dir, "vae",
                                   "diffusion_pytorch_model.safetensors"))
    edit(sd)
    os.makedirs(dst / "vae")
    st.save_file(sd, str(dst / "vae" / "diffusion_pytorch_model.safetensors"))
    return str(dst)


@pytest.mark.parametrize("case", ["extra", "missing", "shape"])
def test_bad_names_as_jax_treats_them(jax_sd_dir, tmp_path, case):
    key = "decoder.conv_out.weight"
    edit = {"extra": lambda sd: sd.update(
                {"text_model.embeddings.position_ids": torch.arange(77)}),
            "missing": lambda sd: sd.pop(key),
            "shape": lambda sd: sd.update({key: sd[key][:2]})}[case]
    d = _edited_vae_dir(jax_sd_dir, tmp_path, edit)
    templates, configs = _jax_templates()
    module = AutoencoderKL(tcfg.VAEConfig(**VAE_KW))

    def port():
        return weights.load_sd_checkpoint_dir(d, {"vae": module})

    def jax_side():
        return jweights.load_sd_checkpoint_dir(
            d, {"vae": templates["vae"]}, configs)

    if case == "extra":
        report = port()
        assert report["vae"]["unused"] == [
            "text_model.embeddings.position_ids"]
        _, _, unused = hf_import.convert_state_dict(
            hf_import.load_torch_state_dict(
                os.path.join(d, "vae", "diffusion_pytorch_model.safetensors")),
            hf_import.vae_name_map(configs["vae"]), templates["vae"])
        assert unused == report["vae"]["unused"]
        jax_side()
    else:
        err = KeyError if case == "missing" else ValueError
        with pytest.raises(err):
            port()
        with pytest.raises(err):
            jax_side()
        if case == "missing":
            report = weights.load_sd_checkpoint_dir(d, {"vae": module},
                                                    strict=False)
            assert report["vae"]["missing"] == [key]


def test_bin_with_state_dict_wrapper_loads(jax_sd_dir, tmp_path):
    sd = st.load_file(os.path.join(jax_sd_dir, "vae",
                                   "diffusion_pytorch_model.safetensors"))
    os.makedirs(tmp_path / "vae")
    torch.save({"state_dict": sd},
               str(tmp_path / "vae" / "diffusion_pytorch_model.bin"))
    assert weights.find_weight_file(str(tmp_path / "vae")).endswith(".bin")
    module = AutoencoderKL(tcfg.VAEConfig(**VAE_KW)).to(torch.bfloat16)
    weights.load_sd_checkpoint_dir(str(tmp_path), {"vae": module})
    got = module.state_dict()
    for k, v in sd.items():
        # cast to the module's dtype, as JAX casts to its template's
        assert torch.equal(got[k], v.to(torch.bfloat16)), k


# ---------------------------------------------------------------------------
# auxiliary networks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _shape_only_aux_templates():
    """JAX's auxiliary templates through `jax.eval_shape` (see the module
    docstring)."""
    orig = jweights._aux_specs

    def specs():
        return {k: (sub, functools.partial(_zeros_of, fn), pm, sm)
                for k, (sub, fn, pm, sm) in orig().items()}

    jweights._aux_specs = specs
    try:
        yield
    finally:
        jweights._aux_specs = orig


@pytest.fixture(scope="module")
def aux(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aux"))
    with _shape_only_aux_templates():
        jweights.synthesize_aux_checkpoints(d, seed=4)
        jvars = jweights.load_aux_checkpoints(d)
    return jvars, weights.load_aux_checkpoints(d, device="cpu")


def test_aux_checkpoints_written_by_port_load_in_jax(aux, tmp_path):
    jvars, modules = aux
    n = weights.synthesize_aux_checkpoints(str(tmp_path), modules)
    assert n == sum(os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(tmp_path) for f in fs)
    with _shape_only_aux_templates():
        back = jweights.load_aux_checkpoints(str(tmp_path))
    for name, want in jvars.items():
        got_leaves = jax.tree.leaves(back[name])
        want_leaves = jax.tree.leaves(want)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(g, w, err_msg=name)


def _aux_inputs(name):
    rng = np.random.default_rng(5)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    if name == "lpips":
        return JLPIPS(), (u(2, 64, 64, 3), u(2, 64, 64, 3))
    if name == "inception":
        return JInception(), (u(2, 299, 299, 3),)
    if name == "i3d":
        return JI3D(), (u(1, 16, 64, 64, 3),)
    image = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    sparse = np.zeros((1, 64, 64, 4), np.float32)
    ys, xs = rng.integers(0, 64, 12), rng.integers(0, 64, 12)
    sparse[0, ys, xs, :2] = rng.uniform(-20, 20, (12, 2))
    sparse[0, ys, xs, 2:] = 1.0
    return JCMP(), (image, sparse)


@pytest.mark.parametrize("name", ["lpips", "inception", "i3d", "cmp"])
def test_aux_checkpoints_load_and_run_as_jax(aux, name):
    jvars, modules = aux
    assert set(jvars) == set(modules) == {"lpips", "inception", "i3d",
                                          "cmp"}
    jmodel, args = _aux_inputs(name)
    want = np.asarray(jax.jit(jmodel.apply)(jvars[name], *args))
    with torch.no_grad():
        got = modules[name](*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL,
                               atol=OUT_ATOL_REL * np.abs(want).max())
