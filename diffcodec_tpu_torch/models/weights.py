"""Checkpoint directories on disk: the weights-readiness path.

Counterpart: `diffcodec_tpu/models/weights.py` (`find_weight_file` :33,
`load_sd_checkpoint_dir` :41, `load_aux_checkpoints` :125,
`synthesize_aux_checkpoints` :160, `synthesize_sd_checkpoint_dir` :191)
and `diffcodec_tpu/models/hf_import.py` (`load_torch_state_dict` :442,
`convert_state_dict` :490).  The top-level `diffcodec_tpu_torch/weights.py`
is the bridge from the JAX package's parameter trees; this module reads
and writes torch-layout checkpoint files, with no JAX in between.

Layouts: an SD-1.5 diffusers root with `unet/`, `vae/`, `text_encoder/`
and optionally `controlnet/` (or a DualFlowControlNet state dict given
apart, a trained `checkpoint-N` safetensors file), and an auxiliary root
with `lpips/`, `i3d/`, `inception/` and `cmp/`, each holding one of
`_WEIGHT_NAMES`.  The port's modules carry the torch names, so a file's
tensors are copied straight into them, with `convert_state_dict`'s rules:
a name of the module's map missing from the file raises `KeyError` under
`strict` (after all names were tried), a shape mismatch raises
`ValueError`, names the map does not name are returned as unused (a real
CLIP file carries `text_model.embeddings.position_ids`), and each tensor
is cast to its parameter's dtype and copied onto its device.

Safetensors files go through `utils.safetensors_io` (the card's machine has
no `safetensors` package); `.bin` files through `torch.load(weights_only=
True)`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from diffcodec_tpu_torch import weights as bridge
from diffcodec_tpu_torch.models.controlnet import ResControlNet
from diffcodec_tpu_torch.utils import safetensors_io

# diffusers save_pretrained weight filenames, in preference order
_WEIGHT_NAMES = ("diffusion_pytorch_model.safetensors",
                 "model.safetensors",
                 "diffusion_pytorch_model.bin",
                 "pytorch_model.bin")


def find_weight_file(subdir: str) -> Optional[str]:
    for name in _WEIGHT_NAMES:
        path = os.path.join(subdir, name)
        if os.path.exists(path):
            return path
    return None


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file (tensors mapped from the file, no host copy)
    or a `torch.save` file (a `state_dict` wrapper unwrapped) -> {name:
    CPU tensor}."""
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def _controlnet_map(module):
    return (bridge.rescontrolnet_name_map if isinstance(module, ResControlNet)
            else bridge.controlnet_name_map)(module.cfg)


def networks() -> Dict[str, Tuple[str, Optional[Callable[[], torch.nn.Module]],
                                  Callable[[torch.nn.Module], list]]]:
    """{name: (subdirectory, constructor, name map)} of every network a
    checkpoint directory holds: the SD-1.5 modules (no constructor: the
    caller builds them at its config) and the auxiliary ones, LPIPS-alex
    (the perceptual metric and training loss), I3D (FVD), the InceptionV3
    FID-64 prefix and the CMP (sparse -> dense flow at decode).  The name
    map gives the module its `(torch name, flax path, kind)` entries."""
    from diffcodec_tpu_torch.eval.inception import InceptionFID64
    from diffcodec_tpu_torch.models.cmp import CMP
    from diffcodec_tpu_torch.models.i3d import InceptionI3D
    from diffcodec_tpu_torch.train.lpips import LPIPS
    return {
        "unet": ("unet", None, lambda m: bridge.unet_name_map(m.cfg)),
        "controlnet": ("controlnet", None, _controlnet_map),
        "vae": ("vae", None, lambda m: bridge.vae_name_map(m.cfg)),
        "text": ("text_encoder", None,
                 lambda m: bridge.clip_text_name_map(m.cfg)),
        "lpips": ("lpips", LPIPS, lambda m: bridge.lpips_alex_name_map()),
        "i3d": ("i3d", InceptionI3D, lambda m: bridge.i3d_name_map()
                + bridge.i3d_batch_stats_map()),
        "inception": ("inception", InceptionFID64,
                      lambda m: bridge.inception64_name_map()
                      + bridge.inception64_batch_stats_map()),
        "cmp": ("cmp", CMP, lambda m: bridge.cmp_name_map()
                + bridge.cmp_batch_stats_map()),
    }


def module_names(name: str, module: torch.nn.Module) -> List[str]:
    """The torch names that `name`'s map gives `module` (a network of
    `networks()`)."""
    table = networks()
    if name not in table:
        raise ValueError(f"no name map for {name!r}")
    return [t for t, _, _ in table[name][2](module)]


@torch.no_grad()
def load_state_dict_into(module: torch.nn.Module,
                         state_dict: Mapping[str, torch.Tensor],
                         names: List[str], strict: bool = True):
    """Copy `state_dict[n]` into the module's tensor `n` for each of
    `names`, cast to its dtype on its device.  Returns (missing, unused):
    the names absent from the file (a `KeyError` under `strict`) and the
    file's names outside `names`.  A shape mismatch raises `ValueError`."""
    own = module.state_dict(keep_vars=True)
    missing, used = [], set()
    for n in names:
        if n not in state_dict:
            missing.append(n)
            continue
        if n not in own:
            raise KeyError(f"module has no tensor {n}")
        src, dst = state_dict[n], own[n]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch for {n}: {tuple(src.shape)} "
                             f"vs module {tuple(dst.shape)}")
        dst.copy_(src)
        used.add(n)
    if strict and missing:
        raise KeyError(f"missing {len(missing)} torch params, first: "
                       f"{missing[:5]}")
    return missing, [k for k in state_dict if k not in used]


def load_sd_checkpoint_dir(sd_dir: str, modules: Mapping[str, torch.nn.Module],
                           controlnet_path: Optional[str] = None,
                           strict: bool = True) -> Dict[str, Dict]:
    """Fill the port's SD-1.5 modules from a diffusers root.

    modules: any of {'unet': UNet2DConditionModel, 'controlnet':
    DualFlowControlNet or ResControlNet, 'vae': AutoencoderKL, 'text':
    CLIPTextEncoder}, filled in place on their devices in their dtypes.
    controlnet_path overrides the `controlnet/` subfolder.  A module with
    no weight file raises `FileNotFoundError` under `strict` and is
    skipped otherwise.  Returns {name: {'path', 'missing', 'unused'}} for
    every module filled."""
    out, table = {}, networks()
    for name, module in modules.items():
        sub = table[name][0]
        if name == "controlnet" and controlnet_path:
            path = controlnet_path
        else:
            path = find_weight_file(os.path.join(sd_dir, sub))
        if path is None:
            if strict:
                raise FileNotFoundError(
                    f"no weight file for '{name}' under {sd_dir}/{sub} "
                    f"(expected one of {_WEIGHT_NAMES})")
            continue
        missing, unused = load_state_dict_into(
            module, load_torch_state_dict(path), module_names(name, module),
            strict)
        out[name] = dict(path=path, missing=missing, unused=unused)
    return out


def _state_dict_of(name: str, module: torch.nn.Module
                   ) -> Dict[str, torch.Tensor]:
    own = module.state_dict()
    return {n: own[n] for n in module_names(name, module)}


def _write_dir(out_dir: str, modules: Mapping[str, torch.nn.Module]
               ) -> int:
    """Each module's weights under the names of its map, in the dtype each
    tensor holds, as `<subdirectory>/<file>` of `networks()`:
    `model.safetensors` for the text tower, `diffusion_pytorch_model.
    safetensors` for the others.  Returns the bytes written."""
    total, table = 0, networks()
    for name, module in modules.items():
        sub = os.path.join(out_dir, table[name][0])
        os.makedirs(sub, exist_ok=True)
        fname = ("model.safetensors" if name == "text"
                 else "diffusion_pytorch_model.safetensors")
        total += safetensors_io.save_file(_state_dict_of(name, module),
                                          os.path.join(sub, fname))
    return total


def synthesize_sd_checkpoint_dir(out_dir: str,
                                 modules: Mapping[str, torch.nn.Module]
                                 ) -> int:
    """Write SD-1.5 modules (`load_sd_checkpoint_dir`'s names) as a
    diffusers root.  Returns the bytes written."""
    return _write_dir(out_dir, modules)


def load_aux_checkpoints(root: str, strict: bool = True, device="cuda"
                         ) -> Dict[str, torch.nn.Module]:
    """Load `{root}/{lpips,i3d,inception,cmp}/<weight file>` into fresh
    fp32 networks on `device`, each returned in eval mode.  A network with
    no file raises under `strict` and is left out otherwise, so a partial
    set enables the metrics it covers."""
    out = {}
    for name, (sub, ctor, _) in networks().items():
        if ctor is None:
            continue
        path = find_weight_file(os.path.join(root, sub))
        if path is None:
            if strict:
                raise FileNotFoundError(
                    f"no weight file for '{name}' under {root}/{sub}")
            continue
        with torch.device(device):
            module = ctor()
        load_state_dict_into(module, load_torch_state_dict(path),
                             module_names(name, module), strict)
        out[name] = module.eval()
    return out


def synthesize_aux_checkpoints(out_dir: str,
                               modules: Mapping[str, torch.nn.Module]
                               ) -> int:
    """Write the auxiliary networks ({name: module}, names of `networks()`
    with a constructor) as an auxiliary root, running statistics included.
    Returns the bytes written."""
    return _write_dir(out_dir, modules)
