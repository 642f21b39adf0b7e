"""Weight bridge: JAX-package (flax) parameter trees -> the port's modules.

The port's modules carry the HF diffusers / reference attribute names, so a
module's `state_dict` keys are the torch names of the name maps below,
copied from `diffcodec_tpu/models/hf_import.py` (`unet_name_map` :145,
`vae_name_map` :182, `clip_text_name_map` :242, `controlnet_name_map` :268,
`feature_extractor_name_map` :321, `residue_extractor_name_map` :351,
`warp_extractor_name_map` :383, `rescontrolnet_name_map` :404) and from
`diffcodec_tpu/models/cmp.py`
(`cmp_name_map` :338, `cmp_batch_stats_map` :441, every backbone and
decoder), the metric networks' (`lpips_alex_name_map`,
`hf_import.py:422`; `inception64_name_map` and `_batch_stats_map`,
`diffcodec_tpu/eval/inception.py:62-78`; `i3d_name_map` and
`_batch_stats_map`, `diffcodec_tpu/models/i3d.py:115-161`) together with
the inverse layout transforms (:477-487, :531-543), and `unet2d_name_map`
for the residual DDPM's
`diffcodec_tpu/models/unet2d.py::UNet2DModel`, which the JAX package has no
map for (its torch names are diffusers' `UNet2DModel`, the layout of the
reference's residual checkpoint).  Each entry is (torch name, flax path,
kind), kind one of:
  conv_kernel    flax HWIO <-> torch OIHW
  convT_kernel   flax ConvTranspose [kh, kw, out, in] <-> torch
                 ConvTranspose2d [in, out, kh, kw]
  conv3d_kernel  flax THWIO <-> torch OITHW
  linear_kernel  flax [in, out] <-> torch [out, in]
  bias / raw     copied as they are

`load_flax_params(module, params, name_map)` turns a flax tree (nested dicts
of numpy arrays, with or without the {'params': ...} wrapper) into the
module's state dict and loads it with `strict=True`; `load_clip_text_params`
does so for the CLIP text encoder; `load_flax_variables` for a network with
BatchNorm running statistics (the CMP through `load_cmp_params`, the
Inception prefix, I3D).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from diffcodec_tpu_torch.config import (CLIPTextConfig, ControlNetConfig,
                                        UNetConfig, VAEConfig)

Entry = Tuple[str, Tuple[str, ...], str]


def _conv(tname: str, fpath: Sequence[str]) -> List[Entry]:
    fpath = tuple(fpath)
    return [(tname + ".weight", fpath + ("kernel",), "conv_kernel"),
            (tname + ".bias", fpath + ("bias",), "bias")]


def _linear(tname: str, fpath: Sequence[str], bias=True) -> List[Entry]:
    fpath = tuple(fpath)
    out = [(tname + ".weight", fpath + ("kernel",), "linear_kernel")]
    if bias:
        out.append((tname + ".bias", fpath + ("bias",), "bias"))
    return out


def _norm(tname: str, fpath: Sequence[str]) -> List[Entry]:
    fpath = tuple(fpath)
    return [(tname + ".weight", fpath + ("scale",), "raw"),
            (tname + ".bias", fpath + ("bias",), "raw")]


def _gn(tname: str, fpath: Sequence[str]) -> List[Entry]:
    """The JAX GroupNorm32 nests flax's GroupNorm under 'norm'."""
    return _norm(tname, tuple(fpath) + ("norm",))


def _resnet_map(t: str, f: Tuple[str, ...], time_emb=True) -> List[Entry]:
    out = _gn(f"{t}.norm1", f + ("norm1",))
    out += _conv(f"{t}.conv1", f + ("conv1",))
    if time_emb:
        out += _linear(f"{t}.time_emb_proj", f + ("time_emb_proj",))
    out += _gn(f"{t}.norm2", f + ("norm2",))
    out += _conv(f"{t}.conv2", f + ("conv2",))
    return out


def _shortcut_map(t: str, f: Tuple[str, ...]) -> List[Entry]:
    return _conv(f"{t}.conv_shortcut", f + ("conv_shortcut",))


def _attention_map(t: str, f: Tuple[str, ...]) -> List[Entry]:
    out = _linear(f"{t}.to_q", f + ("to_q",), bias=False)
    out += _linear(f"{t}.to_k", f + ("to_k",), bias=False)
    out += _linear(f"{t}.to_v", f + ("to_v",), bias=False)
    out += _linear(f"{t}.to_out.0", f + ("to_out",))
    return out


def _transformer2d_map(t: str, f: Tuple[str, ...], depth: int) -> List[Entry]:
    out = _gn(f"{t}.norm", f + ("norm",))
    out += _conv(f"{t}.proj_in", f + ("proj_in",))
    for d in range(depth):
        tb = f"{t}.transformer_blocks.{d}"
        fb = f + (f"blocks_{d}",)
        out += _norm(f"{tb}.norm1", fb + ("norm1",))
        out += _attention_map(f"{tb}.attn1", fb + ("attn1",))
        out += _norm(f"{tb}.norm2", fb + ("norm2",))
        out += _attention_map(f"{tb}.attn2", fb + ("attn2",))
        out += _norm(f"{tb}.norm3", fb + ("norm3",))
        out += _linear(f"{tb}.ff.net.0.proj", fb + ("ff", "net_0", "proj"))
        out += _linear(f"{tb}.ff.net.2", fb + ("ff", "net_2"))
    out += _conv(f"{t}.proj_out", f + ("proj_out",))
    return out


def _unet_trunk_map(cfg: UNetConfig) -> List[Entry]:
    """conv_in + time embedding + down blocks + mid block."""
    out = _conv("conv_in", ("conv_in",))
    out += _linear("time_embedding.linear_1", ("time_embedding", "linear_1"))
    out += _linear("time_embedding.linear_2", ("time_embedding", "linear_2"))
    prev_ch = cfg.block_out_channels[0]
    for i, ch in enumerate(cfg.block_out_channels):
        fb = (f"down_blocks_{i}",)
        tb = f"down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            f_res = fb + (f"resnets_{j}",)
            out += _resnet_map(f"{tb}.resnets.{j}", f_res)
            if (prev_ch if j == 0 else ch) != ch:
                out += _shortcut_map(f"{tb}.resnets.{j}", f_res)
            if cfg.cross_attention_blocks[i]:
                out += _transformer2d_map(f"{tb}.attentions.{j}",
                                          fb + (f"attentions_{j}",),
                                          cfg.transformer_depth)
        if i < len(cfg.block_out_channels) - 1:
            out += _conv(f"{tb}.downsamplers.0.conv",
                         fb + ("downsample", "conv"))
        prev_ch = ch
    out += _resnet_map("mid_block.resnets.0", ("mid_block", "resnets_0"))
    out += _transformer2d_map("mid_block.attentions.0",
                              ("mid_block", "attentions_0"),
                              cfg.transformer_depth)
    out += _resnet_map("mid_block.resnets.1", ("mid_block", "resnets_1"))
    return out


def unet_name_map(cfg: UNetConfig) -> List[Entry]:
    out = _unet_trunk_map(cfg)
    rev = list(reversed(cfg.block_out_channels))
    rev_attn = list(reversed(cfg.cross_attention_blocks))
    for i, ch in enumerate(rev):
        fb = (f"up_blocks_{i}",)
        tb = f"up_blocks.{i}"
        for j in range(cfg.layers_per_block + 1):
            f_res = fb + (f"resnets_{j}",)
            out += _resnet_map(f"{tb}.resnets.{j}", f_res)
            # up-block resnets concatenate a skip: always a shortcut
            out += _shortcut_map(f"{tb}.resnets.{j}", f_res)
            if rev_attn[i]:
                out += _transformer2d_map(f"{tb}.attentions.{j}",
                                          fb + (f"attentions_{j}",),
                                          cfg.transformer_depth)
        if i < len(rev) - 1:
            out += _conv(f"{tb}.upsamplers.0.conv", fb + ("upsample", "conv"))
    out += _gn("conv_norm_out", ("conv_norm_out",))
    out += _conv("conv_out", ("conv_out",))
    return out


def _vae_attn_map(t: str, f: Tuple[str, ...]) -> List[Entry]:
    out = _gn(f"{t}.group_norm", f + ("group_norm",))
    for proj in ("to_q", "to_k", "to_v"):
        out += _linear(f"{t}.{proj}", f + (proj,))
    out += _linear(f"{t}.to_out.0", f + ("to_out",))
    return out


def vae_name_map(cfg: VAEConfig) -> List[Entry]:
    """The JAX package's `vae_name_map`: the encoder, the decoder,
    quant_conv and post_quant_conv."""
    out = _conv("encoder.conv_in", ("encoder", "conv_in"))
    prev = cfg.base_channels
    for i, mult in enumerate(cfg.channel_mults):
        ch = cfg.base_channels * mult
        for j in range(cfg.layers_per_block):
            f_res = ("encoder", f"down_{i}_resnet_{j}")
            t_res = f"encoder.down_blocks.{i}.resnets.{j}"
            out += _resnet_map(t_res, f_res, time_emb=False)
            if (prev if j == 0 else ch) != ch:
                out += _shortcut_map(t_res, f_res)
        if i < len(cfg.channel_mults) - 1:
            out += _conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                         ("encoder", f"down_{i}_downsample", "conv"))
        prev = ch
    out += _resnet_map("encoder.mid_block.resnets.0",
                       ("encoder", "mid_resnet_0"), time_emb=False)
    out += _vae_attn_map("encoder.mid_block.attentions.0",
                         ("encoder", "mid_attn"))
    out += _resnet_map("encoder.mid_block.resnets.1",
                       ("encoder", "mid_resnet_1"), time_emb=False)
    out += _gn("encoder.conv_norm_out", ("encoder", "conv_norm_out"))
    out += _conv("encoder.conv_out", ("encoder", "conv_out"))
    out += _conv("decoder.conv_in", ("decoder", "conv_in"))
    out += _resnet_map("decoder.mid_block.resnets.0",
                       ("decoder", "mid_resnet_0"), time_emb=False)
    out += _vae_attn_map("decoder.mid_block.attentions.0",
                         ("decoder", "mid_attn"))
    out += _resnet_map("decoder.mid_block.resnets.1",
                       ("decoder", "mid_resnet_1"), time_emb=False)
    rev = list(reversed(cfg.channel_mults))
    prev = cfg.base_channels * rev[0]
    for i, mult in enumerate(rev):
        ch = cfg.base_channels * mult
        for j in range(cfg.layers_per_block + 1):
            f_res = ("decoder", f"up_{i}_resnet_{j}")
            t_res = f"decoder.up_blocks.{i}.resnets.{j}"
            out += _resnet_map(t_res, f_res, time_emb=False)
            if (prev if j == 0 else ch) != ch:
                out += _shortcut_map(t_res, f_res)
        if i < len(rev) - 1:
            out += _conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                         ("decoder", f"up_{i}_upsample", "conv"))
        prev = ch
    out += _gn("decoder.conv_norm_out", ("decoder", "conv_norm_out"))
    out += _conv("decoder.conv_out", ("decoder", "conv_out"))
    out += _conv("quant_conv", ("quant_conv",))
    out += _conv("post_quant_conv", ("post_quant_conv",))
    return out


def controlnet_name_map(cfg: ControlNetConfig) -> List[Entry]:
    """DualFlowControlNet: the ControlNetModel trunk, the zero-conv heads,
    fdn64/32/16/08 and the feature extractor."""
    u = cfg.unet
    out = [(t, ("trunk",) + f, k) for t, f, k in _unet_trunk_map(u)]
    n_heads = 1 + sum(u.layers_per_block + (i < len(u.block_out_channels) - 1)
                      for i in range(len(u.block_out_channels)))
    for k in range(n_heads):
        out += [(f"controlnet_down_blocks.{k}.weight",
                 ("trunk", f"controlnet_down_blocks_{k}", "conv", "kernel"),
                 "conv_kernel"),
                (f"controlnet_down_blocks.{k}.bias",
                 ("trunk", f"controlnet_down_blocks_{k}", "conv", "bias"),
                 "bias")]
    out += [("controlnet_mid_block.weight",
             ("trunk", "controlnet_mid_block", "conv", "kernel"),
             "conv_kernel"),
            ("controlnet_mid_block.bias",
             ("trunk", "controlnet_mid_block", "conv", "bias"), "bias")]
    # the JAX trunk shares one FDN per (level, width); the torch names keep
    # one per level
    n_blocks = len(u.block_out_channels)
    n_levels = len(cfg.inject_channels)
    fdn_torch = ["fdn64", "fdn32", "fdn16", "fdn08"][:n_levels]
    fdn_pairs = [(fdn_torch[0], (0, u.block_out_channels[0]))]
    for i in range(n_blocks):
        lvl = min(i + 1, n_levels - 1)
        fdn_pairs.append((fdn_torch[lvl], (lvl, u.block_out_channels[i])))
    seen = set()
    for t, (lvl, ch) in fdn_pairs:
        if (lvl, ch) in seen:
            continue
        seen.add((lvl, ch))
        f = ("trunk", f"fdn_{lvl}_{ch}")
        out += _conv(f"{t}.conv_gamma", f + ("conv_gamma",))
        out += _conv(f"{t}.conv_beta", f + ("conv_beta",))
    out += feature_extractor_name_map(cfg.inject_channels,
                                      torch_prefix="feature_extractor.",
                                      flax_prefix=("feature_extractor",))
    return out


def feature_extractor_name_map(inject_channels: Sequence[int],
                               torch_prefix: str = "",
                               flax_prefix: Tuple[str, ...] = ()
                               ) -> List[Entry]:
    """Bi_Dir_FeatureExtractor names -> the JAX BiDirFeatureExtractor."""
    out: List[Entry] = []
    fe, tp = tuple(flax_prefix), torch_prefix
    for side, torch_side in (("first_pre", "first_pre_extractor"),
                             ("last_pre", "last_pre_extractor")):
        for k, torch_idx in enumerate((0, 2, 4, 6, 8)):
            out += _conv(f"{tp}{torch_side}.{torch_idx}",
                         fe + (f"{side}_{k}",))
    for idx in range(len(inject_channels)):
        out += _conv(f"{tp}extractors_first.{idx}.0",
                     fe + (f"extractor_first_{idx}",))
        out += _conv(f"{tp}extractors_last.{idx}.0",
                     fe + (f"extractor_last_{idx}",))
        out += _conv(f"{tp}wrapper.{idx}.metric_net.0",
                     fe + (f"warper_{idx}", "metric_0"))
        out += _conv(f"{tp}wrapper.{idx}.metric_net.2",
                     fe + (f"warper_{idx}", "metric_2"))
        out += _conv(f"{tp}zero_convs.{idx}",
                     fe + (f"zero_conv_{idx}", "conv"))
    return out


def residue_extractor_name_map(inject_channels: Sequence[int],
                               torch_prefix: str = "",
                               flax_prefix: Tuple[str, ...] = ()
                               ) -> List[Entry]:
    """Bi_Dir_ResidueExtractor names -> the JAX BiDirResidueExtractor.  The
    reference's flow_feature_encoders are declared but never used; neither
    model has them."""
    out: List[Entry] = []
    fe, tp = tuple(flax_prefix), torch_prefix
    for side in ("prev", "next"):
        for k, torch_idx in enumerate((0, 2, 4)):
            out += _conv(f"{tp}{side}_pre.{torch_idx}",
                         fe + (f"{side}_pre_{k}",))
    for idx in range(len(inject_channels)):
        out += _conv(f"{tp}prev_pyramids.{idx}.0",
                     fe + (f"prev_pyramid_{idx}",))
        out += _conv(f"{tp}next_pyramids.{idx}.0",
                     fe + (f"next_pyramid_{idx}",))
        out += _conv(f"{tp}flow_refiners.{idx}",
                     fe + (f"flow_refiner_{idx}",))
        out += _conv(f"{tp}warpers.{idx}.metric_net.0",
                     fe + (f"warper_{idx}", "metric_0"))
        out += _conv(f"{tp}warpers.{idx}.metric_net.2",
                     fe + (f"warper_{idx}", "metric_2"))
        out += _conv(f"{tp}zero_convs.{idx}",
                     fe + (f"zero_conv_{idx}", "conv"))
    return out


def warp_extractor_name_map(inject_channels: Sequence[int],
                            torch_prefix: str = "",
                            flax_prefix: Tuple[str, ...] = ()
                            ) -> List[Entry]:
    """WarpExtractor names (enc1..enc5 ConvBlocks and the zero convs) ->
    the JAX WarpExtractor."""
    out: List[Entry] = []
    fe, tp = tuple(flax_prefix), torch_prefix
    names = [("enc1", ("enc1",))] + [
        (f"enc{i + 2}", (f"enc_{i + 2}",))
        for i in range(len(inject_channels))]
    for tname, fname in names:
        out += _conv(f"{tp}{tname}.block.0", fe + fname + ("conv1",))
        out += _conv(f"{tp}{tname}.block.2", fe + fname + ("conv2",))
    for idx in range(len(inject_channels)):
        out += _conv(f"{tp}zero_convs.{idx}",
                     fe + (f"zero_conv_{idx}", "conv"))
    return out


def rescontrolnet_name_map(cfg: ControlNetConfig) -> List[Entry]:
    """ResControlNet: the DualFlow map's trunk, heads and FDNs, with the
    residue and warp extractors in place of the feature extractor."""
    out = [e for e in controlnet_name_map(cfg)
           if not e[0].startswith("feature_extractor.")]
    out += residue_extractor_name_map(
        cfg.inject_channels, torch_prefix="feature_extractor.",
        flax_prefix=("feature_extractor",))
    out += warp_extractor_name_map(
        cfg.inject_channels, torch_prefix="warp_extractor.",
        flax_prefix=("warp_extractor",))
    return out


def clip_text_name_map(cfg: CLIPTextConfig) -> List[Entry]:
    """HF CLIPTextModel names -> the JAX CLIPTextEncoder."""
    p = "text_model"
    out: List[Entry] = [
        (f"{p}.embeddings.token_embedding.weight",
         ("token_embedding", "embedding"), "raw"),
        (f"{p}.embeddings.position_embedding.weight",
         ("position_embedding",), "raw"),
    ]
    for i in range(cfg.layers):
        t = f"{p}.encoder.layers.{i}"
        f = (f"layers_{i}",)
        out += _norm(f"{t}.layer_norm1", f + ("layer_norm1",))
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _linear(f"{t}.self_attn.{proj}", f + ("self_attn", proj))
        out += _norm(f"{t}.layer_norm2", f + ("layer_norm2",))
        out += _linear(f"{t}.mlp.fc1", f + ("fc1",))
        out += _linear(f"{t}.mlp.fc2", f + ("fc2",))
    out += _norm(f"{p}.final_layer_norm", ("final_layer_norm",))
    return out


def unet2d_name_map(block_out_channels: Sequence[int] = (64, 128, 128, 256),
                    layers_per_block: int = 2,
                    attn_blocks: Sequence[bool] = (False, False, True, True)
                    ) -> List[Entry]:
    """diffusers UNet2DModel names -> the JAX `UNet2DModel` (the residual
    DDPM): flax's `down_{i}_res_{j}`, `down_{i}_attn_{j}`,
    `down_{i}_downsample`, `mid_res_{0,1}`, `mid_attn`, `up_{i}_res_{j}`,
    `up_{i}_attn_{j}`, `up_{i}_upsample`, `conv_norm_out`, `conv_out`."""
    out = _conv("conv_in", ("conv_in",))
    out += _linear("time_embedding.linear_1", ("time_embedding", "linear_1"))
    out += _linear("time_embedding.linear_2", ("time_embedding", "linear_2"))
    chans = list(block_out_channels)
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(layers_per_block):
            f, t = (f"down_{i}_res_{j}",), f"down_blocks.{i}.resnets.{j}"
            out += _resnet_map(t, f)
            if (prev if j == 0 else ch) != ch:
                out += _shortcut_map(t, f)
            if attn_blocks[i]:
                out += _vae_attn_map(f"down_blocks.{i}.attentions.{j}",
                                     (f"down_{i}_attn_{j}",))
        if i < len(chans) - 1:
            out += _conv(f"down_blocks.{i}.downsamplers.0.conv",
                         (f"down_{i}_downsample", "conv"))
        prev = ch
    out += _resnet_map("mid_block.resnets.0", ("mid_res_0",))
    out += _vae_attn_map("mid_block.attentions.0", ("mid_attn",))
    out += _resnet_map("mid_block.resnets.1", ("mid_res_1",))
    rev_attn = list(reversed(attn_blocks))
    for i, ch in enumerate(reversed(chans)):
        for j in range(layers_per_block + 1):
            f, t = (f"up_{i}_res_{j}",), f"up_blocks.{i}.resnets.{j}"
            # the skip is concatenated: always a shortcut
            out += _resnet_map(t, f) + _shortcut_map(t, f)
            if rev_attn[i]:
                out += _vae_attn_map(f"up_blocks.{i}.attentions.{j}",
                                     (f"up_{i}_attn_{j}",))
        if i < len(chans) - 1:
            out += _conv(f"up_blocks.{i}.upsamplers.0.conv",
                         (f"up_{i}_upsample", "conv"))
    out += _gn("conv_norm_out", ("conv_norm_out",))
    out += _conv("conv_out", ("conv_out",))
    return out


def _transform(kind: str, value: np.ndarray) -> np.ndarray:
    """torch layout -> flax (`hf_import._transform`)."""
    value = np.asarray(value)
    if kind in ("conv_kernel", "convT_kernel"):
        # OIHW -> HWIO; ConvTranspose2d [in, out, kh, kw] -> flax's
        # ConvTranspose (transpose_kernel=True) [kh, kw, out, in]
        return value.transpose(2, 3, 1, 0)
    if kind == "conv3d_kernel":
        return value.transpose(2, 3, 4, 1, 0)  # OITHW -> THWIO
    if kind == "linear_kernel":
        return value.T
    return value


def _inverse_transform(kind: str, value: np.ndarray) -> np.ndarray:
    value = np.asarray(value)
    if kind in ("conv_kernel", "convT_kernel"):
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW, and convT's
    if kind == "conv3d_kernel":
        return value.transpose(4, 3, 0, 1, 2)  # THWIO -> OITHW
    if kind == "linear_kernel":
        return value.T
    return value


def export_state_dict(params: Mapping, name_map: List[Entry]
                      ) -> Dict[str, np.ndarray]:
    """flax params -> torch-layout numpy state dict."""
    wrapped = "params" in params and isinstance(params["params"], Mapping)
    root = params["params"] if wrapped else params
    out = {}
    for tname, fpath, kind in name_map:
        node = root
        for p in fpath:
            node = node[p]
        out[tname] = np.ascontiguousarray(_inverse_transform(kind, node))
    return out


def import_state_dict(state_dict: Mapping, name_map: List[Entry]) -> Dict:
    """torch-layout state dict -> a nested flax tree (numpy) of the map's
    paths: `export_state_dict`'s inverse."""
    out: Dict = {}
    for tname, fpath, kind in name_map:
        node = out
        for p in fpath[:-1]:
            node = node.setdefault(p, {})
        value = state_dict[tname]
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        node[fpath[-1]] = np.ascontiguousarray(_transform(kind, value))
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping,
                     name_map: List[Entry]) -> None:
    """Load a flax parameter tree into `module` (strict: every key of the
    module must come from the map and every mapped key must exist)."""
    sd = {k: torch.from_numpy(v)
          for k, v in export_state_dict(params, name_map).items()}
    module.load_state_dict(sd, strict=True)


def load_clip_text_params(module: torch.nn.Module, params: Mapping) -> None:
    """Load a JAX CLIPTextEncoder's parameters into the port's
    `models.clip_text.CLIPTextEncoder` (strict)."""
    load_flax_params(module, params, clip_text_name_map(module.cfg))


def load_pipeline_params(pipe, params: Mapping) -> None:
    """{'unet', 'controlnet', 'vae'} flax trees -> a DualFlowPipeline."""
    load_flax_params(pipe.unet, params["unet"], unet_name_map(pipe.unet.cfg))
    load_flax_params(pipe.controlnet, params["controlnet"],
                     controlnet_name_map(pipe.controlnet.cfg))
    load_flax_params(pipe.vae, params["vae"], vae_name_map(pipe.vae.cfg))


def cmp_name_map(nbins: int = 99, backbone: str = "resnet50",
                 decoder: str = "skip", combo: Sequence[int] = (1, 2, 4)
                 ) -> List[Entry]:
    """The JAX package's `cmp_name_map`, entry for entry: the torch CMP's
    names (image_encoder / flow_encoder / flow_decoder) -> the flax CMP's
    parameter paths, for every backbone (resnet50, the AlexNet FCNs) and
    decoder (skip, plain over `combo`, flownet).  The running statistics
    are in `cmp_batch_stats_map`."""
    del nbins  # the names do not depend on it
    out: List[Entry] = []

    def conv(t, f, bias=True):  # a ConvBNRelu's conv, nested under 'conv'
        out.append((f"{t}.weight", f + ("conv", "kernel"), "conv_kernel"))
        if bias:
            out.append((f"{t}.bias", f + ("conv", "bias"), "bias"))

    def bn(t, f):
        out.extend(_norm(t, f + ("bn",)))

    def bare(t, f, bias=True, kind="conv_kernel"):
        out.append((f"{t}.weight", f + ("kernel",), kind))
        if bias:
            out.append((f"{t}.bias", f + ("bias",), "bias"))

    ie, fe, fd = "image_encoder", "flow_encoder", "flow_decoder"
    if backbone == "resnet50":
        out.append((f"{ie}.conv1.weight", (ie, "conv1", "kernel"),
                    "conv_kernel"))
        out.extend(_norm(f"{ie}.bn1", (ie, "bn1")))
        for t, b, f in _cmp_resnet_blocks():
            for c in ("conv1", "conv2", "conv3"):
                conv(f"{t}.{c}", f + (c,), bias=False)
                bn(f"{t}.bn{c[-1]}", f + (c,))
            if b == 0:
                conv(f"{t}.downsample.0", f + ("downsample",), bias=False)
                bn(f"{t}.downsample.1", f + ("downsample",))
        bare(f"{ie}.conv5", (ie, "conv5"))
    else:  # the AlexNet FCN: Sequentials with conv at .0, BatchNorm at .1
        for name in _CMP_ALEXNET:
            conv(f"{ie}.{name}.0", (ie, name))
            bn(f"{ie}.{name}.1", (ie, name))
        bare(f"{ie}.conv8", (ie, "conv8"))
    # ShallowNet's Sequential: conv 0 / BatchNorm 1, conv 4 / BatchNorm 5
    for conv_i, bn_i, name in ((0, 1, "conv1"), (4, 5, "conv2")):
        conv(f"{fe}.features.{conv_i}", (fe, name))
        bn(f"{fe}.features.{bn_i}", (fe, name))
    if decoder == "plain":
        for t_conv, t_bn, f in _cmp_branch_convs(combo, 2):
            conv(t_conv, f)
            bn(t_bn, f)
        bare(f"{fd}.head", (fd, "head"))
        return out
    for t_conv, t_bn, f in _cmp_branch_convs((1, 2, 4, 8), 3):
        conv(t_conv, f)
        bn(t_bn, f)
    if decoder == "flownet":
        conv(f"{fd}.fusion8.0", (fd, "fusion8"))
        bn(f"{fd}.fusion8.1", (fd, "fusion8"))
        for s in (8, 4, 2, 1):
            bare(f"{fd}.predict_flow{s}", (fd, f"predict_flow{s}"))
        for s, d in ((8, 4), (4, 2), (2, 1)):
            bare(f"{fd}.upsampled_flow{s}_to_{d}",
                 (fd, f"upsampled_flow{s}_to_{d}"), bias=False,
                 kind="convT_kernel")
        for s in (8, 4, 2):
            bare(f"{fd}.deconv{s}.0", (fd, f"deconv{s}"),
                 kind="convT_kernel")
        return out
    for name in _CMP_SKIP_CONVS:
        conv(f"{fd}.{name}.0", (fd, name))
        bn(f"{fd}.{name}.1", (fd, name))
    bare(f"{fd}.head", (fd, "head"))
    return out


def cmp_batch_stats_map(nbins: int = 99, backbone: str = "resnet50",
                        decoder: str = "skip",
                        combo: Sequence[int] = (1, 2, 4)) -> List[Entry]:
    """BatchNorm running_mean / running_var -> the flax 'batch_stats'
    collection, for the same variants as `cmp_name_map`, entry for entry
    as the JAX package's."""
    del nbins
    out: List[Entry] = []

    def bn(t, f):
        out.extend([(f"{t}.running_mean", f + ("bn", "mean"), "raw"),
                    (f"{t}.running_var", f + ("bn", "var"), "raw")])

    ie, fe, fd = "image_encoder", "flow_encoder", "flow_decoder"
    if backbone == "resnet50":
        out += [(f"{ie}.bn1.running_mean", (ie, "bn1", "mean"), "raw"),
                (f"{ie}.bn1.running_var", (ie, "bn1", "var"), "raw")]
        for t, b, f in _cmp_resnet_blocks():
            for c in ("conv1", "conv2", "conv3"):
                bn(f"{t}.bn{c[-1]}", f + (c,))
            if b == 0:
                bn(f"{t}.downsample.1", f + ("downsample",))
    else:
        for name in _CMP_ALEXNET:
            bn(f"{ie}.{name}.1", (ie, name))
    bn(f"{fe}.features.1", (fe, "conv1"))
    bn(f"{fe}.features.5", (fe, "conv2"))
    if decoder == "plain":
        for _, t_bn, f in _cmp_branch_convs(combo, 2):
            bn(t_bn, f)
        return out
    for _, t_bn, f in _cmp_branch_convs((1, 2, 4, 8), 3):
        bn(t_bn, f)
    for name in (("fusion8",) if decoder == "flownet" else _CMP_SKIP_CONVS):
        bn(f"{fd}.{name}.1", (fd, name))
    return out


_CMP_ALEXNET = ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7")
_CMP_SKIP_CONVS = ("fusion8", "skipconv4", "fusion4", "skipconv2", "fusion2")


def _cmp_resnet_blocks():
    """(torch prefix, block index, flax path) of every bottleneck of the
    ResNet-50."""
    for li, blocks in ((1, 3), (2, 4), (3, 6), (4, 3)):
        for b in range(blocks):
            yield (f"image_encoder.layer{li}.{b}", b,
                   ("image_encoder", f"layer{li}_{b}"))


def _cmp_branch_convs(pools, n_convs: int):
    """(torch prefix of the conv, of its BatchNorm, flax path) of every
    conv+BN+ReLU of the decoder branches `decoder{p}`: each Sequential
    holds conv, BatchNorm and ReLU `n_convs` times, after a leading
    MaxPool in the pooled ones."""
    fd = "flow_decoder"
    for p in pools:
        base = 0 if p == 1 else 1
        for i in range(n_convs):
            yield (f"{fd}.decoder{p}.{base + 3 * i}",
                   f"{fd}.decoder{p}.{base + 3 * i + 1}",
                   (fd, f"decoder{p}_{i}"))


def load_flax_variables(module: torch.nn.Module, variables: Mapping,
                        params_map: List[Entry],
                        stats_map: List[Entry]) -> None:
    """Load flax variables ({'params', 'batch_stats'}) into a module with
    BatchNorm layers, strictly.  BatchNorm's `num_batches_tracked` (a
    training counter flax does not keep) is set to 0."""
    sd = export_state_dict(variables["params"], params_map)
    sd.update(export_state_dict(variables["batch_stats"], stats_map))
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k[:-len("running_mean")] + "num_batches_tracked"] = torch.zeros(
            (), dtype=torch.long)
    module.load_state_dict(sd, strict=True)


def cmp_maps(module: torch.nn.Module) -> Tuple[List[Entry], List[Entry]]:
    """(`cmp_name_map`, `cmp_batch_stats_map`) of a port `models.cmp.CMP`'s
    variant."""
    variant = (module.nbins, module.backbone, module.decoder, module.combo)
    return cmp_name_map(*variant), cmp_batch_stats_map(*variant)


def load_cmp_params(module: torch.nn.Module, variables: Mapping) -> None:
    """Load a flax CMP's variables into the port's `models.cmp.CMP`, any
    variant."""
    load_flax_variables(module, variables, *cmp_maps(module))


def lpips_alex_name_map() -> List[Entry]:
    """torch `lpips.LPIPS(net='alex')` names -> the JAX LPIPS: the AlexNet
    convs at net.slice{1..5}.<index>, the 1x1 lins at lin{k}.model.1."""
    out: List[Entry] = []
    for t, f in (("net.slice1.0", "conv1"), ("net.slice2.3", "conv2"),
                 ("net.slice3.6", "conv3"), ("net.slice4.8", "conv4"),
                 ("net.slice5.10", "conv5")):
        out += _conv(t, ("net", f))
    for k in range(5):
        out.append((f"lin{k}.model.1.weight", (f"lin{k}", "kernel"),
                    "conv_kernel"))
    return out


_INCEPTION64_CONVS = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3")


def inception64_name_map() -> List[Entry]:
    """InceptionV3's FID-64 prefix (torchvision / pytorch-fid names)."""
    out: List[Entry] = []
    for name in _INCEPTION64_CONVS:
        out.append((f"{name}.conv.weight", (name, "conv", "kernel"),
                    "conv_kernel"))
        out += _norm(f"{name}.bn", (name, "bn"))
    return out


def inception64_batch_stats_map() -> List[Entry]:
    out: List[Entry] = []
    for name in _INCEPTION64_CONVS:
        out.append((f"{name}.bn.running_mean", (name, "bn", "mean"), "raw"))
        out.append((f"{name}.bn.running_var", (name, "bn", "var"), "raw"))
    return out


# I3D's Unit3D blocks: the stem, then each inception block's six branches
_I3D_BLOCKS = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d",
               "Mixed_4e", "Mixed_4f", "Mixed_5b", "Mixed_5c")
_I3D_BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")


def _i3d_units():
    for name in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        yield name, (name,)
    for block in _I3D_BLOCKS:
        for branch in _I3D_BRANCHES:
            yield f"{block}.{branch}", (block, branch)


def i3d_name_map() -> List[Entry]:
    """The vendored torch InceptionI3d's names (`<unit>.conv3d.weight`,
    `<unit>.bn.{weight,bias}`; the logits conv with a bias, no BatchNorm)
    -> the JAX InceptionI3D."""
    out: List[Entry] = []
    for t, f in _i3d_units():
        out.append((f"{t}.conv3d.weight", f + ("conv3d", "kernel"),
                    "conv3d_kernel"))
        out += _norm(f"{t}.bn", f + ("bn",))
    out += [("logits.conv3d.weight", ("logits", "conv3d", "kernel"),
             "conv3d_kernel"),
            ("logits.conv3d.bias", ("logits", "conv3d", "bias"), "raw")]
    return out


def i3d_batch_stats_map() -> List[Entry]:
    out: List[Entry] = []
    for t, f in _i3d_units():
        out.append((f"{t}.bn.running_mean", f + ("bn", "mean"), "raw"))
        out.append((f"{t}.bn.running_var", f + ("bn", "var"), "raw"))
    return out
