"""Weight bridge: JAX-package (flax) parameter trees -> the port's modules.

The port's modules carry the HF diffusers / reference attribute names, so a
module's `state_dict` keys are the torch names of the name maps below,
copied from `diffcodec_tpu/models/hf_import.py` (`unet_name_map` :145,
`vae_name_map` :182, `controlnet_name_map` :268,
`feature_extractor_name_map` :321) together with the inverse layout
transforms (:477-487, :531-543).  Each entry is (torch name, flax path,
kind), kind one of:
  conv_kernel    flax HWIO <-> torch OIHW
  linear_kernel  flax [in, out] <-> torch [out, in]
  bias / raw     copied as they are

`load_flax_params(module, params, name_map)` turns a flax tree (nested dicts
of numpy arrays, with or without the {'params': ...} wrapper) into the
module's state dict and loads it with `strict=True`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from diffcodec_tpu_torch.config import ControlNetConfig, UNetConfig, VAEConfig

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
    """The decoding half of the JAX package's `vae_name_map`: the decoder
    and post_quant_conv (the encoder's entries come with its port)."""
    out = _conv("decoder.conv_in", ("decoder", "conv_in"))
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


def _inverse_transform(kind: str, value: np.ndarray) -> np.ndarray:
    value = np.asarray(value)
    if kind == "conv_kernel":
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
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


def load_flax_params(module: torch.nn.Module, params: Mapping,
                     name_map: List[Entry]) -> None:
    """Load a flax parameter tree into `module` (strict: every key of the
    module must come from the map and every mapped key must exist)."""
    sd = {k: torch.from_numpy(v)
          for k, v in export_state_dict(params, name_map).items()}
    module.load_state_dict(sd, strict=True)


def load_pipeline_params(pipe, params: Mapping) -> None:
    """{'unet', 'controlnet', 'vae'} flax trees -> a DualFlowPipeline."""
    load_flax_params(pipe.unet, params["unet"], unet_name_map(pipe.unet.cfg))
    load_flax_params(pipe.controlnet, params["controlnet"],
                     controlnet_name_map(pipe.controlnet.cfg))
    load_flax_params(pipe.vae, params["vae"], vae_name_map(pipe.vae.cfg))
