"""Weight bridge: JAX-package (flax) parameter trees -> the port's modules.

The port's modules carry the HF diffusers / reference attribute names, so a
module's `state_dict` keys are the torch names of the name maps below,
copied from `diffcodec_tpu/models/hf_import.py` (`unet_name_map` :145,
`vae_name_map` :182, `clip_text_name_map` :242, `controlnet_name_map` :268,
`feature_extractor_name_map` :321, `residue_extractor_name_map` :351,
`warp_extractor_name_map` :383, `rescontrolnet_name_map` :404) and from
`diffcodec_tpu/models/cmp.py`
(`cmp_name_map` :338, `cmp_batch_stats_map` :441, DiffCodec's resnet50 +
skip configuration), the metric networks' (`lpips_alex_name_map`,
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


def _inverse_transform(kind: str, value: np.ndarray) -> np.ndarray:
    value = np.asarray(value)
    if kind == "conv_kernel":
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
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


def _cmp_bn(t: str, f: Tuple[str, ...]) -> List[Entry]:
    return _norm(t, f + ("bn",))


def _cmp_conv(t: str, f: Tuple[str, ...], bias: bool = True) -> List[Entry]:
    """A ConvBNRelu's conv: flax nests it under 'conv'."""
    if bias:
        return _conv(t, f + ("conv",))
    return [(t + ".weight", f + ("conv", "kernel"), "conv_kernel")]


def _cmp_resnet_blocks():
    """(torch prefix, flax path) of every bottleneck of the ResNet-50."""
    for li, blocks in ((1, 3), (2, 4), (3, 6), (4, 3)):
        for b in range(blocks):
            yield (f"image_encoder.layer{li}.{b}", b,
                   ("image_encoder", f"layer{li}_{b}"))


def _cmp_decoder_convs():
    """(torch prefix of the conv, of its BatchNorm, flax path) of every
    ConvBNRelu of the skip decoder: the branches' Sequentials hold conv,
    BatchNorm and ReLU three times, after a leading MaxPool in the pooled
    ones; the fusion and skip convs are ConvBNRelus of their own."""
    fd = "flow_decoder"
    for name, base in (("decoder1", 0), ("decoder2", 1), ("decoder4", 1),
                       ("decoder8", 1)):
        for i in range(3):
            yield (f"{fd}.{name}.{base + 3 * i}",
                   f"{fd}.{name}.{base + 3 * i + 1}", (fd, f"{name}_{i}"))
    for name in ("fusion8", "skipconv4", "fusion4", "skipconv2", "fusion2"):
        yield f"{fd}.{name}.0", f"{fd}.{name}.1", (fd, name)


def cmp_name_map() -> List[Entry]:
    """The JAX package's `cmp_name_map()` for DiffCodec's CMP (resnet50
    backbone, skip decoder): torch checkpoint names -> flax paths of the
    parameters.  The running statistics are in `cmp_batch_stats_map`."""
    ie = ("image_encoder",)
    out: List[Entry] = [
        ("image_encoder.conv1.weight", ie + ("conv1", "kernel"),
         "conv_kernel")]
    out += _norm("image_encoder.bn1", ie + ("bn1",))
    for t, b, f in _cmp_resnet_blocks():
        for c in ("conv1", "conv2", "conv3"):
            out += _cmp_conv(f"{t}.{c}", f + (c,), bias=False)
            out += _cmp_bn(f"{t}.bn{c[-1]}", f + (c,))
        if b == 0:
            out += _cmp_conv(f"{t}.downsample.0", f + ("downsample",),
                             bias=False)
            out += _cmp_bn(f"{t}.downsample.1", f + ("downsample",))
    out += _conv("image_encoder.conv5", ie + ("conv5",))
    # ShallowNet's Sequential: conv 0 / BatchNorm 1, conv 4 / BatchNorm 5
    for conv, bn, name in ((0, 1, "conv1"), (4, 5, "conv2")):
        out += _cmp_conv(f"flow_encoder.features.{conv}",
                         ("flow_encoder", name))
        out += _cmp_bn(f"flow_encoder.features.{bn}", ("flow_encoder", name))
    for t_conv, t_bn, f in _cmp_decoder_convs():
        out += _cmp_conv(t_conv, f)
        out += _cmp_bn(t_bn, f)
    out += _conv("flow_decoder.head", ("flow_decoder", "head"))
    return out


def cmp_batch_stats_map() -> List[Entry]:
    """BatchNorm running_mean / running_var -> the flax 'batch_stats'
    collection, for the same CMP as `cmp_name_map`."""
    out: List[Entry] = []

    def bn(t, f):
        out.extend([(f"{t}.running_mean", f + ("bn", "mean"), "raw"),
                    (f"{t}.running_var", f + ("bn", "var"), "raw")])

    out += [("image_encoder.bn1.running_mean",
             ("image_encoder", "bn1", "mean"), "raw"),
            ("image_encoder.bn1.running_var",
             ("image_encoder", "bn1", "var"), "raw")]
    for t, b, f in _cmp_resnet_blocks():
        for c in ("conv1", "conv2", "conv3"):
            bn(f"{t}.bn{c[-1]}", f + (c,))
        if b == 0:
            bn(f"{t}.downsample.1", f + ("downsample",))
    bn("flow_encoder.features.1", ("flow_encoder", "conv1"))
    bn("flow_encoder.features.5", ("flow_encoder", "conv2"))
    for _, t_bn, f in _cmp_decoder_convs():
        bn(t_bn, f)
    return out


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


def load_cmp_params(module: torch.nn.Module, variables: Mapping) -> None:
    """Load a flax CMP's variables into the port's `models.cmp.CMP`."""
    load_flax_variables(module, variables, cmp_name_map(),
                        cmp_batch_stats_map())


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
