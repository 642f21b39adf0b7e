"""SD-1.5 AutoencoderKL, NHWC.

Counterpart: `diffcodec_tpu/models/vae.py`.  `Encoder` (:22-50): conv_in,
down blocks of layers_per_block resnets with a stride-2 downsampler padded
bottom/right (all but the last), mid resnet-attention-resnet, GN - SiLU -
conv3x3 to the 2 x latent_channels moments; `AutoencoderKL.encode` adds
quant_conv and splits the moments (:100-112); `encode_to_latents` (:127).
`Decoder` (:62-92, `_out_head` :52-60, `decode_from_latents` :140):
post_quant_conv, conv_in, mid resnet-attention-resnet, up blocks of
layers_per_block + 1 resnets with nearest-2x upsampling, GN - SiLU - conv3x3
out head.

`fused_conv` routes every resnet conv, every upsampler and downsampler and
the decoder's out head to the conv kernels of `ops.conv` (the JAX package's
`exact_fusedconv` point, at every shape: the TPU's shape gates are not
copied); the decoder's out head is then one `gn_silu_conv3x3` call with
O = 3, the function JAX's projected XLA form computes there (`vae.py:52-60`,
`conv_pallas.py:424-443`).  The encoder's GN - SiLU - conv_out tail stays
plain, as in JAX (`vae.py:46-49`).  Off by default, as the JAX flag is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffcodec_tpu_torch.config import VAEConfig
from diffcodec_tpu_torch.models.layers import (AttentionBlock2D,
                                               Downsample2D, GroupNorm32,
                                               ResnetBlock2D, Upsample2D,
                                               conv1x1, conv3x3)
from diffcodec_tpu_torch.ops.conv import gn_silu_conv3x3


class _VAEMid(nn.Module):
    def __init__(self, channels: int, fused_conv: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, None, eps=1e-6,
                          fused_conv=fused_conv) for _ in range(2)])
        self.attentions = nn.ModuleList([AttentionBlock2D(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _VAEDownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, add_downsample: bool,
                 fused_conv: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if j == 0 else cout, cout, None, eps=1e-6,
                          fused_conv=fused_conv)
            for j in range(layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(
            cout, asymmetric_pad=True, fused_conv=fused_conv)])
            if add_downsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    """Images [B, H, W, in_channels] -> moments [B, H/f, W/f,
    2 * latent_channels], f = 2 ** (len(channel_mults) - 1)."""

    def __init__(self, cfg: VAEConfig, fused_conv: bool = False):
        super().__init__()
        self.conv_in = conv3x3(cfg.in_channels, cfg.base_channels)
        self.down_blocks = nn.ModuleList()
        prev = cfg.base_channels
        for i, mult in enumerate(cfg.channel_mults):
            ch = cfg.base_channels * mult
            self.down_blocks.append(_VAEDownBlock(
                prev, ch, cfg.layers_per_block,
                add_downsample=i < len(cfg.channel_mults) - 1,
                fused_conv=fused_conv))
            prev = ch
        self.mid_block = _VAEMid(prev, fused_conv)
        self.conv_norm_out = GroupNorm32(prev, 1e-6)
        self.conv_out = conv3x3(prev, 2 * cfg.latent_channels)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class _VAEUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, add_upsample: bool,
                 fused_conv: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if j == 0 else cout, cout, None, eps=1e-6,
                          fused_conv=fused_conv)
            for j in range(layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout, fused_conv)])
                           if add_upsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, fused_conv: bool = False):
        super().__init__()
        self.fused_conv = fused_conv
        top = cfg.base_channels * cfg.channel_mults[-1]
        self.conv_in = conv3x3(cfg.latent_channels, top)
        self.mid_block = _VAEMid(top, fused_conv)
        self.up_blocks = nn.ModuleList()
        prev = top
        rev = list(reversed(cfg.channel_mults))
        for i, mult in enumerate(rev):
            ch = cfg.base_channels * mult
            self.up_blocks.append(_VAEUpBlock(
                prev, ch, cfg.layers_per_block + 1,
                add_upsample=i < len(rev) - 1, fused_conv=fused_conv))
            prev = ch
        self.conv_norm_out = GroupNorm32(prev, 1e-6)
        self.conv_out = conv3x3(prev, cfg.in_channels)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return _out_head(x, self.conv_norm_out, self.conv_out,
                         self.fused_conv)


def _out_head(h, norm: GroupNorm32, conv: nn.Conv2d, fused: bool):
    """GN -> SiLU -> conv3x3."""
    if fused:
        return gn_silu_conv3x3(h, *norm.affine(h), conv.weight, conv.bias)
    return conv(F.silu(norm(h)))


class AutoencoderKL(nn.Module):
    """Encoder + quant_conv, and post_quant_conv + Decoder."""

    def __init__(self, cfg: VAEConfig = VAEConfig(),
                 fused_conv: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, fused_conv)
        self.decoder = Decoder(cfg, fused_conv)
        self.quant_conv = conv1x1(2 * cfg.latent_channels,
                                  2 * cfg.latent_channels)
        self.post_quant_conv = conv1x1(cfg.latent_channels,
                                       cfg.latent_channels)

    def encode(self, x):
        """Images [B, H, W, 3] in [-1, 1] -> the posterior's (mean,
        logvar), each [B, H/8, W/8, latent_channels], logvar clamped to
        [-30, 20]."""
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def encode_to_latents(vae: AutoencoderKL, images: torch.Tensor,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Images [B, H, W, 3] in [-1, 1] -> scaled latents [B, H/8, W/8, 4]:
    a draw mean + exp(logvar / 2) * noise of the posterior where `noise`
    (like the mean) is given (training, `latent_dist.sample()`), else its
    mode."""
    mean, logvar = vae.encode(images.to(vae.quant_conv.weight.dtype))
    if noise is not None:
        mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    return mean * vae.cfg.scaling_factor


def decode_from_latents(vae: AutoencoderKL, latents: torch.Tensor
                        ) -> torch.Tensor:
    """Scaled latents [B, h, w, 4] -> images [B, 8h, 8w, 3] in about
    [-1, 1] (callers clamp)."""
    z = latents.float() / vae.cfg.scaling_factor
    return vae.decode(z.to(vae.post_quant_conv.weight.dtype))
