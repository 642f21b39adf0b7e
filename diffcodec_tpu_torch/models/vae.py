"""SD-1.5 AutoencoderKL decoder, NHWC.

Counterpart: `diffcodec_tpu/models/vae.py` (`Decoder` :62-92, `_out_head`
:52-60, `decode_from_latents` :140): post_quant_conv, conv_in, mid
resnet-attention-resnet, up blocks of layers_per_block + 1 resnets with
nearest-2x upsampling, GN - SiLU - conv3x3 out head.  The encoder is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffcodec_tpu_torch.config import VAEConfig
from diffcodec_tpu_torch.models.layers import (AttentionBlock2D,
                                               GroupNorm32, ResnetBlock2D,
                                               Upsample2D, conv1x1, conv3x3)
from diffcodec_tpu_torch.ops.conv import silu_conv3x3


class _VAEMid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, None, eps=1e-6),
            ResnetBlock2D(channels, channels, None, eps=1e-6)])
        self.attentions = nn.ModuleList([AttentionBlock2D(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _VAEUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if j == 0 else cout, cout, None, eps=1e-6)
            for j in range(layers)])
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)])
                           if add_upsample else None)

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        top = cfg.base_channels * cfg.channel_mults[-1]
        self.conv_in = conv3x3(cfg.latent_channels, top)
        self.mid_block = _VAEMid(top)
        self.up_blocks = nn.ModuleList()
        prev = top
        rev = list(reversed(cfg.channel_mults))
        for i, mult in enumerate(rev):
            ch = cfg.base_channels * mult
            self.up_blocks.append(_VAEUpBlock(
                prev, ch, cfg.layers_per_block + 1,
                add_upsample=i < len(rev) - 1))
            prev = ch
        self.conv_norm_out = GroupNorm32(prev, 1e-6)
        self.conv_out = conv3x3(prev, cfg.in_channels)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return _out_head(x, self.conv_norm_out, self.conv_out)


def _out_head(h, norm: GroupNorm32, conv: nn.Conv2d):
    """GN -> SiLU -> conv3x3."""
    return silu_conv3x3(norm(h), conv.weight, conv.bias)


class AutoencoderKL(nn.Module):
    """The VAE's decoding half: post_quant_conv + Decoder."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = conv1x1(cfg.latent_channels,
                                       cfg.latent_channels)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def decode_from_latents(vae: AutoencoderKL, latents: torch.Tensor
                        ) -> torch.Tensor:
    """Scaled latents [B, h, w, 4] -> images [B, 8h, 8w, 3] in about
    [-1, 1] (callers clamp)."""
    z = latents.float() / vae.cfg.scaling_factor
    return vae.decode(z.to(vae.post_quant_conv.weight.dtype))
