"""Small unconditional pixel-space UNet: the residual DDPM's.

Counterpart: `diffcodec_tpu/models/unet2d.py` (`UNet2DModel` :22-84), the
reference's HF `UNet2DModel` (sample size 256, 3 channels in and out,
blocks (64, 128, 128, 256) of two resnets, attention in the deepest two),
trained as a 500-step squaredcos DDPM on warp residuals.  Submodule names
are diffusers' `UNet2DModel` (`unet2d_name_map` in
`diffcodec_tpu_torch/weights.py`).

Kept from the JAX package: its single-head `AttentionBlock2D` (diffusers'
heads of 8 channels are not copied); symmetric stride-2 downsamplers;
nearest-2x upsampling before each upsampler's conv; every resnet of the up
path takes the concatenated skip through a 1x1 shortcut.  It runs in fp32
like the JAX script, where JAX's fused-conv gates (bf16 only) refuse it
and its attention is an XLA einsum: plain PyTorch on cuDNN and cuBLAS.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffcodec_tpu_torch.models.layers import (AttentionBlock2D,
                                               Downsample2D, GroupNorm32,
                                               ResnetBlock2D,
                                               TimestepEmbedding, Upsample2D,
                                               conv3x3, timestep_embedding)


class _Block(nn.Module):
    """A down, mid or up block: resnets, `n_attn` attentions (or None),
    an optional resampler (in diffusers' attribute names)."""

    def __init__(self, cins: Sequence[int], ch: int, temb_dim: int,
                 n_attn: int, resampler: nn.Module = None,
                 resampler_name: str = "downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ci, ch, temb_dim)
                                      for ci in cins])
        self.attentions = (nn.ModuleList([AttentionBlock2D(ch)
                                          for _ in range(n_attn)])
                           if n_attn else None)
        self.resampler_name = resampler_name
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))

    @property
    def resampler(self):
        mods = getattr(self, self.resampler_name, None)
        return None if mods is None else mods[0]


class UNet2DModel(nn.Module):
    """(sample [B, H, W, in], timesteps [B] or a scalar) -> epsilon
    [B, H, W, out], in the weights' dtype."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (64, 128, 128, 256),
                 layers_per_block: int = 2,
                 attn_blocks: Sequence[bool] = (False, False, True, True)):
        super().__init__()
        chans = tuple(block_out_channels)
        ch0, temb_dim = chans[0], chans[0] * 4
        self.block_out_channels = chans
        self.conv_in = conv3x3(in_channels, ch0)
        self.time_embedding = TimestepEmbedding(ch0, temb_dim)
        self.down_blocks = nn.ModuleList()
        skips, prev = [ch0], ch0
        for i, ch in enumerate(chans):
            last = i == len(chans) - 1
            self.down_blocks.append(_Block(
                [prev] + [ch] * (layers_per_block - 1), ch, temb_dim,
                layers_per_block if attn_blocks[i] else 0,
                None if last else Downsample2D(ch)))
            skips += [ch] * (layers_per_block + (0 if last else 1))
            prev = ch
        self.mid_block = _Block([chans[-1]] * 2, chans[-1], temb_dim, 1)
        self.up_blocks = nn.ModuleList()
        rev_attn = list(reversed(attn_blocks))
        for i, ch in enumerate(reversed(chans)):
            last = i == len(chans) - 1
            cins = []
            for _ in range(layers_per_block + 1):
                cins.append(prev + skips.pop())
                prev = ch
            self.up_blocks.append(_Block(
                cins, ch, temb_dim, len(cins) if rev_attn[i] else 0,
                None if last else Upsample2D(ch), "upsamplers"))
        self.conv_norm_out = GroupNorm32(ch0, 1e-5)
        self.conv_out = conv3x3(ch0, out_channels)

    def forward(self, sample: torch.Tensor, timesteps) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        t = torch.as_tensor(timesteps, device=sample.device)
        t = t.reshape(-1).expand(B)
        temb = self.time_embedding(timestep_embedding(
            t, self.block_out_channels[0]).to(dtype))
        x = self.conv_in(sample.to(dtype))
        stack = [x]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(x, temb)
                if block.attentions is not None:
                    x = block.attentions[j](x)
                stack.append(x)
            if block.resampler is not None:
                x = block.resampler(x)
                stack.append(x)
        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = mid.attentions[0](x)
        x = mid.resnets[1](x, temb)
        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, stack.pop()], dim=-1), temb)
                if block.attentions is not None:
                    x = block.attentions[j](x)
            if block.resampler is not None:
                x = block.resampler(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))
