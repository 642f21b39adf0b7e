"""SD-1.5 conditional UNet, NHWC, with ControlNet residual injection and
FreeU.

Counterpart: `diffcodec_tpu/models/unet2d_condition.py` (:113-288).  The
forward is split into `encode` (conv_in + down blocks) and `decode`
(residual injection + mid + up + out head), so the sampler can reuse a
cached encoder across denoise steps (`SamplerConfig.unet_encoder_interval`).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffcodec_tpu_torch.config import UNetConfig
from diffcodec_tpu_torch.models.layers import (Downsample2D, GroupNorm32,
                                               ResnetBlock2D,
                                               TimestepEmbedding,
                                               Transformer2D, Upsample2D,
                                               conv3x3, timestep_embedding)


@functools.lru_cache(maxsize=None)
def _box_projector(n: int, threshold: int):
    """1-D operator P = F^-1 diag(box) F selecting FreeU's centred
    frequency box; (Re P, Im P) as float32 numpy [n, n].  The box is off
    centre by half a bin, so P has an imaginary part that the real
    projection folds in."""
    c = n // 2
    sel = np.zeros(n)
    sel[max(c - threshold, 0):min(c + threshold, n)] = 1.0
    sel = np.fft.ifftshift(sel)
    P = np.fft.ifft(sel[:, None] * np.fft.fft(np.eye(n), axis=0), axis=0)
    return (np.ascontiguousarray(P.real, dtype=np.float32),
            np.ascontiguousarray(P.imag, dtype=np.float32))


def fourier_filter(x: torch.Tensor, threshold: int,
                   scale: float) -> torch.Tensor:
    """FreeU low-frequency scaling of skip features (NHWC), in the
    box-projector form: Re(IFFT2(mask * FFT2(x))) = x + (scale - 1) *
    (Re Pr x Re Pc^T - Im Pr x Im Pc^T), four small matrix products in fp32
    instead of FFTs."""
    B, H, W, C = x.shape
    pr_re, pr_im = (torch.from_numpy(a).to(x.device)
                    for a in _box_projector(H, threshold))
    pc_re, pc_im = (torch.from_numpy(a).to(x.device)
                    for a in _box_projector(W, threshold))
    xf = x.float()
    low = (torch.einsum("ij,bjwc,vw->bivc", pr_re, xf, pc_re)
           - torch.einsum("ij,bjwc,vw->bivc", pr_im, xf, pc_im))
    return (xf + (scale - 1.0) * low).to(x.dtype)


def apply_freeu(resolution_idx: int, hidden: torch.Tensor, res: torch.Tensor,
                s1: float, s2: float, b1: float, b2: float):
    """Scale the backbone's first half-channels by b*, fourier-filter the
    skip by s*, at up-block resolutions 0 and 1."""
    if resolution_idx not in (0, 1):
        return hidden, res
    b, s = (b1, s1) if resolution_idx == 0 else (b2, s2)
    half = hidden.shape[-1] // 2
    hidden = torch.cat([hidden[..., :half] * b, hidden[..., half:]], dim=-1)
    return hidden, fourier_filter(res, 1, s)


class CrossAttnDownBlock(nn.Module):
    """CrossAttnDownBlock2D / DownBlock2D."""

    def __init__(self, cin: int, cout: int, temb_dim: int, layers: int,
                 has_attn: bool, heads: int, context_dim: int, depth: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(cin if j == 0 else cout, cout, temb_dim)
            for j in range(layers)])
        self.attentions = nn.ModuleList([
            Transformer2D(cout, heads, context_dim, depth)
            for _ in range(layers)]) if has_attn else None
        self.downsamplers = (nn.ModuleList([Downsample2D(cout)])
                             if add_downsample else None)

    def forward(self, x, temb, context):
        res_out = []
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[j](x, context)
            res_out.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res_out.append(x)
        return x, res_out


class MidBlock(nn.Module):
    """UNetMidBlock2DCrossAttn: resnet, transformer, resnet."""

    def __init__(self, channels: int, temb_dim: int, heads: int,
                 context_dim: int, depth: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_dim),
            ResnetBlock2D(channels, channels, temb_dim)])
        self.attentions = nn.ModuleList([
            Transformer2D(channels, heads, context_dim, depth)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class CrossAttnUpBlock(nn.Module):
    """CrossAttnUpBlock2D / UpBlock2D, with FreeU on the skips."""

    def __init__(self, prev_out: int, cout: int, skips: Sequence[int],
                 temb_dim: int, has_attn: bool, heads: int, context_dim: int,
                 depth: int, add_upsample: bool, resolution_idx: int):
        super().__init__()
        self.resolution_idx = resolution_idx
        self.resnets = nn.ModuleList([
            ResnetBlock2D((prev_out if j == 0 else cout) + skips[j], cout,
                          temb_dim) for j in range(len(skips))])
        self.attentions = nn.ModuleList([
            Transformer2D(cout, heads, context_dim, depth)
            for _ in range(len(skips))]) if has_attn else None
        self.upsamplers = (nn.ModuleList([Upsample2D(cout)])
                           if add_upsample else None)

    def forward(self, x, res_stack: list, temb, context, freeu=None):
        for j, resnet in enumerate(self.resnets):
            res = res_stack.pop()
            if freeu is not None:
                x, res = apply_freeu(self.resolution_idx, x, res, *freeu)
            x = resnet(torch.cat([x, res], dim=-1), temb)
            if self.attentions is not None:
                x = self.attentions[j](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetTrunk(nn.Module):
    """conv_in + time embedding + down blocks + mid block: the part the
    UNet shares with the ControlNet."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        chans = cfg.block_out_channels
        temb_dim = chans[0] * 4
        self.unet_cfg = cfg
        self.conv_in = conv3x3(cfg.in_channels, chans[0])
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for i, ch in enumerate(chans):
            self.down_blocks.append(CrossAttnDownBlock(
                prev, ch, temb_dim, cfg.layers_per_block,
                cfg.cross_attention_blocks[i], cfg.attention_heads,
                cfg.cross_attention_dim, cfg.transformer_depth,
                add_downsample=i != len(chans) - 1))
            prev = ch
        self.mid_block = MidBlock(chans[-1], temb_dim, cfg.attention_heads,
                                  cfg.cross_attention_dim,
                                  cfg.transformer_depth)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def time_emb(self, timesteps, batch: int) -> torch.Tensor:
        t = torch.as_tensor(timesteps, device=self.conv_in.weight.device)
        t = t.reshape(-1).expand(batch)
        emb = timestep_embedding(t, self.unet_cfg.block_out_channels[0])
        return self.time_embedding(emb.to(self.dtype))


class UNet2DConditionModel(UNetTrunk):
    """Text- and time-conditioned denoising UNet with ControlNet residual
    injection; `forward` is exactly `decode(*encode(...))`."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__(cfg)
        self.cfg = cfg
        chans = cfg.block_out_channels
        temb_dim = chans[0] * 4
        rev = list(reversed(chans))
        rev_attn = list(reversed(cfg.cross_attention_blocks))
        # skip widths, in the order the down path pushes them
        skip_stack = [chans[0]]
        for i, ch in enumerate(chans):
            skip_stack += [ch] * cfg.layers_per_block
            if i != len(chans) - 1:
                skip_stack.append(ch)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, ch in enumerate(rev):
            skips = [skip_stack.pop()
                     for _ in range(cfg.layers_per_block + 1)]
            self.up_blocks.append(CrossAttnUpBlock(
                prev, ch, skips, temb_dim, rev_attn[i], cfg.attention_heads,
                cfg.cross_attention_dim, cfg.transformer_depth,
                add_upsample=i != len(rev) - 1, resolution_idx=i))
            prev = ch
        self.conv_norm_out = GroupNorm32(chans[0], 1e-5)
        self.conv_out = conv3x3(chans[0], cfg.out_channels)

    def encode(self, sample, timesteps, encoder_hidden_states
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """conv_in + down blocks: (hidden, skip stack)."""
        temb = self.time_emb(timesteps, sample.shape[0])
        context = encoder_hidden_states.to(self.dtype)
        x = self.conv_in(sample.to(self.dtype))
        res_stack = [x]
        for block in self.down_blocks:
            x, res_out = block(x, temb, context)
            res_stack.extend(res_out)
        return x, tuple(res_stack)

    def decode(self, x, res_stack, timesteps, encoder_hidden_states,
               down_block_additional_residuals: Optional[Sequence] = None,
               mid_block_additional_residual: Optional[torch.Tensor] = None,
               freeu: Optional[Tuple[float, float, float, float]] = None):
        """ControlNet residual injection + mid + up blocks + out head; the
        time embedding is recomputed so a cached `encode` combines with
        this step's timestep."""
        temb = self.time_emb(timesteps, x.shape[0])
        context = encoder_hidden_states.to(self.dtype)
        res_stack = list(res_stack)
        if down_block_additional_residuals is not None:
            res_stack = [r + a for r, a in
                         zip(res_stack, down_block_additional_residuals)]
        x = self.mid_block(x, temb, context)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual
        for block in self.up_blocks:
            x = block(x, res_stack, temb, context, freeu=freeu)
        if res_stack:
            raise RuntimeError(f"{len(res_stack)} skips left unconsumed")
        return self.conv_out(F.silu(self.conv_norm_out(x)))

    def forward(self, sample, timesteps, encoder_hidden_states,
                down_block_additional_residuals=None,
                mid_block_additional_residual=None, freeu=None):
        x, res_stack = self.encode(sample, timesteps, encoder_hidden_states)
        return self.decode(x, res_stack, timesteps, encoder_hidden_states,
                           down_block_additional_residuals,
                           mid_block_additional_residual, freeu)
