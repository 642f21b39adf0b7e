"""Building blocks of the SD-1.5 model family, NHWC, in PyTorch.

Counterpart: `diffcodec_tpu/models/layers.py`.  Attribute names are those of
the HF diffusers checkpoints (the torch side of the name maps in
`diffcodec_tpu_torch/weights.py`), so state dicts load by name.

Numerics kept from the JAX package:
  * GroupNorm computed in fp32 and cast back, with the group count halved
    until it divides narrow channel counts; eps 1e-5 in UNet resnets, 1e-6
    in the VAE and the transformers;
  * LayerNorm eps 1e-5; exact (erf) GELU in GEGLU;
  * attention with bf16 operands and an fp32 softmax.  Every UNet and
    ControlNet attention call (self and cross) goes to
    `ops.attention.attention`, the CUDA kernel on the card;
    `AttentionBlock2D` (the VAE's single head, D = 512) stays a plain
    matmul + softmax, as XLA computed it outside any Pallas kernel;
  * `ConvBlock` (the warp extractor's) stays on cuDNN;
  * `ResnetBlock2D`, `Upsample2D` and `Downsample2D` take `fused_conv`:
    off, GroupNorm, SiLU and the upsampling are separate passes around a
    cuDNN conv (the JAX package with `DIFFCODEC_FUSED_SILU_CONV` unset);
    on, each conv3x3 is one call of the kernels of `ops.conv`
    (`gn_silu_conv3x3` with the folded GroupNorm affine and the shortcut as
    its residual, `upsample_conv3x3`, `downsample_conv3x3`), as the JAX
    package's `exact_fusedconv` point routes the first two
    (`layers.py:159-192`, `:532-584`; its stride-2 gate,
    `conv_pallas.py:794`, was left off on a TPU measurement that does not
    carry over).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffcodec_tpu_torch.ops.attention import attention
from diffcodec_tpu_torch.ops.conv import (conv2d_nhwc, downsample_conv3x3,
                                          downsample_conv3x3_ref,
                                          gn_silu_conv3x3, upsample_conv3x3)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings, HF `Timesteps` for SD-1.5 (flip_sin_to_cos,
    no frequency shift); fp32 [B, dim], dim even."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP lifting sinusoidal embeddings to the time width."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm32(nn.Module):
    """GroupNorm over NHWC in fp32, cast back to the input dtype.  The group
    count halves until it divides the channels (tiny test configs)."""

    def __init__(self, channels: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        num_groups = 32
        while channels % num_groups:
            num_groups //= 2
        self.num_groups, self.eps = num_groups, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def affine(self, x):
        """The folded per-(batch, channel) (scale, shift), fp32 [B, C], with
        x * scale + shift == GroupNorm(x): statistics in fp32 over the
        spatial positions and the channels of each group."""
        B, C = x.shape[0], x.shape[-1]
        gs = C // self.num_groups
        var, mean = torch.var_mean(
            x.float().reshape(B, -1, self.num_groups, gs), dim=(1, 3),
            unbiased=False)
        scale = torch.rsqrt(var + self.eps).repeat_interleave(gs, dim=1)
        shift = -mean.repeat_interleave(gs, dim=1) * scale
        if self.weight is not None:
            scale = scale * self.weight.float()
            shift = shift * self.weight.float() + self.bias.float()
        return scale, shift

    def forward(self, x):
        # x * scale + shift computed in fp32, rounded once to x's dtype (the
        # form `ops.conv.gn_silu_conv3x3_ref` also takes); without autograd
        # in one fused pass that writes x's dtype (autograd takes no out=)
        scale, shift = self.affine(x)
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        if torch.is_grad_enabled() and (scale.requires_grad
                                        or shift.requires_grad):
            return torch.addcmul(shift.view(shape), x,
                                 scale.view(shape)).to(x.dtype)
        return torch.addcmul(shift.view(shape), x, scale.view(shape),
                             out=torch.empty_like(x))


class Conv2d(nn.Conv2d):
    """nn.Conv2d applied to NHWC tensors (SAME padding for odd kernels)."""

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, stride=self.stride[0],
                           padding=self.padding[0], groups=self.groups)


def conv3x3(cin: int, cout: int, stride: int = 1, groups: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, groups=groups)


def conv1x1(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, 1)


class ResnetBlock2D(nn.Module):
    """GN-SiLU-conv, + time embedding, GN-SiLU-conv, + shortcut.

    fused_conv: each GN-SiLU-conv is one `gn_silu_conv3x3` call on the
    folded GroupNorm affine, the second with the shortcut as its residual.
    """

    def __init__(self, cin: int, cout: int, temb_dim: int = None,
                 eps: float = 1e-5, fused_conv: bool = False):
        super().__init__()
        self.fused_conv = fused_conv
        self.norm1 = GroupNorm32(cin, eps)
        self.conv1 = conv3x3(cin, cout)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        else:
            self.time_emb_proj = None
        self.norm2 = GroupNorm32(cout, eps)
        self.conv2 = conv3x3(cout, cout)
        self.conv_shortcut = conv1x1(cin, cout) if cin != cout else None

    def forward(self, x, temb=None):
        if self.fused_conv:
            h = gn_silu_conv3x3(x, *self.norm1.affine(x), self.conv1.weight,
                                self.conv1.bias)
        else:
            h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        res = x if self.conv_shortcut is None else self.conv_shortcut(x)
        if self.fused_conv:
            return gn_silu_conv3x3(h, *self.norm2.affine(h),
                                   self.conv2.weight, self.conv2.bias,
                                   residual=res)
        return self.conv2(F.silu(self.norm2(h))) + res


class Attention(nn.Module):
    """Multi-head attention, bias-free q/k/v and a biased output
    projection; self-attention when `context` is None."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def _heads(self, t):
        """[B, L, heads * D] -> [B * heads, L, D], contiguous, as the
        kernel takes its operands (at B = 1 the reshape alone is a
        strided view)."""
        B, L, _ = t.shape
        return (t.reshape(B, L, self.heads, self.dim_head)
                .permute(0, 2, 1, 3).reshape(B * self.heads, L,
                                              self.dim_head).contiguous())

    def forward(self, x, context=None):
        context = x if context is None else context
        B, L, _ = x.shape
        q = self._heads(self.to_q(x))
        k = self._heads(self.to_k(context))
        v = self._heads(self.to_v(context))
        out = attention(q, k, v, self.dim_head ** -0.5)
        out = (out.reshape(B, self.heads, L, self.dim_head)
               .permute(0, 2, 1, 3).reshape(B, L, -1))
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, each residual."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, context_dim=context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> 1x1 proj_in -> blocks -> 1x1 proj_out,
    plus the input."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(channels, 1e-6)
        self.proj_in = conv1x1(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads,
                                  context_dim) for _ in range(depth)])
        self.proj_out = conv1x1(channels, channels)

    def forward(self, x, context):
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x)).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, context)
        return self.proj_out(h.reshape(B, H, W, C)) + x


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv, padded on all sides (the UNet's) or, with
    `asymmetric_pad`, at the bottom and right only (the VAE encoder's: HF
    pads (0, 1, 0, 1) and convolves unpadded).  fused_conv: one
    `downsample_conv3x3` call."""

    def __init__(self, channels: int, asymmetric_pad: bool = False,
                 fused_conv: bool = False):
        super().__init__()
        self.asymmetric_pad, self.fused_conv = asymmetric_pad, fused_conv
        self.conv = conv3x3(channels, channels, stride=2)

    def forward(self, x):
        if self.fused_conv:
            return downsample_conv3x3(x, self.conv.weight, self.conv.bias,
                                      self.asymmetric_pad)
        if self.asymmetric_pad:
            return downsample_conv3x3_ref(x, self.conv.weight,
                                          self.conv.bias)
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsampling, then a 3x3 conv; fused_conv: one
    `upsample_conv3x3` call, which never forms the 2x tensor."""

    def __init__(self, channels: int, fused_conv: bool = False):
        super().__init__()
        self.fused_conv = fused_conv
        self.conv = conv3x3(channels, channels)

    def forward(self, x):
        if self.fused_conv:
            return upsample_conv3x3(x, self.conv.weight, self.conv.bias)
        B, H, W, C = x.shape
        up = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
        return self.conv(up.reshape(B, 2 * H, 2 * W, C))


class AttentionBlock2D(nn.Module):
    """The VAE mid block's single-head spatial self-attention (biased
    projections, residual); plain matmul + fp32 softmax."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm32(channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2))
        probs = torch.softmax(logits * C ** -0.5, dim=-1).to(v.dtype)
        out = self.to_out[0](torch.matmul(probs, v))
        return x + out.reshape(B, H, W, C)


class ConvBlock(nn.Module):
    """conv3x3 (with stride) - SiLU - conv3x3 - SiLU (the JAX package's
    `ConvBlock`, `layers.py:621-637`).  cuDNN convs: JAX's fused SiluConv
    gate (H * W >= 256^2, bf16) refuses the warp extractor's stages, which
    run at 128 px and below from a 512 px input."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.block = nn.Sequential(conv3x3(cin, cout, stride), nn.SiLU(),
                                   conv3x3(cout, cout), nn.SiLU())

    def forward(self, x):
        return self.block(x.to(self.block[0].weight.dtype))
