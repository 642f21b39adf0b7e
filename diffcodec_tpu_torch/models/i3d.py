"""InceptionI3D (Kinetics-400): the FVD feature extractor.

Counterpart: `diffcodec_tpu/models/i3d.py` (`Unit3D` :37, `InceptionModule`
:67, `InceptionI3D` :84), the reference's vendored `pytorch_i3d.py`: 400-d
logits of [B, T, H, W, 3] clips in [-1, 1].  Unit3D is a conv without bias,
BatchNorm with eps 1e-3 and ReLU; after the last inception block the
spatial mean, a 1 x 1 x 1 logits conv with a bias, then the mean over T.

flax's `padding="SAME"` pads a stride-s, size-k window over n samples by
max((ceil(n / s) - 1) s + k - n, 0) in all, the lower side the half
rounded down (the stride-2 7 x 7 x 7 stem: 2 before, 3 after).  torch's
`padding="same"` refuses stride 2 and `MaxPool3d` pads both sides alike,
so every conv and pool here pads explicitly with `F.pad`, with -inf for
the pools (what flax's max pool pads with).

Plain PyTorch (cuDNN on the card), as XLA computed these layers for the
JAX package.  NTHWC at the module's edges, NCTHW inside.  The state dict
keys are the torch names of `weights.i3d_name_map` and
`i3d_batch_stats_map`.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# (name, branch channels) per inception block, the channels being
# (b0 1x1, b1 1x1, b1 3x3, b2 1x1, b2 3x3, b3 1x1); "pool" entries are
# (window, stride) of a max pool between blocks
_INCEPTION_SPECS = [
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("pool", ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("pool", ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
]


def same_pads(sizes: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> Tuple[int, ...]:
    """`F.pad`'s argument for flax's SAME over the last len(sizes) dims
    (the last dim's pair first)."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for pair in reversed(pads) for p in pair)


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    x = F.pad(x, same_pads(x.shape[2:], kernel, stride), value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


class Unit3D(nn.Module):
    """Conv3d (SAME) + BatchNorm (eps 1e-3) + ReLU, NCTHW."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), use_bn: bool = True,
                 activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.activation = activation
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(cout, eps=1e-3) if use_bn else None

    def forward(self, x):
        x = self.conv3d(F.pad(x, same_pads(x.shape[2:], self.kernel,
                                           self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    def __init__(self, cin: int, spec: Sequence[int]):
        super().__init__()
        s = spec
        self.b0 = Unit3D(cin, s[0])
        self.b1a = Unit3D(cin, s[1])
        self.b1b = Unit3D(s[1], s[2], (3, 3, 3))
        self.b2a = Unit3D(cin, s[3])
        self.b2b = Unit3D(s[3], s[4], (3, 3, 3))
        self.b3b = Unit3D(cin, s[5])
        self.out_channels = s[0] + s[2] + s[4] + s[5]

    def forward(self, x):
        b3 = max_pool_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3b(b3)], dim=1)


class InceptionI3D(nn.Module):
    """videos [B, T, H, W, 3] in [-1, 1] -> logits [B, num_classes]."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        self.blocks = []
        cin = 192
        for name, spec in _INCEPTION_SPECS:
            if name == "pool":
                self.blocks.append(spec)
                continue
            block = InceptionModule(cin, spec)
            setattr(self, name, block)
            self.blocks.append(name)
            cin = block.out_channels
        self.logits = Unit3D(cin, num_classes, use_bn=False,
                             activation=False, use_bias=True)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        for block in self.blocks:
            if isinstance(block, str):
                x = getattr(self, block)(x)
            else:
                x = max_pool_same(x, *block)
        x = self.logits(x.mean(dim=(3, 4), keepdim=True))
        return x.mean(dim=(2, 3, 4))
