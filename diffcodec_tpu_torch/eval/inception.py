"""InceptionV3's 64-feature prefix for FID (torchmetrics feature=64).

Counterpart: `diffcodec_tpu/eval/inception.py` (`BasicConv2d` :27,
`InceptionFID64` :45, `make_fid64_feature_fn` :80).  torchmetrics'
64-d features are the average-pooled output of InceptionV3's first pool
block: Conv2d_1a_3x3 (stride 2), Conv2d_2a_3x3, Conv2d_2b_3x3 (the only
padded one), MaxPool 3 x 3 stride 2, each BasicConv2d a conv without bias,
BatchNorm with eps 1e-3 (not torch's default 1e-5) and ReLU.  Frames are
resized to 299 x 299 by `ops.flow.resize_bilinear` (the JAX package's
arithmetic) and mapped to [-1, 1].

Plain PyTorch (cuDNN on the card), as XLA computed these layers for the
JAX package; NHWC at the module's edges.  The state dict keys are the
torch names of `weights.inception64_name_map` and `_batch_stats_map`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffcodec_tpu_torch.eval.metrics import require_fp32_on
from diffcodec_tpu_torch.ops.flow import resize_bilinear
from diffcodec_tpu_torch.sampling.tiled import unit_from_uint8


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionFID64(nn.Module):
    """[N, 299, 299, 3] in [-1, 1] -> [N, 64] pooled features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, padding=1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        return F.max_pool2d(x, 3, 2).mean(dim=(2, 3))


def make_fid64_feature_fn(model: InceptionFID64, batch_size: int = 32,
                          device="cuda"):
    """FID feature fn over uint8 [N, H, W, 3] frames (numpy or a tensor):
    batches go up as uint8, are resized to 299 and mapped to [-1, 1] on
    `device` in fp32; returns [N, 64] numpy features.  `model` must
    already be fp32 on `device` (else `ValueError`); it is put in eval
    mode."""
    require_fp32_on(model, device)
    model = model.eval()

    @torch.no_grad()
    def feature_fn(images) -> np.ndarray:
        images = torch.as_tensor(images)
        feats = []
        for i in range(0, len(images), batch_size):
            x = unit_from_uint8(images[i:i + batch_size].to(device),
                                torch.float32)
            x = resize_bilinear(x, 299, 299) * 2.0 - 1.0
            feats.append(model(x).float().cpu().numpy())
        return np.concatenate(feats)

    return feature_fn
