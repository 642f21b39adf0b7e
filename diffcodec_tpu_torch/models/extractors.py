"""Warped-conditioning feature extractor and FDN, NHWC.

Counterparts in `diffcodec_tpu/models/extractors.py`: `FDN` (:82-94),
`FeatureWarperSoftsplat` (:97-123) and `BiDirFeatureExtractor` (:126-197).
Attribute names follow the reference's `Bi_Dir_FeatureExtractor`
(`feature_extractor_name_map` in `diffcodec_tpu_torch/weights.py`).

Behaviour kept from the reference, because the published checkpoints train
with it:
  * the swapped wiring: "first" features come from cond[..., 3:6] and are
    warped with the forward flow;
  * the flow at each scale is resized and normalised by (res - 1) / 2,
    not rescaled to the scale's pixel units;
  * occlusion: occ_fwd splats the forward flow along the backward flow;
  * warped features are multiplied by (1 - occlusion mask).
Both flow directions go through one batched splat per scale.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from diffcodec_tpu_torch.models.layers import GroupNorm32, conv3x3
from diffcodec_tpu_torch.ops.conv import conv_silu_chain
from diffcodec_tpu_torch.ops.flow import (compute_occlusion_mask,
                                          resize_and_normalize_flow,
                                          soft_fuse)
from diffcodec_tpu_torch.ops.softsplat import softsplat

# (out channels, stride) of the conv3x3 + SiLU pre-extractor stages
PRE_EXTRACTOR = ((16, 1), (32, 2), (32, 1), (64, 2), (64, 1))


class FDN(nn.Module):
    """Feature denormalisation: parameter-free GroupNorm of x, then a
    scale and shift predicted from the conditioning map by 3x3 convs."""

    def __init__(self, norm_nc: int, label_nc: int):
        super().__init__()
        self.param_free_norm = GroupNorm32(norm_nc, 1e-5, affine=False)
        self.conv_gamma = conv3x3(label_nc, norm_nc)
        self.conv_beta = conv3x3(label_nc, norm_nc)

    def forward(self, x, cond):
        return (self.param_free_norm(x) * (1 + self.conv_gamma(cond))
                + self.conv_beta(cond))


class FeatureWarperSoftsplat(nn.Module):
    """Soft splat of a feature map under a learned 1-channel metric
    (conv3x3 - SiLU - conv3x3); the splat runs in an fp32 island and
    occluded destinations are zeroed.  Returns (warped, metric)."""

    def __init__(self, channels: int):
        super().__init__()
        self.metric_net = nn.Sequential(conv3x3(channels, 64), nn.SiLU(),
                                        conv3x3(64, 1))

    def forward(self, feat, flow, mask=None):
        metric = self.metric_net(feat)
        warped = softsplat(feat.float(), flow.float(), metric.float(),
                           "soft").to(feat.dtype)
        if mask is not None:
            warped = warped * (1.0 - mask.to(feat.dtype))
        return warped, metric


def _pre_extractor() -> nn.Sequential:
    layers, cin = [], 3
    for ch, stride in PRE_EXTRACTOR:
        layers += [conv3x3(cin, ch, stride=stride), nn.SiLU()]
        cin = ch
    return nn.Sequential(*layers)


class BiDirFeatureExtractor(nn.Module):
    """Anchor pair + bidirectional flow -> per-scale injection pyramid.

    cond [B, H, W, 6] (two RGB anchors), flow [B, H, W, 4] (forward uv,
    backward uv; pixels at full resolution) -> len(inject_channels) maps
    at H/8, H/16, ...
    """

    def __init__(self, inject_channels: Sequence[int] = (320, 320, 640,
                                                         1280)):
        super().__init__()
        self.inject_channels = tuple(inject_channels)
        self.first_pre_extractor = _pre_extractor()
        self.last_pre_extractor = _pre_extractor()
        halves = [c // 2 for c in self.inject_channels]
        cins = [PRE_EXTRACTOR[-1][0]] + halves[:-1]
        self.extractors_first = nn.ModuleList([
            nn.Sequential(conv3x3(ci, h, stride=2), nn.SiLU())
            for ci, h in zip(cins, halves)])
        self.extractors_last = nn.ModuleList([
            nn.Sequential(conv3x3(ci, h, stride=2), nn.SiLU())
            for ci, h in zip(cins, halves)])
        self.wrapper = nn.ModuleList([FeatureWarperSoftsplat(h)
                                      for h in halves])
        self.zero_convs = nn.ModuleList([
            conv3x3(h, c) for h, c in zip(halves, self.inject_channels)])

    @staticmethod
    def _pre(chain: nn.Sequential, x):
        convs = [m for m in chain if isinstance(m, nn.Conv2d)]
        return conv_silu_chain(x, [c.weight for c in convs],
                               [c.bias for c in convs],
                               [s for _, s in PRE_EXTRACTOR])

    def forward(self, cond, flow):
        dtype = self.zero_convs[0].weight.dtype
        H = cond.shape[1]
        cond = cond.to(dtype)
        flow_fwd = flow[..., 0:2]
        flow_bwd = flow[..., 2:4]
        f_first = self._pre(self.first_pre_extractor, cond[..., 3:6])
        f_last = self._pre(self.last_pre_extractor, cond[..., 0:3])

        outputs = []
        for idx in range(len(self.inject_channels)):
            res = H // (8 * (2 ** idx))
            f_first = self.extractors_first[idx](f_first)
            f_last = self.extractors_last[idx](f_last)
            flow_f = resize_and_normalize_flow(flow_fwd, res, res)
            flow_b = resize_and_normalize_flow(flow_bwd, res, res)
            # both directions as one batched splat: the warper is shared
            # and the splat is independent per sample
            flow2 = torch.cat([flow_f, flow_b], dim=0)
            occ2 = compute_occlusion_mask(
                flow2, torch.cat([flow_b, flow_f], dim=0))
            occ_f, occ_b = occ2.chunk(2, dim=0)
            warped2, conf2 = self.wrapper[idx](
                torch.cat([f_first, f_last], dim=0), flow2, mask=occ2)
            warped_first, warped_last = warped2.chunk(2, dim=0)
            conf_f, conf_b = conf2.chunk(2, dim=0)
            fused = soft_fuse(warped_first, warped_last, conf_f, conf_b,
                              occ_f, occ_b)
            outputs.append(self.zero_convs[idx](fused))
        return outputs
