"""Warped-conditioning feature extractor and FDN, NHWC.

Counterparts in `diffcodec_tpu/models/extractors.py`: `FDN` (:82-94),
`FeatureWarperSoftsplat` (:97-123), `BiDirFeatureExtractor` (:126-197),
and the residual ControlNet's `BiDirResidueExtractor` (:200-270) and
`WarpExtractor` (:273-290).  Attribute names follow the reference's
`Bi_Dir_FeatureExtractor`, `Bi_Dir_ResidueExtractor` and `WarpExtractor`
(the name maps in `diffcodec_tpu_torch/weights.py`).

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

from diffcodec_tpu_torch.models.layers import ConvBlock, GroupNorm32, conv3x3
from diffcodec_tpu_torch.ops.conv import conv_silu_chain
from diffcodec_tpu_torch.ops.flow import (compute_occlusion_mask,
                                          resize_and_normalize_flow,
                                          resize_flow_by_factor, soft_fuse)
from diffcodec_tpu_torch.ops.softsplat import softsplat

# (out channels, stride) of the conv3x3 + SiLU pre-extractor stages
PRE_EXTRACTOR = ((16, 1), (32, 2), (32, 1), (64, 2), (64, 1))
# the residue extractor's, with the extra 32-channel stage
RESIDUE_PRE_EXTRACTOR = ((32, 1), (64, 2), (64, 2))


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


def _pre_extractor(specs=PRE_EXTRACTOR) -> nn.Sequential:
    layers, cin = [], 3
    for ch, stride in specs:
        layers += [conv3x3(cin, ch, stride=stride), nn.SiLU()]
        cin = ch
    return nn.Sequential(*layers)


def _run_pre(chain: nn.Sequential, x):
    convs = [m for m in chain if isinstance(m, nn.Conv2d)]
    return conv_silu_chain(x, [c.weight for c in convs],
                           [c.bias for c in convs],
                           [c.stride[0] for c in convs])


def _strided_extractors(cins, halves) -> nn.ModuleList:
    return nn.ModuleList([nn.Sequential(conv3x3(ci, h, stride=2), nn.SiLU())
                          for ci, h in zip(cins, halves)])


def _warp_both(warper, feat_a, feat_b, flow_a, flow_b):
    """Both directions as one batched splat per op (the warper is shared
    and the splat is independent per sample); occ_a splats flow_a along
    flow_b.  Returns (warped_a, warped_b, conf_a, conf_b, occ_a, occ_b)."""
    flow2 = torch.cat([flow_a, flow_b], dim=0)
    occ2 = compute_occlusion_mask(flow2, torch.cat([flow_b, flow_a], dim=0))
    warped2, conf2 = warper(torch.cat([feat_a, feat_b], dim=0), flow2,
                            mask=occ2)
    return (*warped2.chunk(2, dim=0), *conf2.chunk(2, dim=0),
            *occ2.chunk(2, dim=0))


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
        self.extractors_first = _strided_extractors(cins, halves)
        self.extractors_last = _strided_extractors(cins, halves)
        self.wrapper = nn.ModuleList([FeatureWarperSoftsplat(h)
                                      for h in halves])
        self.zero_convs = nn.ModuleList([
            conv3x3(h, c) for h, c in zip(halves, self.inject_channels)])

    def forward(self, cond, flow):
        dtype = self.zero_convs[0].weight.dtype
        H = cond.shape[1]
        cond = cond.to(dtype)
        flow_fwd = flow[..., 0:2]
        flow_bwd = flow[..., 2:4]
        f_first = _run_pre(self.first_pre_extractor, cond[..., 3:6])
        f_last = _run_pre(self.last_pre_extractor, cond[..., 0:3])

        outputs = []
        for idx in range(len(self.inject_channels)):
            res = H // (8 * (2 ** idx))
            f_first = self.extractors_first[idx](f_first)
            f_last = self.extractors_last[idx](f_last)
            flow_f = resize_and_normalize_flow(flow_fwd, res, res)
            flow_b = resize_and_normalize_flow(flow_bwd, res, res)
            fused = soft_fuse(*_warp_both(self.wrapper[idx], f_first, f_last,
                                          flow_f, flow_b))
            outputs.append(self.zero_convs[idx](fused))
        return outputs


class BiDirResidueExtractor(nn.Module):
    """The residual ControlNet's extractor: anchors and flows -> the
    injection pyramid.

    Unlike `BiDirFeatureExtractor`: separate prev/next pre-extractors with
    the extra 32-channel stage; the flow resized and divided by the spatial
    factor, then refined by a grouped (per-component) 3x3 conv shared by
    both directions; occlusion from the refined flows; the two warps fused
    without the occlusion fallback.
    """

    def __init__(self, inject_channels: Sequence[int] = (320, 320, 640,
                                                         1280)):
        super().__init__()
        self.inject_channels = tuple(inject_channels)
        self.prev_pre = _pre_extractor(RESIDUE_PRE_EXTRACTOR)
        self.next_pre = _pre_extractor(RESIDUE_PRE_EXTRACTOR)
        halves = [c // 2 for c in self.inject_channels]
        cins = [RESIDUE_PRE_EXTRACTOR[-1][0]] + halves[:-1]
        self.prev_pyramids = _strided_extractors(cins, halves)
        self.next_pyramids = _strided_extractors(cins, halves)
        self.flow_refiners = nn.ModuleList([conv3x3(2, 2, groups=2)
                                            for _ in halves])
        self.warpers = nn.ModuleList([FeatureWarperSoftsplat(h)
                                      for h in halves])
        self.zero_convs = nn.ModuleList([
            conv3x3(h, c) for h, c in zip(halves, self.inject_channels)])

    def forward(self, prev_frame, next_frame, flow_fwd, flow_bwd):
        dtype = self.zero_convs[0].weight.dtype
        H = prev_frame.shape[1]
        f_prev = _run_pre(self.prev_pre, prev_frame.to(dtype))
        f_next = _run_pre(self.next_pre, next_frame.to(dtype))
        outputs = []
        for idx in range(len(self.inject_channels)):
            res = H // (8 * (2 ** idx))
            f_prev = self.prev_pyramids[idx](f_prev)
            f_next = self.next_pyramids[idx](f_next)
            refiner = self.flow_refiners[idx]
            flow_f = refiner(resize_flow_by_factor(flow_fwd, res, res)
                             .to(dtype))
            flow_b = refiner(resize_flow_by_factor(flow_bwd, res, res)
                             .to(dtype))
            warped_p, warped_n, conf_p, conf_n, _, _ = _warp_both(
                self.warpers[idx], f_prev, f_next, flow_f, flow_b)
            fused = soft_fuse(warped_p, warped_n, conf_p, conf_n)
            outputs.append(self.zero_convs[idx](fused))
        return outputs


class WarpExtractor(nn.Module):
    """Pyramid features of the pre-warped RGB prediction: a ConvBlock at
    stride 4 to 64 channels, then one ConvBlock a scale at stride 2 to the
    injection width, each followed by a zero conv."""

    def __init__(self, inject_channels: Sequence[int] = (320, 320, 640,
                                                         1280)):
        super().__init__()
        self.inject_channels = tuple(inject_channels)
        self.enc1 = ConvBlock(3, 64, stride=4)
        cin = 64
        for i, ch in enumerate(self.inject_channels):
            setattr(self, f"enc{i + 2}", ConvBlock(cin, ch, stride=2))
            cin = ch
        self.zero_convs = nn.ModuleList([conv3x3(c, c)
                                         for c in self.inject_channels])

    def forward(self, x):
        h = self.enc1(x)
        outputs = []
        for idx in range(len(self.inject_channels)):
            h = getattr(self, f"enc{idx + 2}")(h)
            outputs.append(self.zero_convs[idx](h))
        return outputs
