"""DualFlowControlNet, NHWC.

Counterpart: `diffcodec_tpu/models/controlnet.py` (`ControlNetTrunk`,
`DualFlowControlNet`, :42-139).  A ControlNet is the UNet's down path
(conv_in, down blocks, mid block) with zero-conv residual heads, plus FDN
injection of the warped conditioning pyramid after conv_in and after every
down block.  Wiring kept from the reference:
  * FDN acts on the running sample AFTER its residuals are collected, so
    the residual list holds pre-FDN features;
  * the deepest FDN (and pyramid level) serves every block past the
    pyramid's depth (the last two blocks of SD-1.5);
  * the residual heads are 1x1 convs scaled by `conditioning_scale`, cast
    to the compute dtype.
`extract_pyramid` (timestep-independent) and `backbone` are separate so the
sampler computes the pyramid once per decode.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffcodec_tpu_torch.config import ControlNetConfig
from diffcodec_tpu_torch.models.extractors import FDN, BiDirFeatureExtractor
from diffcodec_tpu_torch.models.layers import conv1x1
from diffcodec_tpu_torch.models.unet2d_condition import UNetTrunk

FDN_NAMES = ("fdn64", "fdn32", "fdn16", "fdn08")


class ControlNetTrunk(UNetTrunk):
    """conv_in + FDN-injected down path + mid block + zero-conv heads; the
    injection pyramid comes from the caller."""

    def __init__(self, cfg: ControlNetConfig = ControlNetConfig()):
        super().__init__(cfg.unet)
        self.cfg = cfg
        chans = cfg.unet.block_out_channels
        self.inject_channels = tuple(cfg.inject_channels)
        for lvl, label_nc in enumerate(self.inject_channels):
            # level 0 normalises conv_in's output, level l >= 1 the output
            # of down block l - 1
            norm_nc = chans[0] if lvl == 0 else chans[lvl - 1]
            setattr(self, FDN_NAMES[lvl], FDN(norm_nc, label_nc))
        heads = [chans[0]]
        for i, ch in enumerate(chans):
            heads += [ch] * cfg.unet.layers_per_block
            if i != len(chans) - 1:
                heads.append(ch)
        self.controlnet_down_blocks = nn.ModuleList([conv1x1(ch, ch)
                                                     for ch in heads])
        self.controlnet_mid_block = conv1x1(chans[-1], chans[-1])

    def _fdn(self, lvl: int) -> FDN:
        return getattr(self, FDN_NAMES[lvl])

    def forward(self, sample, timesteps, encoder_hidden_states, pyramid,
                conditioning_scale=1.0):
        n_lvl = len(self.inject_channels)
        temb = self.time_emb(timesteps, sample.shape[0])
        context = encoder_hidden_states.to(self.dtype)
        x = self._fdn(0)(self.conv_in(sample.to(self.dtype)), pyramid[0])
        res_stack = [x]
        for i, block in enumerate(self.down_blocks):
            x, res_out = block(x, temb, context)
            res_stack.extend(res_out)
            lvl = min(i + 1, n_lvl - 1)
            x = self._fdn(lvl)(x, pyramid[lvl])
        x = self.mid_block(x, temb, context)
        scale = torch.as_tensor(conditioning_scale, dtype=torch.float32,
                                device=x.device).to(x.dtype)
        down = tuple(head(r) * scale for head, r in
                     zip(self.controlnet_down_blocks, res_stack))
        return down, self.controlnet_mid_block(x) * scale


class DualFlowControlNet(ControlNetTrunk):
    """ControlNet conditioned on two anchors and bidirectional flow."""

    def __init__(self, cfg: ControlNetConfig = ControlNetConfig()):
        super().__init__(cfg)
        self.feature_extractor = BiDirFeatureExtractor(cfg.inject_channels)

    def extract_pyramid(self, controlnet_cond, flow_cond):
        """cond [B,H,W,6], flow [B,H,W,4] -> the injection pyramid."""
        return self.feature_extractor(controlnet_cond, flow_cond)

    def backbone(self, sample, timesteps, encoder_hidden_states, pyramid,
                 conditioning_scale=1.0):
        return ControlNetTrunk.forward(self, sample, timesteps,
                                       encoder_hidden_states, pyramid,
                                       conditioning_scale)

    def forward(self, sample, timesteps, encoder_hidden_states,
                controlnet_cond, flow_cond, conditioning_scale=1.0):
        pyramid = self.extract_pyramid(controlnet_cond, flow_cond)
        return self.backbone(sample, timesteps, encoder_hidden_states,
                             pyramid, conditioning_scale)
