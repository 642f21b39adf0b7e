"""CMP (Conditional Motion Propagation): the sparse -> dense flow
decompressor of the codec's 'sparse' mode.

Counterpart: `diffcodec_tpu/models/cmp.py` (`ConvBNRelu` :31, `Bottleneck`
:53, `ResNet50FCN` :77, `ShallowNet` :151, `MotionDecoderSkipLayer` :171,
`fuse_discrete_flow` :325, `CMP` :491) in DiffCodec's configuration
(`resnet50_vip+mpii_liteflow/config.yaml`): the dilated ResNet-50 image
encoder (output stride 8, skip features at /2 and /4), the ShallowNet
sparse encoder (4 channels -> 16 at /8), the skip-layer decoder and the
99-bin softmax expectation over +-50 px (198 output channels).

Plain PyTorch: `nn.Conv2d` and `nn.BatchNorm2d` in eval mode, as XLA
computed these layers for the JAX package (it has no Pallas kernel for
them).  NHWC at the module's edges; inside, NCHW views of channels-last
memory.  Submodules carry the torch reference's names, so the state dict
keys are the torch names of `weights.cmp_name_map` and
`cmp_batch_stats_map`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffcodec_tpu_torch.ops.flow import resize_bilinear


class ConvBNRelu(nn.Sequential):
    """Conv (padding dilation * (kernel // 2)), BatchNorm, optional ReLU:
    the reference's Sequential, conv at .0 and BatchNorm at .1."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, use_relu: bool = True,
                 use_bias: bool = False):
        layers = [nn.Conv2d(cin, cout, kernel, stride,
                            dilation * (kernel // 2), dilation,
                            bias=use_bias),
                  nn.BatchNorm2d(cout)]
        if use_relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class Bottleneck(nn.Module):
    """ResNet bottleneck (1x1, 3x3 with stride and dilation, 1x1 to
    4 planes), with a 1x1 projection of the identity where `downsample`."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _layer(cin: int, planes: int, blocks: int, stride: int,
           dilation: int) -> nn.Sequential:
    return nn.Sequential(*[
        Bottleneck(cin if b == 0 else planes * 4, planes,
                   stride if b == 0 else 1, dilation, downsample=b == 0)
        for b in range(blocks)])


class ResNet50FCN(nn.Module):
    """Dilated ResNet-50 image encoder: features at /8 (layers 3 and 4
    dilated by 2 and 4 instead of strided), projected to `output_dim`, and
    the skip features (image, conv1 at /2 with 64 channels, layer1 at /4
    with 256)."""

    def __init__(self, output_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = _layer(64, 64, 3, 1, 1)        # /4, 256 channels
        self.layer2 = _layer(256, 128, 4, 2, 1)      # /8, 512
        self.layer3 = _layer(512, 256, 6, 1, 2)      # /8 dilated, 1024
        self.layer4 = _layer(1024, 512, 3, 1, 4)     # /8 dilated, 2048
        self.conv5 = nn.Conv2d(2048, output_dim, 1)

    def forward(self, img):
        conv1 = F.relu(self.bn1(self.conv1(img)))
        # -inf padding, as flax's max_pool pads
        x = F.max_pool2d(conv1, 3, 2, 1)
        layer1 = self.layer1(x)
        x = self.layer4(self.layer3(self.layer2(layer1)))
        return self.conv5(x), (img, conv1, layer1)


class ShallowNet(nn.Module):
    """Sparse-flow encoder (shallownet8x): flow + mask (4 channels) -> 16
    channels at /8."""

    def __init__(self, output_dim: int = 16):
        super().__init__()
        self.features = nn.Sequential(
            *ConvBNRelu(4, 16, 5, stride=2, use_bias=True),
            nn.MaxPool2d(2, 2),
            *ConvBNRelu(16, output_dim, 3, use_bias=True),
            nn.AvgPool2d(2, 2))

    def forward(self, x):
        return self.features(x)


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear, align_corners=True, on an NCHW view."""
    return resize_bilinear(x.permute(0, 2, 3, 1), h, w,
                           align_corners=True).permute(0, 3, 1, 2)


class MotionDecoderSkipLayer(nn.Module):
    """Four branches of three 3x3 conv+BN+ReLU on the /8 features, three of
    them max-pooled by 2, 4 and 8 first (floored, as flax pools) and resized
    back; fused to 256 channels, then up through the image's /4 and /2 skip
    features; a 1x1 head to `output_dim` bin logits at /2."""

    def __init__(self, input_dim: int = 272, output_dim: int = 198):
        super().__init__()

        def branch(pool):
            layers = [nn.MaxPool2d(pool, pool)] if pool > 1 else []
            for cin in (input_dim, 128, 128):
                layers += [*ConvBNRelu(cin, 128, use_bias=True)]
            return nn.Sequential(*layers)

        self.decoder1 = branch(1)
        self.decoder2 = branch(2)
        self.decoder4 = branch(4)
        self.decoder8 = branch(8)
        self.fusion8 = ConvBNRelu(512, 256, use_bias=True)
        self.skipconv4 = ConvBNRelu(256, 128, use_bias=True)
        self.fusion4 = ConvBNRelu(384, 128, use_bias=True)
        self.skipconv2 = ConvBNRelu(64, 32, use_bias=True)
        self.fusion2 = ConvBNRelu(160, 64, use_bias=True)
        self.head = nn.Conv2d(64, output_dim, 1)

    def forward(self, x, skip_feat):
        _, conv1, layer1 = skip_feat
        H, W = x.shape[2:]
        branches = [self.decoder1(x)] + [
            _resize(d(x), H, W)
            for d in (self.decoder2, self.decoder4, self.decoder8)]
        f8 = self.fusion8(torch.cat(branches, dim=1))
        f8_up = _resize(f8, *layer1.shape[2:])
        f4 = self.fusion4(torch.cat([f8_up, self.skipconv4(layer1)], dim=1))
        f4_up = _resize(f4, *conv1.shape[2:])
        f2 = self.fusion2(torch.cat([f4_up, self.skipconv2(conv1)], dim=1))
        return self.head(f2)


def bin_centres(nbins: int = 99, fmax: float = 50.0) -> np.ndarray:
    """The bins' centres in fp32, as XLA compiles the JAX package's
    `arange * step - fmax + step / 2` under jit: it folds the two
    constants into one (step / 2 - fmax), then one product and one sum a
    bin.  Evaluated left to right instead, 7 of the 99 centres differ by
    up to 2^-18."""
    step = np.float32(2 * fmax / float(nbins))
    offset = np.float32(step / 2) - np.float32(fmax)
    return np.arange(nbins, dtype=np.float32) * step + offset


def fuse_discrete_flow(flow_prob: torch.Tensor, nbins: int = 99,
                       fmax: float = 50.0) -> torch.Tensor:
    """Bin logits [B, H, W, 2 * nbins] -> flow [B, H, W, 2]: per axis a
    softmax over the bins and the expectation of their centres
    (`cmp/utils/visualize_utils.py:13-19`)."""
    mesh = torch.from_numpy(bin_centres(nbins, fmax)).to(flow_prob.device)
    px = torch.softmax(flow_prob[..., :nbins].float(), dim=-1)
    py = torch.softmax(flow_prob[..., nbins:].float(), dim=-1)
    return torch.stack([(px * mesh).sum(-1), (py * mesh).sum(-1)], dim=-1)


class CMP(nn.Module):
    """image [B, H, W, 3] + sparse flow and mask [B, H, W, 4] -> dense flow
    [B, H, W, 2] in pixels.  H and W multiples of 8.  The bin logits come
    at /2 and the fused flow is resized back with align_corners=True
    (`cmp/models/cmp.py:30-43`)."""

    def __init__(self, img_enc_dim: int = 256, sparse_enc_dim: int = 16,
                 nbins: int = 99, fmax: float = 50.0):
        super().__init__()
        self.nbins, self.fmax = nbins, fmax
        self.image_encoder = ResNet50FCN(img_enc_dim)
        self.flow_encoder = ShallowNet(sparse_enc_dim)
        self.flow_decoder = MotionDecoderSkipLayer(
            img_enc_dim + sparse_enc_dim, 2 * nbins)

    def logits(self, image, sparse):
        """The decoder's bin logits, NHWC [B, H / 2, W / 2, 2 * nbins]."""
        img_enc, skip = self.image_encoder(image.permute(0, 3, 1, 2))
        flow_enc = self.flow_encoder(sparse.permute(0, 3, 1, 2))
        dec = self.flow_decoder(torch.cat([img_enc, flow_enc], dim=1), skip)
        return dec.permute(0, 2, 3, 1)

    def forward(self, image, sparse):
        flow = fuse_discrete_flow(self.logits(image, sparse), self.nbins,
                                  self.fmax)
        H, W = image.shape[1:3]
        return resize_bilinear(flow, H, W, align_corners=True)
