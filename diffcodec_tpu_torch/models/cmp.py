"""CMP (Conditional Motion Propagation): the sparse -> dense flow
decompressor of the codec's 'sparse' mode, and the network its trainer
(`train/cmp_train.py`) trains.

Counterpart: `diffcodec_tpu/models/cmp.py` (`ConvBNRelu` :31, `Bottleneck`
:53, `ResNet50FCN` :77, `AlexNetFCN` :108, `ShallowNet` :151,
`MotionDecoderSkipLayer` :171, `MotionDecoderPlain` :219,
`MotionDecoderFlowNet` :251, `fuse_discrete_flow` :325, `CMP` :491).
DiffCodec's configuration (`resnet50_vip+mpii_liteflow/config.yaml`) is the
default: the dilated ResNet-50 image encoder (output stride 8, skip
features at /2 and /4), the ShallowNet sparse encoder (4 channels -> 16 at
/8), the skip-layer decoder and the 99-bin softmax expectation over +-50
px (198 output channels).  The rep_learning configs' variants are built
beside it: the AlexNet-BN FCN backbones (`alexnet_fcn_32x`, /32, with
ShallowNet at /32; `alexnet_fcn_8x`), which pair only with the plain
decoder, and the plain and FlowNet decoders.

Plain PyTorch: `nn.Conv2d`, `nn.ConvTranspose2d` and a BatchNorm, as XLA
computed these layers for the JAX package (it has no Pallas kernel for
them).  In eval mode the BatchNorm normalises by its running statistics;
in training mode it normalises by the batch's as flax's `nn.BatchNorm`
does (`BatchNorm`), and AlexNet's dropout draws its masks from an explicit
generator (`Dropout`).  NHWC at the module's edges; inside, NCHW views of
channels-last memory.  Submodules carry the torch reference's names, so
the state dict keys are the torch names of `weights.cmp_name_map` and
`cmp_batch_stats_map`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffcodec_tpu_torch.ops.flow import resize_bilinear


class BatchNorm(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (its names and eval mode) with flax's training mode
    (`flax.linen.BatchNorm`, momentum 0.99, epsilon 1e-5): the batch's
    mean and its biased variance E[x^2] - E[x]^2 (clamped at 0) normalise
    the input, and the running statistics move as 0.99 running + 0.01
    batch.  torch's own would keep 0.9 running + 0.1 times the unbiased
    variance.  The statistics are computed in fp32, or in the input's
    dtype where it is wider.  `num_batches_tracked` is left as it is: flax
    keeps no such counter."""

    momentum_flax = 0.99

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
        m = self.momentum_flax
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * var.detach())
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean.reshape(shape)) * mul.reshape(shape)
                + self.bias.reshape(shape)).to(x.dtype)


class Dropout(nn.Module):
    """flax's `nn.Dropout`: in training mode, each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), its mask drawn by
    `mask` from the generator the forward is given; the identity in eval
    mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def mask(self, shape, device,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        return torch.rand(shape, generator=generator,
                          device=device) < 1.0 - self.rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = self.mask(x.shape, x.device, generator)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class ConvBNRelu(nn.Sequential):
    """Conv (padding dilation * (kernel // 2)), BatchNorm, optional ReLU:
    the reference's Sequential, conv at .0 and BatchNorm at .1."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, use_relu: bool = True,
                 use_bias: bool = False):
        layers = [nn.Conv2d(cin, cout, kernel, stride,
                            dilation * (kernel // 2), dilation,
                            bias=use_bias),
                  BatchNorm(cout)]
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
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            BatchNorm(planes * 4)) if downsample else None)

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
        self.bn1 = BatchNorm(64)
        self.layer1 = _layer(64, 64, 3, 1, 1)        # /4, 256 channels
        self.layer2 = _layer(256, 128, 4, 2, 1)      # /8, 512
        self.layer3 = _layer(512, 256, 6, 1, 2)      # /8 dilated, 1024
        self.layer4 = _layer(1024, 512, 3, 1, 4)     # /8 dilated, 2048
        self.conv5 = nn.Conv2d(2048, output_dim, 1)

    def forward(self, img, generator: Optional[torch.Generator] = None):
        del generator  # no dropout in this backbone
        conv1 = F.relu(self.bn1(self.conv1(img)))
        # -inf padding, as flax's max_pool pads
        x = F.max_pool2d(conv1, 3, 2, 1)
        layer1 = self.layer1(x)
        x = self.layer4(self.layer3(self.layer2(layer1)))
        return self.conv5(x), (img, conv1, layer1)


class AlexNetFCN(nn.Module):
    """AlexNet-BN fully-convolutional image encoder
    (`cmp/models/backbone/alexnet.py:4-76`): strides (4, 2, 2, 2) for
    alexnet_fcn_32x, (2, 2, 2, 1) for alexnet_fcn_8x; 3 x 3 max-pools
    padded by 1; fc6 (4096 channels, 3 x 3) and fc7 (4096, 1 x 1), each
    followed by dropout 0.5 in training mode; a 1 x 1 conv8.  No skip
    features, so it pairs with the plain decoder only."""

    def __init__(self, output_dim: int = 256,
                 strides: Sequence[int] = (4, 2, 2, 2)):
        super().__init__()
        self.strides = tuple(strides)
        self.conv1 = ConvBNRelu(3, 96, 11, stride=strides[0], use_bias=True)
        self.conv2 = ConvBNRelu(96, 256, 5, use_bias=True)
        self.conv3 = ConvBNRelu(256, 384, 3, use_bias=True)
        self.conv4 = ConvBNRelu(384, 384, 3, use_bias=True)
        self.conv5 = ConvBNRelu(384, 256, 3, use_bias=True)
        self.fc6 = ConvBNRelu(256, 4096, 3, use_bias=True)
        self.drop6 = Dropout(0.5)
        self.fc7 = ConvBNRelu(4096, 4096, 1, use_bias=True)
        self.drop7 = Dropout(0.5)
        self.conv8 = nn.Conv2d(4096, output_dim, 1)

    def forward(self, img, generator: Optional[torch.Generator] = None):
        s = self.strides
        x = F.max_pool2d(self.conv1(img), 3, s[1], 1)
        x = F.max_pool2d(self.conv2(x), 3, s[2], 1)
        x = self.conv5(self.conv4(self.conv3(x)))
        x = F.max_pool2d(x, 3, s[3], 1)
        x = self.drop6(self.fc6(x), generator)
        x = self.drop7(self.fc7(x), generator)
        return self.conv8(x), None


class ShallowNet(nn.Module):
    """Sparse-flow encoder: flow + mask (4 channels) -> `output_dim`
    channels at /8 (strides (2, 2, 2), shallownet8x) or /32 ((2, 2, 8),
    shallownet32x): a strided 5 x 5 conv, a max-pool and a 3 x 3 conv, then
    an average pool."""

    def __init__(self, output_dim: int = 16,
                 strides: Sequence[int] = (2, 2, 2)):
        super().__init__()
        s = strides
        self.features = nn.Sequential(
            *ConvBNRelu(4, 16, 5, stride=s[0], use_bias=True),
            nn.MaxPool2d(s[1], s[1]),
            *ConvBNRelu(16, output_dim, 3, use_bias=True),
            nn.AvgPool2d(s[2], s[2]))

    def forward(self, x):
        return self.features(x)


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear, align_corners=True, on an NCHW view."""
    return resize_bilinear(x.permute(0, 2, 3, 1), h, w,
                           align_corners=True).permute(0, 3, 1, 2)


def _branch(cin: int, pool: int, n_convs: int) -> nn.Sequential:
    """A decoder branch: a max-pool by `pool` (floored, as flax pools)
    where it is above 1, then `n_convs` 3 x 3 conv+BN+ReLU to 128
    channels, flattened into one Sequential as the reference's."""
    layers = [nn.MaxPool2d(pool, pool)] if pool > 1 else []
    for i in range(n_convs):
        layers += [*ConvBNRelu(cin if i == 0 else 128, 128, use_bias=True)]
    return nn.Sequential(*layers)


def _pooled_branches(dec: nn.Module, x, pools) -> list:
    """Each `decoder{p}` branch of `dec` on x, resized back to x's size
    where it was pooled."""
    H, W = x.shape[2:]
    return [getattr(dec, f"decoder{p}")(x) if p == 1 else
            _resize(getattr(dec, f"decoder{p}")(x), H, W) for p in pools]


class MotionDecoderSkipLayer(nn.Module):
    """Four branches of three 3x3 conv+BN+ReLU on the /8 features, three of
    them max-pooled by 2, 4 and 8 first and resized back; fused to 256
    channels, then up through the image's /4 and /2 skip features; a 1x1
    head to `output_dim` bin logits at /2."""

    def __init__(self, input_dim: int = 272, output_dim: int = 198):
        super().__init__()
        for pool in (1, 2, 4, 8):
            setattr(self, f"decoder{pool}", _branch(input_dim, pool, 3))
        self.fusion8 = ConvBNRelu(512, 256, use_bias=True)
        self.skipconv4 = ConvBNRelu(256, 128, use_bias=True)
        self.fusion4 = ConvBNRelu(384, 128, use_bias=True)
        self.skipconv2 = ConvBNRelu(64, 32, use_bias=True)
        self.fusion2 = ConvBNRelu(160, 64, use_bias=True)
        self.head = nn.Conv2d(64, output_dim, 1)

    def forward(self, x, skip_feat):
        _, conv1, layer1 = skip_feat
        f8 = self.fusion8(torch.cat(_pooled_branches(self, x, (1, 2, 4, 8)),
                                    dim=1))
        f8_up = _resize(f8, *layer1.shape[2:])
        f4 = self.fusion4(torch.cat([f8_up, self.skipconv4(layer1)], dim=1))
        f4_up = _resize(f4, *conv1.shape[2:])
        f2 = self.fusion2(torch.cat([f4_up, self.skipconv2(conv1)], dim=1))
        return self.head(f2)


class MotionDecoderPlain(nn.Module):
    """The decoder without skip connections
    (`cmp/models/modules/decoder.py:5-93`): per `combo` entry c, a
    max-pool by c, two 3x3 conv+BN+ReLU and a resize back; concatenated
    and a 1x1 head, at the features' stride."""

    def __init__(self, input_dim: int = 272, output_dim: int = 198,
                 combo: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.combo = tuple(combo)
        for c in self.combo:
            assert c in (1, 2, 4, 8), f"invalid combo {self.combo}"
            setattr(self, f"decoder{c}", _branch(input_dim, c, 2))
        self.head = nn.Conv2d(128 * len(self.combo), output_dim, 1)

    def forward(self, x, skip_feat=None):
        del skip_feat  # no skip connections
        return self.head(torch.cat(_pooled_branches(self, x, self.combo),
                                   dim=1))


def _deconv(cin: int, cout: int) -> nn.Sequential:
    """ConvTranspose2d(4, 2, 1) with a bias, then LeakyReLU(0.1)."""
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1),
                         nn.LeakyReLU(0.1))


class MotionDecoderFlowNet(nn.Module):
    """The skip decoder's four pooled branches fused to 256 channels at /8,
    then a FlowNet-style coarse-to-fine head through the image's skips
    (`cmp/models/modules/decoder.py:216-356`): at each scale a 3x3
    `predict_flow` with a bias, a `deconv` (transposed conv 4/2/1 with a
    bias, LeakyReLU 0.1) of the features and an `upsampled_flow` (the same
    transposed conv without a bias) of the prediction, concatenated with
    the skip feature of the next scale.  Returns the bin logits at 4
    scales, finest first: [flow1, flow2, flow4, flow8]."""

    def __init__(self, input_dim: int = 272, output_dim: int = 198):
        super().__init__()
        od = output_dim
        for pool in (1, 2, 4, 8):
            setattr(self, f"decoder{pool}", _branch(input_dim, pool, 3))
        self.fusion8 = ConvBNRelu(512, 256, use_bias=True)
        c4, c2, c1 = 256 + 128 + od, 64 + 128 + od, 3 + 64 + od
        for s, cin in ((8, 256), (4, c4), (2, c2), (1, c1)):
            setattr(self, f"predict_flow{s}", nn.Conv2d(cin, od, 3, 1, 1))
        self.deconv8 = _deconv(256, 128)
        self.deconv4 = _deconv(c4, 128)
        self.deconv2 = _deconv(c2, 64)
        for s, d in ((8, 4), (4, 2), (2, 1)):
            setattr(self, f"upsampled_flow{s}_to_{d}",
                    nn.ConvTranspose2d(od, od, 4, 2, 1, bias=False))

    def forward(self, x, skip_feat):
        img, conv1, layer1 = skip_feat
        feat8 = self.fusion8(torch.cat(
            _pooled_branches(self, x, (1, 2, 4, 8)), dim=1))
        flow8 = self.predict_flow8(feat8)
        concat4 = torch.cat([layer1, self.deconv8(feat8),
                             self.upsampled_flow8_to_4(flow8)], dim=1)
        flow4 = self.predict_flow4(concat4)
        concat2 = torch.cat([conv1, self.deconv4(concat4),
                             self.upsampled_flow4_to_2(flow4)], dim=1)
        flow2 = self.predict_flow2(concat2)
        concat1 = torch.cat([img, self.deconv2(concat2),
                             self.upsampled_flow2_to_1(flow2)], dim=1)
        return [self.predict_flow1(concat1), flow2, flow4, flow8]


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
    [B, H, W, 2] in pixels.  H and W multiples of 8 (of 32 for
    alexnet_fcn_32x).  The fused flow is resized back to the input with
    align_corners=True (`cmp/models/cmp.py:30-43`).  `backbone` is
    'resnet50', 'alexnet_fcn_32x' or 'alexnet_fcn_8x' (the AlexNets with
    decoder 'plain' only), `decoder` 'skip', 'plain' (over `combo`) or
    'flownet'.  In training mode its BatchNorms normalise by the batch and
    move their running statistics (`BatchNorm`)."""

    def __init__(self, img_enc_dim: int = 256, sparse_enc_dim: int = 16,
                 nbins: int = 99, fmax: float = 50.0,
                 backbone: str = "resnet50", decoder: str = "skip",
                 combo: Sequence[int] = (1, 2, 4)):
        super().__init__()
        self.nbins, self.fmax = nbins, fmax
        self.backbone, self.decoder, self.combo = backbone, decoder, tuple(
            combo)
        if backbone == "resnet50":
            self.image_encoder = ResNet50FCN(img_enc_dim)
            sp_strides = (2, 2, 2)           # shallownet8x
        elif backbone in ("alexnet_fcn_32x", "alexnet_fcn_8x"):
            is32 = backbone.endswith("32x")
            self.image_encoder = AlexNetFCN(
                img_enc_dim, (4, 2, 2, 2) if is32 else (2, 2, 2, 1))
            # alexnet_fcn_32x pairs with shallownet32x (config.yaml:12-13)
            sp_strides = (2, 2, 8) if is32 else (2, 2, 2)
            if decoder != "plain":
                raise ValueError("alexnet backbone has no skip features; "
                                 "use decoder='plain' "
                                 "(cmp/models/backbone/alexnet.py:62-63)")
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.flow_encoder = ShallowNet(sparse_enc_dim, sp_strides)
        dims = (img_enc_dim + sparse_enc_dim, 2 * nbins)
        if decoder == "skip":
            self.flow_decoder = MotionDecoderSkipLayer(*dims)
        elif decoder == "plain":
            self.flow_decoder = MotionDecoderPlain(*dims, combo=self.combo)
        elif decoder == "flownet":
            self.flow_decoder = MotionDecoderFlowNet(*dims)
        else:
            raise ValueError(f"unknown decoder {decoder!r}")

    def logits(self, image, sparse,
               generator: Optional[torch.Generator] = None):
        """The decoder's bin logits, NHWC [B, h, w, 2 * nbins] (at /2 for
        the skip decoder, at the features' stride for the plain one), the
        DiscreteLoss's input; a list of 4 scales, finest first, for the
        flownet decoder.  `generator` draws the AlexNet's dropout masks in
        training mode."""
        img_enc, skip = self.image_encoder(image.permute(0, 3, 1, 2),
                                           generator)
        flow_enc = self.flow_encoder(sparse.permute(0, 3, 1, 2))
        dec = self.flow_decoder(torch.cat([img_enc, flow_enc], dim=1), skip)
        if isinstance(dec, list):
            return [d.permute(0, 2, 3, 1) for d in dec]
        return dec.permute(0, 2, 3, 1)

    def forward(self, image, sparse):
        dec = self.logits(image, sparse)
        if isinstance(dec, list):
            dec = dec[0]  # flownet: the finest scale, at the image's size
        flow = fuse_discrete_flow(dec, self.nbins, self.fmax)
        H, W = image.shape[1:3]
        if tuple(flow.shape[1:3]) != (H, W):
            flow = resize_bilinear(flow, H, W, align_corners=True)
        return flow
