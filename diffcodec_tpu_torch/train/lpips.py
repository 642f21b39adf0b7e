"""LPIPS (alex): the perceptual metric and training loss.

Counterpart: `diffcodec_tpu/train/lpips.py` (`AlexNetFeatures` :31,
`normalize_tensor` :64, `LPIPS` :71), the reference's NormFixLPIPS
(`controlnet/lpips_loss.py:32-107`): the LPIPS v0.1 shift and scale of
[-1, 1] inputs, torchvision's AlexNet features (the five ReLU outputs; its
max pools 3 x 3 stride 2 without padding), each feature map unit-normalised
over channels with the epsilon inside the sum (`sum(x * x + eps)`, so C
eps under the square root), squared differences, a 1 x 1 conv per layer,
the spatial mean, summed over layers.

Plain PyTorch (cuDNN on the card), as XLA computed these layers for the
JAX package.  NHWC at the module's edges.  Submodules carry the torch
`lpips` package's names (`net.slice{1..5}.<index>`, `lin{k}.model.1`), so
the state dict keys are the torch names of `weights.lpips_alex_name_map`;
the lins' dropout slot (`model.0`) is an identity, as the package's is in
eval mode.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn

from diffcodec_tpu_torch.eval.metrics import require_fp32_on

# LPIPS v0.1 scaling layer (shift and scale of [-1, 1] inputs)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_ALEX_CHANNELS = (64, 192, 384, 256, 256)


def _slice(*layers) -> nn.Sequential:
    """(index, module) pairs: torchvision's `features` indices."""
    return nn.Sequential(OrderedDict((str(i), m) for i, m in layers))


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet.features, returning the five ReLU outputs (NCHW
    in, NCHW out)."""

    def __init__(self):
        super().__init__()
        c = _ALEX_CHANNELS
        self.slice1 = _slice((0, nn.Conv2d(3, c[0], 11, 4, 2)),
                             (1, nn.ReLU()))
        self.slice2 = _slice((2, nn.MaxPool2d(3, 2)),
                             (3, nn.Conv2d(c[0], c[1], 5, padding=2)),
                             (4, nn.ReLU()))
        self.slice3 = _slice((5, nn.MaxPool2d(3, 2)),
                             (6, nn.Conv2d(c[1], c[2], 3, padding=1)),
                             (7, nn.ReLU()))
        self.slice4 = _slice((8, nn.Conv2d(c[2], c[3], 3, padding=1)),
                             (9, nn.ReLU()))
        self.slice5 = _slice((10, nn.Conv2d(c[3], c[4], 3, padding=1)),
                             (11, nn.ReLU()))

    def forward(self, x):
        outs = []
        for s in (self.slice1, self.slice2, self.slice3, self.slice4,
                  self.slice5):
            x = s(x)
            outs.append(x)
        return outs


def normalize_tensor(x: torch.Tensor, eps: float = 1e-8,
                     dim: int = 1) -> torch.Tensor:
    """Unit-normalise over channels (`dim`) with eps inside the sum."""
    return x / torch.sqrt(torch.sum(x * x + eps, dim=dim, keepdim=True))


class NetLinLayer(nn.Module):
    """A layer's learned 1 x 1 weighting (no bias)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


class LPIPS(nn.Module):
    """NormFixLPIPS(alex): images [B, H, W, 3] in [-1, 1] -> [B]."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for k, c in enumerate(_ALEX_CHANNELS):
            setattr(self, f"lin{k}", NetLinLayer(c))

    def features(self, x: torch.Tensor):
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        x = ((x - shift) / scale).permute(0, 3, 1, 2)
        return self.net(x.contiguous(memory_format=torch.channels_last))

    def forward(self, in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
        f0, f1 = self.features(in0), self.features(in1)
        val = 0.0
        for k, (a, b) in enumerate(zip(f0, f1)):
            d = (normalize_tensor(a) - normalize_tensor(b)) ** 2
            val = val + getattr(self, f"lin{k}")(d).mean(dim=(1, 2, 3))
        return val


def make_lpips_fn(model: LPIPS, batch_size: int = 8, device="cuda"):
    """`eval.metrics.calculate_metrics_batch`'s lpips_fn: (pred, orig)
    tensors [N, H, W, 3] in [-1, 1] -> [N] distances, `batch_size` pairs a
    forward on `device` in fp32, no gradient.  `model` must already be
    fp32 on `device` (else `ValueError`); it is put in eval mode."""
    require_fp32_on(model, device)
    model = model.eval()

    @torch.no_grad()
    def lpips_fn(pred: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            model(pred[i:i + batch_size].to(device).float(),
                  orig[i:i + batch_size].to(device).float())
            for i in range(0, len(pred), batch_size)])

    return lpips_fn
