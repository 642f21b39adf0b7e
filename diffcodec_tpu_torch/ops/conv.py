"""Convolutions on NHWC tensors with torch-layout (OIHW) weights.

Plain PyTorch math; cuDNN runs the convolutions, as XLA ran them for the JAX
package.  An NHWC tensor permuted to NCHW is a channels-last view, so no
copy is made on either side of the call.

Counterparts (plain math only; the TPU's packed-lane and im2col layouts are
not ported):
  * `conv_silu_chain`     <- `ops/packed_conv.py::reference_chain` (:142)
  * `silu_conv3x3`        <- `ops/conv_pallas.py::silu_conv3x3_ref` (:317)
  * `gn_silu_conv3x3_ref` <- `ops/conv_pallas.py::gn_silu_conv3x3_ref` (:260),
    the plain version that the GroupNorm-fused conv kernel of the next
    slice is held against.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int = 1,
                padding: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight and symmetric zero padding; a 1x1
    conv without stride is a plain matrix product over channels."""
    if weight.shape[2:] == (1, 1) and stride == 1 and padding == 0:
        return F.linear(x, weight[:, :, 0, 0], bias)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def silu_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """SiLU, then a 3x3 SAME conv plus bias."""
    return conv2d_nhwc(F.silu(x), weight, bias)


def gn_silu_conv3x3_ref(x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Per-(batch, channel) affine in fp32 (a folded GroupNorm, see
    `GroupNorm32.affine`), cast to the compute dtype, SiLU, 3x3 conv plus
    bias, plus an optional residual.  scale, shift: [B, C]."""
    xn = (x.float() * scale.float()[:, None, None, :]
          + shift.float()[:, None, None, :]).to(x.dtype)
    y = silu_conv3x3(xn, weight, bias)
    return y + residual if residual is not None else y


def conv_silu_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    strides: Sequence[int]) -> torch.Tensor:
    """conv3x3 (padding 1, given stride) + bias + SiLU, stage after stage."""
    for w, b, s in zip(weights, biases, strides):
        x = F.silu(conv2d_nhwc(x, w, b, stride=s))
    return x
