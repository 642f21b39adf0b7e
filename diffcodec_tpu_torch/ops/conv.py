"""Convolutions on NHWC tensors with torch-layout (OIHW) weights: plain
PyTorch math, and the wrappers of the 3x3 conv kernels of
`csrc/conv3x3.cu`.

cuDNN runs the model's ordinary convolutions (`conv2d_nhwc`), as XLA ran
them for the JAX package.  An NHWC tensor permuted to NCHW is a
channels-last view, so no copy is made on either side of the call.

The kernels and their plain versions (counterparts in
`diffcodec_tpu/ops/conv_pallas.py`):
  * `silu_conv3x3`      <- `fused_silu_conv3x3_pallas` (:96), plain
    version `silu_conv3x3_ref` (:317);
  * `gn_silu_conv3x3`   <- `gn_silu_conv3x3_pallas` (:211), plain version
    `gn_silu_conv3x3_ref` (:260);
  * `upsample_conv3x3`  <- `upsample_conv3x3_pallas` (:531), plain version
    `upsample_conv3x3_ref` (:578);
  * `downsample_conv3x3` <- `downsample_conv3x3_pallas` (:703), plain
    version `downsample_conv3x3_ref` (:763): stride 2, padded bottom/right
    (the VAE encoder's) or on all sides (the UNet's).
On a CPU tensor a wrapper computes its plain version.  On a CUDA tensor it
launches the kernel (one `dc_conv3x3`, `dc_upsample_conv3x3` or
`dc_downsample_conv3x3` call) or raises; `<wrapper>.launches` counts the
launches.  `dc_conv3x3` runs the conv's Hopper loop where O > HEAD_MAX_O
and the project-then-stencil kernel where O <= HEAD_MAX_O (the VAE's
128 -> 3 out-head; the counterpart of
`conv_pallas.py::gn_silu_conv3x3_projected` :424), whose launches
`projected_head.launches` counts besides.  Every wrapper is
differentiable: its gradient is autograd's of the plain version
(`_kernels.PlainBackward`), as the JAX package's `custom_vjp`s take the
VJP of their `*_ref` forms (`conv_pallas.py:270-307, 328-342, 589-603,
783-791`).  Each wrapper turns the OIHW weight into the kernel's layout
per call: the taps [O, 9, C] of the
3x3 conv, or for the upsample the collapsed taps [4, O, 4, C] (phase
di * 2 + dj, tap a * 2 + b, summed in fp32 and rounded to the weight's
dtype once), cut into chunks of 64 input channels (one 128-byte row, what
the Hopper loop's TMA copies take; `chunk_taps`); where O <= HEAD_MAX_O the
projection columns of `head_projection`.

Other counterpart (plain math only; the TPU's packed-lane layout is not
ported): `conv_silu_chain` <- `ops/packed_conv.py::reference_chain` (:142).
"""

from __future__ import annotations

import types
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from diffcodec_tpu_torch import _kernels


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int = 1,
                padding: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight and symmetric zero padding; a 1x1
    conv without stride or groups is a plain matrix product over
    channels."""
    if (weight.shape[2:] == (1, 1) and stride == 1 and padding == 0
            and groups == 1):
        return F.linear(x, weight[:, :, 0, 0], bias)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def silu_conv3x3_ref(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Plain version: SiLU, then a 3x3 SAME conv plus bias."""
    return conv2d_nhwc(F.silu(x), weight, bias)


def gn_silu_conv3x3_ref(x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version: per-(batch, channel) affine in fp32 (a folded
    GroupNorm, see `GroupNorm32.affine`), cast to the compute dtype, SiLU,
    3x3 conv plus bias, plus an optional residual.  scale, shift: [B, C]."""
    xn = (x.float() * scale.float()[:, None, None, :]
          + shift.float()[:, None, None, :]).to(x.dtype)
    y = silu_conv3x3_ref(xn, weight, bias)
    return y + residual if residual is not None else y


def upsample_conv3x3_ref(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Plain version: nearest-2x upsampling, then a 3x3 SAME conv plus
    bias.  x [B, H, W, C] -> [B, 2H, 2W, O]."""
    B, H, W, C = x.shape
    up = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return conv2d_nhwc(up.reshape(B, 2 * H, 2 * W, C), weight, bias)


def downsample_conv3x3_ref(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor,
                           asymmetric_pad: bool = True) -> torch.Tensor:
    """Plain version: a 3x3 stride-2 conv plus bias of x zero-padded by one
    row and column at the bottom and right, and also at the top and left
    unless `asymmetric_pad`.  [B, H, W, C] -> [B, Ho, Wo, O] with
    Ho = (H + pad - 2) // 2 + 1, pad = 0 if asymmetric_pad else 1."""
    pad = 0 if asymmetric_pad else 1
    xp = F.pad(x, (0, 0, pad, 1, pad, 1))
    return conv2d_nhwc(xp, weight, bias, stride=2, padding=0)


def conv3x3_taps(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [O, C, 3, 3] -> the kernel's [O, 9, C], tap = 3 * row + col."""
    O, C = weight.shape[:2]
    return weight.permute(0, 2, 3, 1).reshape(O, 9, C).contiguous()


def collapse_upsample_taps(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [O, C, 3, 3] -> [4, O, 4, C]: for nearest-2x upsampling, output
    phase (di, dj) reads a 2x2 window of the input, and adjacent 3x3 taps
    fall on the same input pixel (`conv_pallas.py::_collapse_upsample_kernel`
    :459): rows di = 0 -> (k0, k1 + k2), di = 1 -> (k0 + k1, k2), and the
    same for columns.  Sums in fp32, rounded once to the weight's dtype."""
    k = weight.float()

    def pairs(t, dim, phase):  # collapse 3 taps of `dim` to 2
        k0, k1, k2 = t.unbind(dim)
        return torch.stack((k0, k1 + k2) if phase == 0 else (k0 + k1, k2),
                           dim)

    phases = [pairs(pairs(k, 2, di), 3, dj) for di in (0, 1)
              for dj in (0, 1)]                       # each [O, C, 2, 2]
    O, C = weight.shape[:2]
    return (torch.stack(phases).permute(0, 1, 3, 4, 2).reshape(4, O, 4, C)
            .to(weight.dtype).contiguous())


# input channels of a chunk of the kernels' weight layouts: `dc_conv3x3` and
# `dc_downsample_conv3x3` take [Cp / 64, 9, O, 64], `dc_upsample_conv3x3`
# [4, Cp / 64, 4, O, 64]
CONV_CHUNK = 64


def chunk_taps(taps: torch.Tensor, chunk: int) -> torch.Tensor:
    """[P, O, T, C] taps -> the kernel's [P, Cp / chunk, T, O, chunk], C
    zero-padded to Cp, a multiple of `chunk`: the weights of one chunk of
    input channels are one contiguous run in device memory."""
    P, O, T, C = taps.shape
    taps = F.pad(taps, (0, -C % chunk))
    return (taps.reshape(P, O, T, -1, chunk).permute(0, 3, 2, 1, 4)
            .contiguous())


# `dc_conv3x3` takes the project-then-stencil kernel where O <= HEAD_MAX_O;
# a block of it projects onto 32 columns, the 9 taps of up to HEAD_GROUP
# output channels
HEAD_MAX_O = 8
HEAD_GROUP = 3
HEAD_COLUMNS = 32


def head_projection(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [O, C, 3, 3], O <= HEAD_MAX_O -> the head kernel's projection
    [G, Cp / 64, 32, 64], G = ceil(O / 3): group g holds output channels
    [3 g, 3 g + og), og = min(3, O - 3 g), and its column tap * og + o
    (tap = 3 * row + col) the weights of channel 3 g + o at that tap, over
    input channels zero-padded to Cp; columns past 9 og are zero.  Within a
    group these are the tap-major columns of JAX's projected head
    (`conv_pallas.py:435-436`, w2[c, tap * O + o])."""
    O, C = weight.shape[:2]
    if O > HEAD_MAX_O:
        raise ValueError(f"head_projection: O = {O} > {HEAD_MAX_O}")
    taps = weight.permute(2, 3, 0, 1).reshape(9, O, C)  # [tap, O, C]
    groups = []
    for o0 in range(0, O, HEAD_GROUP):
        og = min(HEAD_GROUP, O - o0)
        cols = taps[:, o0:o0 + og].reshape(9 * og, C)  # column tap * og + o
        groups.append(F.pad(cols, (0, -C % CONV_CHUNK,
                                   0, HEAD_COLUMNS - 9 * og)))
    proj = torch.stack(groups)  # [G, 32, Cp]
    G, N, Cp = proj.shape
    return (proj.reshape(G, N, Cp // CONV_CHUNK, CONV_CHUNK)
            .permute(0, 2, 1, 3).contiguous())


def conv3x3_weights(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [O, C, 3, 3] -> what `dc_conv3x3` reads for this O: the
    projection where O <= HEAD_MAX_O, else the chunked taps."""
    if weight.shape[0] <= HEAD_MAX_O:
        return head_projection(weight)
    return chunk_taps(conv3x3_taps(weight)[None], CONV_CHUNK)


# launches of the project-then-stencil kernel, by `silu_conv3x3` and
# `gn_silu_conv3x3` (each counts them in its own `launches` too)
projected_head = types.SimpleNamespace(launches=0)


def _check_cuda(name: str, x, weight, bias, extra=()):
    """Raise unless x is a CUDA [B, H, W, C] tensor with C % 8 == 0, the
    weight [O, C, 3, 3] (any strides: it is laid out anew) and every
    (label, tensor, dtype, shape) of bias and `extra` lies on x's device
    with that dtype and shape; activations must be contiguous and 16-byte
    aligned (the kernel reads 16-byte vectors).  Returns B, H, W, C, O."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    O = weight.shape[0]
    if C % 8 or tuple(weight.shape) != (O, C, 3, 3):
        raise ValueError(f"{name}: needs C % 8 == 0 and an [O, C, 3, 3] "
                         f"weight, got x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}")
    bf16 = torch.bfloat16
    if weight.device != x.device:
        raise ValueError(f"{name}: weight on {weight.device}, x on "
                         f"{x.device}")
    if weight.dtype != bf16:
        raise TypeError(f"{name}: weight must be {bf16}, got {weight.dtype}")
    for label, t, dtype, shape in (("x", x, bf16, (B, H, W, C)),
                                   ("bias", bias, bf16, (O,)), *extra):
        if t.device != x.device:
            raise ValueError(f"{name}: {label} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and "
                             "16-byte aligned")
    return B, H, W, C, O


def _conv_cuda(name: str, x, weight, bias, scale=None, shift=None,
               residual=None):
    """Launch `dc_conv3x3`: prologue 2 (affine + SiLU) where scale is
    given, else 1 (SiLU)."""
    extra = []  # shapes read before x's rank is checked: sized to fail
    if scale is not None:
        bc = (x.shape[0], x.shape[-1])
        extra += [("scale", scale, torch.float32, bc),
                  ("shift", shift, torch.float32, bc)]
    if residual is not None:
        extra.append(("residual", residual, torch.bfloat16,
                      tuple(x.shape[:-1]) + (weight.shape[0],)))
    B, H, W, C, O = _check_cuda(name, x, weight, bias, extra)
    out = torch.empty(B, H, W, O, device=x.device, dtype=torch.bfloat16)
    taps = conv3x3_weights(weight)
    bias32 = bias.float()
    lib = _kernels.lib()
    with torch.cuda.device(x.device):
        code = lib.dc_conv3x3(
            x.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), taps.data_ptr(),
            bias32.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), B, H, W, C, O, 1 if scale is None else 2,
            _kernels.stream_ptr(x.device))
    _kernels.check(code, "dc_conv3x3")
    if O <= HEAD_MAX_O:
        projected_head.launches += 1
    return out


def silu_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """SiLU, then a 3x3 SAME conv plus bias: `silu_conv3x3_ref` on a CPU
    tensor, `csrc/conv3x3.cu` (prologue 1) on a CUDA tensor (bf16
    contiguous x, C % 8 == 0) or raises."""
    return _kernels.PlainBackward.apply(_silu_conv3x3, silu_conv3x3_ref, x,
                                        weight, bias)


def _silu_conv3x3(x, weight, bias):
    if x.device.type == "cpu":
        return silu_conv3x3_ref(x, weight, bias)
    out = _conv_cuda("silu_conv3x3", x, weight, bias)
    silu_conv3x3.launches += 1
    return out


silu_conv3x3.launches = 0


def gn_silu_conv3x3(x: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x * scale + shift) in fp32, rounded to x's dtype, SiLU, 3x3 SAME
    conv plus bias, plus an optional residual [B, H, W, O]; scale, shift
    fp32 [B, C].  `gn_silu_conv3x3_ref` on a CPU tensor, `csrc/conv3x3.cu`
    (prologue 2) on a CUDA tensor or raises."""
    return _kernels.PlainBackward.apply(_gn_silu_conv3x3,
                                        gn_silu_conv3x3_ref, x, scale, shift,
                                        weight, bias, residual)


def _gn_silu_conv3x3(x, scale, shift, weight, bias, residual):
    if x.device.type == "cpu":
        return gn_silu_conv3x3_ref(x, scale, shift, weight, bias, residual)
    out = _conv_cuda("gn_silu_conv3x3", x, weight, bias, scale, shift,
                     residual)
    gn_silu_conv3x3.launches += 1
    return out


gn_silu_conv3x3.launches = 0


def upsample_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """conv3x3 SAME of the nearest-2x upsampled x, plus bias: [B, H, W, C]
    -> [B, 2H, 2W, O].  `upsample_conv3x3_ref` on a CPU tensor,
    `csrc/conv3x3.cu` (`dc_upsample_conv3x3`) on a CUDA tensor (bf16
    contiguous x, C % 8 == 0) or raises."""
    return _kernels.PlainBackward.apply(_upsample_conv3x3,
                                        upsample_conv3x3_ref, x, weight, bias)


def _upsample_conv3x3(x, weight, bias):
    if x.device.type == "cpu":
        return upsample_conv3x3_ref(x, weight, bias)
    B, H, W, C, O = _check_cuda("upsample_conv3x3", x, weight, bias)
    out = torch.empty(B, 2 * H, 2 * W, O, device=x.device,
                      dtype=torch.bfloat16)
    taps = chunk_taps(collapse_upsample_taps(weight), CONV_CHUNK)
    bias32 = bias.float()
    lib = _kernels.lib()
    with torch.cuda.device(x.device):
        code = lib.dc_upsample_conv3x3(
            x.data_ptr(), taps.data_ptr(), bias32.data_ptr(), out.data_ptr(),
            B, H, W, C, O, _kernels.stream_ptr(x.device))
    _kernels.check(code, "dc_upsample_conv3x3")
    upsample_conv3x3.launches += 1
    return out


upsample_conv3x3.launches = 0


def downsample_conv3x3(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor,
                       asymmetric_pad: bool = True) -> torch.Tensor:
    """3x3 stride-2 conv plus bias, padded bottom/right (asymmetric_pad,
    the VAE encoder's) or on all sides (the UNet's): [B, H, W, C] ->
    [B, Ho, Wo, O].  `downsample_conv3x3_ref` on a CPU tensor,
    `csrc/conv3x3.cu` (`dc_downsample_conv3x3`) on a CUDA tensor (bf16
    contiguous x, C % 8 == 0) or raises."""
    def plain(x, weight, bias):
        return downsample_conv3x3_ref(x, weight, bias, asymmetric_pad)

    def fast(x, weight, bias):
        if x.device.type == "cpu":
            return plain(x, weight, bias)
        pad = 0 if asymmetric_pad else 1
        B, H, W, C, O = _check_cuda("downsample_conv3x3", x, weight, bias)
        if H < 2 or W < 2:
            raise ValueError(f"downsample_conv3x3: input {H} x {W} too small")
        out = torch.empty(B, (H + pad - 2) // 2 + 1, (W + pad - 2) // 2 + 1,
                          O, device=x.device, dtype=torch.bfloat16)
        taps = chunk_taps(conv3x3_taps(weight)[None], CONV_CHUNK)
        bias32 = bias.float()
        lib = _kernels.lib()
        with torch.cuda.device(x.device):
            code = lib.dc_downsample_conv3x3(
                x.data_ptr(), taps.data_ptr(), bias32.data_ptr(),
                out.data_ptr(), B, H, W, C, O, pad,
                _kernels.stream_ptr(x.device))
        _kernels.check(code, "dc_downsample_conv3x3")
        downsample_conv3x3.launches += 1
        return out

    return _kernels.PlainBackward.apply(fast, plain, x, weight, bias)


downsample_conv3x3.launches = 0


def conv_silu_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    strides: Sequence[int]) -> torch.Tensor:
    """conv3x3 (padding 1, given stride) + bias + SiLU, stage after stage."""
    for w, b, s in zip(weights, biases, strides):
        x = F.silu(conv2d_nhwc(x, w, b, stride=s))
    return x
