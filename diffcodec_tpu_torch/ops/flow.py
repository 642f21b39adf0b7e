"""Flow-field utilities: the resize conventions, occlusion masks and the
confidence-weighted fusion of two warps.  NHWC; flow is [B, H, W, 2] with
(u, v) = (x, y) displacement.

Counterpart: `diffcodec_tpu/ops/flow.py`.  The reference carries two resize
conventions and both are kept under their own names.
"""

from __future__ import annotations

import torch

from diffcodec_tpu_torch.ops.softsplat import softsplat


def resize_bilinear(x: torch.Tensor, target_h: int, target_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC tensors, by gathers (the JAX package's exact
    arithmetic).  align_corners=False is torch's half-pixel convention."""
    B, H, W, C = x.shape
    if (H, W) == (target_h, target_w):
        return x
    dev = x.device
    if align_corners:
        ys = torch.linspace(0.0, H - 1.0, target_h, device=dev)
        xs = torch.linspace(0.0, W - 1.0, target_w, device=dev)
    else:
        ys = ((torch.arange(target_h, device=dev, dtype=torch.float32) + 0.5)
              * (H / target_h) - 0.5)
        xs = ((torch.arange(target_w, device=dev, dtype=torch.float32) + 0.5)
              * (W / target_w) - 0.5)
    ys = ys.clamp(0.0, H - 1.0)
    xs = xs.clamp(0.0, W - 1.0)
    y0 = torch.floor(ys).long().clamp(0, H - 1)
    x0 = torch.floor(xs).long().clamp(0, W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wy = (ys - y0).to(x.dtype)[None, :, None, None]
    wx = (xs - x0).to(x.dtype)[None, None, :, None]
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_flow_pixel_units(flow: torch.Tensor, target_h: int,
                            target_w: int) -> torch.Tensor:
    """Resize flow (align_corners=True) and rescale the vectors into target
    pixel units."""
    B, H, W, _ = flow.shape
    out = resize_bilinear(flow, target_h, target_w, align_corners=True)
    scale = torch.tensor([target_w / max(W, 1), target_h / max(H, 1)],
                         dtype=out.dtype, device=out.device)
    return out * scale


def resize_and_normalize_flow(flow: torch.Tensor, target_h: int,
                              target_w: int) -> torch.Tensor:
    """Resize flow, then divide u by (W'-1)/2 and v by (H'-1)/2, without
    rescaling the vectors for the new resolution: the convention the
    feature extractor trains with."""
    out = resize_bilinear(flow, target_h, target_w, align_corners=False)
    norm = torch.tensor([(target_w - 1) / 2.0, (target_h - 1) / 2.0],
                        dtype=out.dtype, device=out.device)
    return out / norm


def resize_flow_by_factor(flow: torch.Tensor, target_h: int,
                          target_w: int) -> torch.Tensor:
    """Bilinear resize, then divide by the downscale factor H // target_h."""
    factor = flow.shape[1] // target_h
    out = resize_bilinear(flow, target_h, target_w, align_corners=False)
    return out / factor


def compute_occlusion_mask(flow_bwd: torch.Tensor, flow_fwd: torch.Tensor,
                           threshold: float = 0.3) -> torch.Tensor:
    """Forward-backward consistency mask, [B, H, W, 1] float, 1 = occluded.

    Splats the backward flow along the forward flow with unit metric
    ('soft') and marks pixels where ||flow_fwd + warped_bwd|| > threshold.
    fp32 island."""
    flow_bwd = flow_bwd.float()
    flow_fwd = flow_fwd.float()
    metric = torch.ones_like(flow_fwd[..., :1])
    warped_bwd = softsplat(flow_bwd, flow_fwd, metric, "soft")
    diff = flow_fwd + warped_bwd
    mag = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True))
    return (mag > threshold).float()


def soft_fuse(warped_a: torch.Tensor, warped_b: torch.Tensor,
              conf_a: torch.Tensor, conf_b: torch.Tensor,
              occ_a: torch.Tensor = None, occ_b: torch.Tensor = None,
              eps: float = 1e-6) -> torch.Tensor:
    """Confidence-weighted fusion of two warped maps: clamp confidences at
    0, normalise, blend; where both directions are occluded
    (occ_a + occ_b > 1.5) fall back to the plain average."""
    conf = torch.cat([conf_a, conf_b], dim=-1).clamp_min(0.0)
    w = conf / (torch.sum(conf, dim=-1, keepdim=True) + eps)
    fused = w[..., :1] * warped_a + w[..., 1:] * warped_b
    if occ_a is not None and occ_b is not None:
        holes = (occ_a + occ_b) > 1.5
        fused = torch.where(holes, 0.5 * (warped_a + warped_b), fused)
    return fused
