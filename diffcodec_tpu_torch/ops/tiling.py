"""Overlap-tiling for 1080p sampling: crop + feathered merges.

Counterpart: `diffcodec_tpu/ops/tiling.py`, copied (numpy only), so the
port imports nothing of the JAX package.  Its parity targets, in the
reference's `patch_utils.py`:
  * crop_into_tiles        (189-209)  overlapping raster-order tiles
  * merge_costiles         (13-80)    cosine-feather blended pixel merge
  * merge_tiles            (212-248)  plain average merge
  * merge_latent_tiles_from_pixel_coords (83-174) Hann-window latent merge
                                       with pixel->latent coordinate rounding

Host-side numpy code (runs once per frame around the sampler); layout is
HWC for pixels, NHWC for latents.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Coord = Tuple[int, int, int, int]  # (y1, y2, x1, x2)


def crop_into_tiles(img: np.ndarray, tile_size: Tuple[int, int],
                    overlap: int = 0):
    """Crop HWC image into overlapping tiles.

    Returns (tiles, coords, (h, w)).  Raster order; edge tiles may be smaller
    (matching `patch_utils.py:189-209`).
    """
    h, w = img.shape[:2]
    stride_y = tile_size[0] - overlap
    stride_x = tile_size[1] - overlap
    tiles, coords = [], []
    for y in range(0, h, stride_y):
        for x in range(0, w, stride_x):
            y2, x2 = min(y + tile_size[0], h), min(x + tile_size[1], w)
            tiles.append(img[y:y2, x:x2])
            coords.append((y, y2, x, x2))
    return tiles, coords, (h, w)


def _cosine_mask(h: int, w: int, feather: int,
                 edges=(True, True, True, True)) -> np.ndarray:
    """2-D cosine feather mask.

    Semantics follow `patch_utils.py:33-51` with one deliberate divergence:
    the reference's window hits exactly 0 at the feather endpoints, which
    leaves zero-total-weight pixels wherever a feathered edge is not covered
    by a neighbouring tile (visible garbage lines near image borders).  Here
    the ramp is strictly positive and `edges=(top, bottom, left, right)`
    disables feathering on edges that touch the image boundary.
    """
    def ramp(f):
        # strictly-positive half-cosine ramp 0 < r <= 1 over f pixels
        i = np.arange(1, f + 1)
        return (1 - np.cos(np.pi * i / (f + 1))) / 2

    wy = np.ones(h)
    wx = np.ones(w)
    if feather > 0:
        f = min(feather, h // 2)
        if f > 0:
            if edges[0]:
                wy[:f] = ramp(f)
            if edges[1]:
                wy[-f:] = ramp(f)[::-1]
        f = min(feather, w // 2)
        if f > 0:
            if edges[2]:
                wx[:f] = ramp(f)
            if edges[3]:
                wx[-f:] = ramp(f)[::-1]
    return np.outer(wy, wx).astype(np.float32)


def _resize_bilinear_np(tile: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Host bilinear resize (half-pixel centers) for HWC arrays."""
    h, w = tile.shape[:2]
    if (h, w) == (th, tw):
        return tile
    ys = np.clip((np.arange(th) + 0.5) * h / th - 0.5, 0, h - 1)
    xs = np.clip((np.arange(tw) + 0.5) * w / tw - 0.5, 0, w - 1)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    t = tile.astype(np.float32)
    top = t[y0][:, x0] * (1 - fx) + t[y0][:, x1] * fx
    bot = t[y1][:, x0] * (1 - fx) + t[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def merge_tiles(tiles: Sequence[np.ndarray], coords: Sequence[Coord],
                full_shape: Tuple[int, int], feather: int = 0,
                as_uint8: bool = True) -> np.ndarray:
    """Merge overlapping HWC tiles; feather>0 gives cosine blending.

    feather=0 reproduces `merge_tiles` (plain average in overlaps); feather>0
    reproduces `merge_costiles`.
    """
    h, w = full_shape
    c = tiles[0].shape[2]
    out = np.zeros((h, w, c), np.float32)
    weight = np.zeros((h, w, 1), np.float32)
    for tile, (y1, y2, x1, x2) in zip(tiles, coords):
        th, tw = y2 - y1, x2 - x1
        if tile.shape[0] != th or tile.shape[1] != tw:
            tile = _resize_bilinear_np(tile, th, tw)
        edges = (y1 > 0, y2 < h, x1 > 0, x2 < w)
        mask = _cosine_mask(th, tw, feather, edges) if feather > 0 else \
            np.ones((th, tw), np.float32)
        out[y1:y2, x1:x2] += tile.astype(np.float32) * mask[..., None]
        weight[y1:y2, x1:x2] += mask[..., None]
    out /= np.maximum(weight, 1e-8)
    if as_uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def merge_latent_tiles(latents: Sequence[np.ndarray],
                       pixel_coords: Sequence[Coord],
                       full_latent_hw: Tuple[int, int],
                       original_image_hw: Tuple[int, int],
                       eps: float = 1e-8) -> np.ndarray:
    """Merge NHWC latent tiles using Hann-style blending in latent space.

    pixel_coords use the reference's (x1, x2, y1, y2) unpack order
    (`patch_utils.py:131`), mapped to latent coords by round(px * lat/px_full)
    (131-143), tiles resized bilinearly on mismatch.  Divergence from the
    reference (`patch_utils.py:117-129`): its Hann window is exactly 0 at
    tile borders, so image-boundary latents end up with zero total weight and
    collapse to 0.  We use a strictly-positive taper that is disabled on
    edges touching the canvas boundary.
    """
    H_lat, W_lat = full_latent_hw
    H_px, W_px = original_image_hw
    C = latents[0].shape[-1]
    out = np.zeros((1, H_lat, W_lat, C), np.float32)
    weight = np.zeros_like(out)
    for tile, (x1_px, x2_px, y1_px, y2_px) in zip(latents, pixel_coords):
        ly1 = int(round(y1_px * (H_lat / float(H_px))))
        ly2 = int(round(y2_px * (H_lat / float(H_px))))
        lx1 = int(round(x1_px * (W_lat / float(W_px))))
        lx2 = int(round(x2_px * (W_lat / float(W_px))))
        ly1, ly2 = max(0, min(ly1, H_lat)), max(0, min(ly2, H_lat))
        lx1, lx2 = max(0, min(lx1, W_lat)), max(0, min(lx2, W_lat))
        th, tw = ly2 - ly1, lx2 - lx1
        if th <= 0 or tw <= 0:
            continue
        t = tile[0]
        if t.shape[0] != th or t.shape[1] != tw:
            t = _resize_bilinear_np(t, th, tw)
        edges = (ly1 > 0, ly2 < H_lat, lx1 > 0, lx2 < W_lat)
        m = _cosine_mask(th, tw, max(th, tw), edges)
        m = (m / (m.max() + 1e-12))[..., None].astype(np.float32)
        out[0, ly1:ly2, lx1:lx2] += t * m
        weight[0, ly1:ly2, lx1:lx2] += m
    return out / np.maximum(weight, eps)
