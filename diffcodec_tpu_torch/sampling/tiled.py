"""1080p decoding by overlap tiling.

Counterpart: `diffcodec_tpu/sampling/tiled.py` (`tile_grid` :52,
`_crop_batch` :60, `sample_tiled` :74).  The conditioning is cropped into
overlapping tiles (512 x 512, overlap 64 at 1080p: 3 x 5 = 15 tiles a
frame), every tile of every frame goes through the pipeline as one batch
(in chunks of `tile_batch`), and the tiles are merged back with cosine
feathering (`ops.tiling.merge_tiles`).

Kept from the JAX package: a frame of exactly one tile passes straight
through; edge tiles are padded to the full tile by reflection (numpy's
'reflect', which reflects again where the pad exceeds the tile, as the
1080p edge tiles of 184 and 128 px need); the text embeddings repeat once
per tile; every tile is uploaded once, uint8 conditioning raw and
normalised on the device (fp32 first, then cast); chunks are sliced on the
device and their outputs stay there until one fetch, bf16 fetched as fp16.

Noise is explicit.  JAX folds each chunk's start index into its key; here
the caller passes the initial latents of every tile (in tile order: frame
by frame, each frame's tiles in raster order) and, for a pipeline without
CFG (`takes_uncond = False`, the distilled student), its K - 1 re-noises
the same way, or a generator on the pipeline's device from which each
chunk draws its own in turn.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffcodec_tpu_torch.ops.tiling import crop_into_tiles, merge_tiles


def tile_grid(height: int, width: int, tile: Tuple[int, int],
              overlap: int) -> List[Tuple[int, int, int, int]]:
    """Tile coordinates (y1, y2, x1, x2) for a resolution, raster order."""
    dummy = np.zeros((height, width, 1), np.uint8)
    _, coords, _ = crop_into_tiles(dummy, tile, overlap)
    return coords


def _reflect_index(n: int, size: int) -> np.ndarray:
    """Source index of each position of an axis of `n` padded at its end
    to `size` by numpy's 'reflect' mode, repeated reflection included."""
    return np.pad(np.arange(n), (0, size - n), mode="reflect")


def _crop_batch(arr, coords, tile_h: int, tile_w: int):
    """[B, H, W, C] -> [B * n_tiles, tile_h, tile_w, C], a numpy array on
    the host or a tensor on its device.  Edge tiles are padded to the full
    tile as `np.pad(mode='reflect')` pads them (cropped again on merge), by
    gathering along numpy's own index pattern."""
    is_tensor = torch.is_tensor(arr)

    def take(t, idx, axis):
        if is_tensor:
            return t.index_select(axis, torch.as_tensor(idx,
                                                         device=t.device))
        return np.take(t, idx, axis=axis)

    out = []
    for b in range(arr.shape[0]):
        for (y1, y2, x1, x2) in coords:
            t = arr[b, y1:y2, x1:x2]
            if y2 - y1 < tile_h:
                t = take(t, _reflect_index(y2 - y1, tile_h), 0)
            if x2 - x1 < tile_w:
                t = take(t, _reflect_index(x2 - x1, tile_w), 1)
            out.append(t)
    return torch.stack(out) if is_tensor else np.stack(out)


def _is_uint8(x) -> bool:
    return x.dtype == (torch.uint8 if torch.is_tensor(x) else np.uint8)


def unit_from_uint8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 [0, 255] -> [0, 1] in `dtype` on the tensor's device: divided
    in fp32, correctly rounded as the JAX package's uint8 / 255 (a Python
    divisor makes CUDA multiply by its rounded reciprocal instead, one
    ulp off for 126 of the 256 values), then cast."""
    return (t.float() / torch.full((), 255.0, device=t.device)).to(dtype)


def _upload(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array or tensor -> `device` in `dtype`; uint8 travels raw
    and is normalised to [0, 1] there (`unit_from_uint8`)."""
    t = torch.as_tensor(x)
    if _is_uint8(t):
        return unit_from_uint8(t.to(device), dtype)
    return t.to(dtype).to(device)


def _sample(pipe, latents, text, uncond, cond, flow, noises, generator):
    if getattr(pipe, "takes_uncond", True):
        return pipe.sample(latents, text, uncond, cond, flow)
    return pipe.sample(latents, text, cond, flow, noises=noises,
                       generator=generator)


def sample_tiled(pipe, text_embeds, uncond_embeds, cond, flow,
                 tile: Tuple[int, int] = (512, 512), overlap: int = 64,
                 feather: int = 64, tile_batch: Optional[int] = None,
                 latents=None, noises: Optional[Sequence] = None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
    """Decode [B, H, W, *] conditioning at any resolution on the
    pipeline's device.

    cond [B, H, W, 6] in [0, 1] (float), or uint8 in [0, 255]; flow
    [B, H, W, 4] in pixels (a crop keeps pixel units): numpy arrays, or
    tensors, which are cropped on their device.  text_embeds /
    uncond_embeds [B, L, D] (uncond is ignored by a pipeline without CFG).
    latents: [B * n_tiles, H_t / 8, W_t / 8, 4] initial noise in tile
    order; noises: the distilled pipeline's K - 1 re-noises, each like
    latents; either may be None where `generator` (on the pipeline's
    device) draws them, chunk by chunk.  tile_batch: tiles a pipeline call
    (None: all).  Returns [B, H, W, 3] float32 in [-1, 1] on the host.
    """
    B, H, W = cond.shape[:3]
    th, tw = tile
    device = next(pipe.unet.parameters()).device
    dtype = pipe.unet.dtype
    distilled = not getattr(pipe, "takes_uncond", True)
    if latents is None and generator is None:
        raise ValueError("pass the initial latents of every tile or a "
                         "generator")
    if distilled and noises is None and generator is None:
        raise ValueError("pass the re-noises of every tile or a generator")

    passthrough = (H, W) == (th, tw)
    if passthrough:
        coords, n_tiles = None, 1
        cond_t, flow_t = cond, flow
    else:
        coords = tile_grid(H, W, tile, overlap)
        n_tiles = len(coords)
        cond_t = _crop_batch(cond, coords, th, tw)
        flow_t = _crop_batch(flow, coords, th, tw)
    total = B * n_tiles
    for arr in [x for x in (latents, *(noises or ())) if x is not None]:
        if arr.shape[0] != total:
            raise ValueError(f"noise for {arr.shape[0]} tiles, not the "
                             f"{total} of this call")

    # one upload of every tile, in the compute dtype (uint8 raw)
    cond_d = _upload(cond_t, dtype, device)
    flow_d = torch.as_tensor(flow_t).to(dtype).to(device)
    text_d = torch.as_tensor(text_embeds).to(dtype).to(device)
    text_d = text_d.repeat_interleave(n_tiles, dim=0)
    uncond_d = None
    if not distilled:
        uncond_d = torch.as_tensor(uncond_embeds).to(dtype).to(device)
        uncond_d = uncond_d.repeat_interleave(n_tiles, dim=0)
    lat_d = None if latents is None else torch.as_tensor(latents).to(device)
    noises_d = (None if noises is None else
                [torch.as_tensor(n).to(device) for n in noises])
    lat_shape = (th // 8, tw // 8, pipe.unet.cfg.in_channels)

    step = total if passthrough else (tile_batch or total)
    outs = []
    for s in range(0, total, step):
        sl = slice(s, s + step)
        n = min(step, total - s)
        lat = (lat_d[sl] if lat_d is not None else
               torch.randn((n,) + lat_shape, generator=generator,
                           device=device))
        outs.append(_sample(pipe, lat, text_d[sl],
                            None if uncond_d is None else uncond_d[sl],
                            cond_d[sl], flow_d[sl],
                            None if noises_d is None else
                            [x[sl] for x in noises_d], generator))
    cat = torch.cat(outs)
    if passthrough:
        return cat.float().cpu().numpy()
    if cat.dtype == torch.bfloat16:
        # 2 bytes an element: fp16 holds every bf16 value in [2^-14, 1]
        # exactly, and below that rounds by at most 2^-25 (the JAX
        # package's fetch, `tests/test_tiled_sampling.py`)
        cat = cat.to(torch.float16)
    tiles_out = cat.cpu().numpy().astype(np.float32)

    frames = []
    for b in range(B):
        per_frame = [tiles_out[b * n_tiles + k][:y2 - y1, :x2 - x1]
                     for k, (y1, y2, x1, x2) in enumerate(coords)]
        frames.append(merge_tiles(per_frame, coords, (H, W),
                                  feather=feather, as_uint8=False))
    return np.clip(np.stack(frames), -1.0, 1.0)
