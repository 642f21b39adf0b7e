"""Sparse-motion encoder: guidance-point sampling from dense flow.

Counterpart: `diffcodec_tpu/codec/sparse_flow.py`, copied (numpy and
scipy).

Parity target: `cmp/utils/data_utils.py:10-33,127-224` (`flow_sampler` with
strategies grid / uniform / gradnms / watershed / single / full / specified,
plus `get_edge`, `nms`, `neighbor_elim`).  Host-side numpy/scipy — this is
the *encoder* side of the sparse rate mode and runs once per frame pair.
No cv2 dependency (scipy only).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from scipy import ndimage, signal


def get_edge(data: np.ndarray, blur: bool = False) -> np.ndarray:
    """Channel-summed Sobel magnitude of [H, W, C] data
    (`data_utils.py:10-19`)."""
    if blur:
        # 3x3 gaussian, sigma 1 (separable), symmetric boundary
        data = ndimage.gaussian_filter(data, sigma=(1.0, 1.0, 0.0),
                                       truncate=1.0, mode="nearest")
    sobel = np.asarray([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
    total = np.zeros(data.shape[:2], np.float64)
    for k in range(data.shape[2]):
        ex = signal.convolve2d(data[:, :, k], sobel, boundary="symm",
                               mode="same")
        ey = signal.convolve2d(data[:, :, k], sobel.T, boundary="symm",
                               mode="same")
        total = total + np.sqrt(ex ** 2 + ey ** 2)
    return total


def nms(score: np.ndarray, ks: int) -> np.ndarray:
    """Zero out non-maxima within a ks x ks window (`data_utils.py:28-33`)."""
    assert ks % 2 == 1
    out = score.copy()
    maxpool = ndimage.maximum_filter(score, footprint=np.ones((ks, ks)))
    out[score < maxpool] = 0.0
    return out


def neighbor_elim(ph: np.ndarray, pw: np.ndarray, d: float,
                  rng: Optional[np.random.Generator] = None):
    """Randomly drop one of each pair of points closer than d in both axes
    (`data_utils.py:127-139`)."""
    rng = rng or np.random.default_rng(0)
    valid = np.ones(len(ph), np.int32)
    h_dist = np.abs(ph[:, None].astype(np.float64) - ph[None, :])
    w_dist = np.abs(pw[:, None].astype(np.float64) - pw[None, :])
    idx1, idx2 = np.where((h_dist < d) & (w_dist < d))
    for i, j in zip(idx1, idx2):
        if valid[i] and valid[j] and i != j:
            if rng.random() > 0.5:
                valid[i] = 0
            else:
                valid[j] = 0
    keep = np.where(valid == 1)
    return ph[keep], pw[keep]


def _remove_border(mask: np.ndarray) -> None:
    mask[0, :] = 0
    mask[:, 0] = 0
    mask[-1, :] = 0
    mask[:, -1] = 0


def flow_sampler(flow: np.ndarray, strategy: Sequence[str] = ("grid",),
                 bg_ratio: float = 1.0 / 6400, nms_ks: int = 15,
                 max_num_guide: int = -1,
                 guidepoint: Optional[np.ndarray] = None,
                 rng: Optional[np.random.Generator] = None):
    """Sample sparse guidance flow from dense flow [H, W, 2].

    Returns (sparse [H,W,2], mask [H,W,2] int32) with flow values copied at
    the sampled points.  Strategies compose (points are concatenated).
    """
    rng = rng or np.random.default_rng(0)
    for s in strategy:
        if s not in ("grid", "uniform", "gradnms", "watershed", "single",
                     "full", "specified"):
            raise ValueError(f"no such strategy: {s}")
    h, w = flow.shape[:2]
    ds = max(1, max(h, w) // 400)  # downscale for edge computation

    if "full" in strategy:
        return flow.copy(), np.ones(flow.shape, np.int32)

    pts_h: List[np.ndarray] = []
    pts_w: List[np.ndarray] = []
    if "grid" in strategy:
        stride = int(np.sqrt(1.0 / bg_ratio))
        start_h = int((h - h // stride * stride) / 2)
        start_w = int((w - w // stride * stride) / 2)
        mesh = np.meshgrid(np.arange(start_h, h, stride),
                           np.arange(start_w, w, stride))
        pts_h.append(mesh[0].reshape(-1))
        pts_w.append(mesh[1].reshape(-1))
    if "uniform" in strategy:
        n = int(bg_ratio * h * w)
        pts_h.append(rng.integers(0, h, n))
        pts_w.append(rng.integers(0, w, n))
    if "gradnms" in strategy:
        ks = max(w // ds // 20, 1)
        edge = get_edge(flow[::ds, ::ds, :])
        kernel = np.ones((ks, ks), np.float32) / (ks * ks)
        sub = max(ks // 2, 1)
        subkernel = np.ones((sub, sub), np.float32) / (sub * sub)
        score = signal.convolve2d(edge, kernel, boundary="symm", mode="same")
        subscore = signal.convolve2d(edge, subkernel, boundary="symm",
                                     mode="same")
        score = score / max(score.max(), 1e-12) - \
            subscore / max(subscore.max(), 1e-12)
        res = nms(score, nms_ks)
        pth, ptw = np.where(res > 0.1)
        pts_h.append(pth * ds)
        pts_w.append(ptw * ds)
    if "watershed" in strategy:
        edge = get_edge(flow[::ds, ::ds, :])
        edge /= max(edge.max(), 0.01)
        edge = (edge > 0.1).astype(np.float32)
        watershed = ndimage.distance_transform_edt(1 - edge)
        res = nms(watershed, nms_ks)
        _remove_border(res)
        pth, ptw = np.where(res > 0)
        pth, ptw = neighbor_elim(pth, ptw, (nms_ks - 1) / 2, rng)
        pts_h.append(pth * ds)
        pts_w.append(ptw * ds)
    if "single" in strategy:
        pth, ptw = np.where((flow[:, :, 0] != 0) | (flow[:, :, 1] != 0))
        ridx = int(rng.integers(len(pth)))
        pts_h.append(pth[ridx:ridx + 1])
        pts_w.append(ptw[ridx:ridx + 1])
    if "specified" in strategy:
        if guidepoint is None:
            raise ValueError("'specified' strategy requires guidepoint")
        pts_h.append(guidepoint[:, 1])
        pts_w.append(guidepoint[:, 0])

    ph = np.concatenate(pts_h).astype(np.int64)
    pw = np.concatenate(pts_w).astype(np.int64)
    if max_num_guide == -1:
        max_num_guide = len(ph)
    sel = rng.permutation(len(ph))[:min(max_num_guide, len(ph))]
    ph, pw = ph[sel], pw[sel]

    sparse = np.zeros_like(flow)
    mask = np.zeros(flow.shape, np.int32)
    sparse[ph, pw, 0] = flow[ph, pw, 0]
    sparse[ph, pw, 1] = flow[ph, pw, 1]
    mask[ph, pw, :] = 1
    return sparse, mask
