"""Fréchet distances (the FID and FVD core) and the I3D feature functions.

Counterpart: `diffcodec_tpu/eval/frechet.py`.  `frechet_distance`,
`activations_to_frechet`, `fid_score`, `fvd_score` and `fvd_sweep` are
copied (numpy, scipy); `load_i3d_torchscript` runs the reference's
torchscript on a device and raises where a named file is missing;
`make_i3d_feature_fn` runs the port's `models.i3d`.
Parity targets: `test_utils.py:44-66` (FID via torchmetrics feature=64),
`fvd_utils/` (FVD via I3D 400-d features and the Fréchet distance,
`fvd_utils/models/fvd/fvd.py:42-90`).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
from scipy import linalg


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activations_to_frechet(feat1: np.ndarray, feat2: np.ndarray) -> float:
    """Feature matrices [N, D] -> Fréchet distance."""
    mu1, mu2 = feat1.mean(0), feat2.mean(0)
    s1 = np.cov(feat1, rowvar=False)
    s2 = np.cov(feat2, rowvar=False)
    return frechet_distance(mu1, np.atleast_2d(s1), mu2, np.atleast_2d(s2))


def fid_score(images1: np.ndarray, images2: np.ndarray,
              feature_fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """FID over [N,H,W,3] uint8 frames with a pluggable feature extractor
    (the reference uses torchmetrics FID feature=64, `test_utils.py:44-47`)."""
    return activations_to_frechet(feature_fn(images1), feature_fn(images2))


def fvd_score(videos1: np.ndarray, videos2: np.ndarray,
              feature_fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """FVD over [N,T,H,W,3] videos in [0,1] with an I3D feature fn
    (400-d logits, `fvd_utils/models/fvd/fvd.py:42-62`)."""
    return activations_to_frechet(feature_fn(videos1), feature_fn(videos2))


def fvd_sweep(videos1: np.ndarray, videos2: np.ndarray,
              feature_fn: Callable[[np.ndarray], np.ndarray],
              calculate_per_frame: int = 5,
              calculate_final: bool = True) -> dict:
    """Clip-length-sweep FVD driver.

    Parity target: `fvd_utils/calculate_fvd.py:16-65` — for every clip
    length ``k`` in ``range(per_frame, T+1, per_frame)`` with ``k >= 10``
    (I3D needs >= 10 frames), compute FVD over the first ``k`` frames of
    both video batches, plus an optional 'final' full-length entry.
    Greyscale inputs ([N,T,H,W,1]) are channel-tripled like the
    reference's ``trans()`` (`calculate_fvd.py:6-14`); layout here is
    [N,T,H,W,C] in [0,1] (the reference permutes BTCHW->BCTHW for torch —
    a layout detail, not semantics).

    Returns the reference's result dict shape: ``{"fvd": {"[:k]": val,
    ..., "final": val}, "fvd_per_frame", "fvd_video_setting",
    "fvd_video_setting_name"}``.
    """
    if videos1.shape != videos2.shape:
        raise ValueError(f"shape mismatch {videos1.shape} vs "
                         f"{videos2.shape}")
    if videos1.shape[-1] == 1:
        videos1 = np.repeat(videos1, 3, axis=-1)
        videos2 = np.repeat(videos2, 3, axis=-1)
    T = videos1.shape[1]
    results = {}
    for k in range(calculate_per_frame, T + 1, calculate_per_frame):
        if k < 10:  # calculate_fvd.py:38-39
            continue
        results[f"[:{k}]"] = fvd_score(videos1[:, :k], videos2[:, :k],
                                       feature_fn)
    if calculate_final:
        results["final"] = fvd_score(videos1, videos2, feature_fn)
    return {
        "fvd": results,
        "fvd_per_frame": calculate_per_frame,
        "fvd_video_setting": tuple(videos1.shape),
        "fvd_video_setting_name": "batch_size, time, height, width, channel",
    }


def make_i3d_feature_fn(model, batch_size: int = 4, device="cuda"):
    """FVD feature fn backed by the port's `models.i3d.InceptionI3D`, run
    on `device` in fp32.  Videos [N, T, H, W, 3] in [0, 1] (numpy or a
    tensor) -> [N, 400] numpy logits.  `model` must already be fp32 on
    `device` (else `ValueError`); it is put in eval mode."""
    import torch

    from diffcodec_tpu_torch.eval.metrics import require_fp32_on

    require_fp32_on(model, device)
    model = model.eval()

    @torch.no_grad()
    def feature_fn(videos) -> np.ndarray:
        videos = torch.as_tensor(videos)
        feats = []
        for i in range(0, len(videos), batch_size):
            chunk = videos[i:i + batch_size].to(device).float() * 2.0 - 1.0
            feats.append(model(chunk).float().cpu().numpy())
        return np.concatenate(feats)

    return feature_fn


def load_i3d_torchscript(path: Optional[str] = None, device="cuda"):
    """Wrap the reference's torchscript I3D (`i3d_torchscript.pt`) as a
    numpy feature fn run on `device`.

    The file is `path`, else $DIFFCODEC_I3D_PATH.  Returns None when
    neither is set (FVD then reports as unavailable rather than wrong);
    a file that was named and does not exist raises `FileNotFoundError`.
    """
    path = path or os.environ.get("DIFFCODEC_I3D_PATH", "")
    if not path:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(f"no torchscript I3D at {path}")
    import torch

    model = torch.jit.load(path, map_location=device).eval()

    def feature_fn(videos: np.ndarray) -> np.ndarray:
        # [N,T,H,W,3] in [0,1] -> I3D input [N,3,T,H,W] in [-1,1]
        feats = []
        with torch.no_grad():
            for v in videos:
                x = torch.from_numpy(v.astype(np.float32) * 2 - 1)
                x = x.permute(3, 0, 1, 2)[None].to(device)
                out = model(x, rescale=False, resize=False,
                            return_features=True)
                feats.append(out.cpu().numpy().reshape(-1))
        return np.stack(feats)

    return feature_fn
