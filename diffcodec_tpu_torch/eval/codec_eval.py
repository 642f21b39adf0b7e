"""Codec evaluation drivers: per-video metric sweeps over decoded frames.

Parity targets:
  * `uvc_codec_eval.py:28-123`: walk prediction dirs
    `{root}/gop{N}/{dataset}/{bpp_case}/{video}`, compute metrics over
    inter-only and all frames vs originals, write `inter_results.json`.
  * `classical_codec_eval.py:60-141`: same over codec-decoded folders +
    `intra_inter_storage.txt` -> total_bpp / inter_bpp.

Counterpart: `diffcodec_tpu/eval/codec_eval.py`.  Frame IO is PIL,
imported inside `load_frames` (the card's machine has none); the metrics
are `eval.metrics.calculate_metrics_batch` on `device` (PSNR and MS-SSIM;
its LPIPS / FID / FVD slots where their networks are given).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from diffcodec_tpu_torch.codec.anchors import parse_intra_inter_storage
from diffcodec_tpu_torch.codec.gop import get_inter_frames
from diffcodec_tpu_torch.eval.metrics import calculate_metrics_batch


def load_frames(frame_dir: str, names: Optional[Sequence[str]] = None
                ) -> np.ndarray:
    """Load sorted PNG frames from a directory -> [N, H, W, 3] uint8."""
    from PIL import Image
    if names is None:
        names = sorted(n for n in os.listdir(frame_dir)
                       if n.lower().endswith((".png", ".jpg")))
    frames = [np.asarray(Image.open(os.path.join(frame_dir, n))
                         .convert("RGB")) for n in names]
    return np.stack(frames)


def evaluate_video(orig_dir: str, pred_dir: str, gop_size: int,
                   device="cuda") -> Dict[str, Dict[str, float]]:
    """Metrics for one video: all frames + inter-only subsets
    (`uvc_codec_eval.py:45-60`).  Pairs frames by sorted filename; missing
    pairs are skipped with the count reported."""
    orig_names = sorted(n for n in os.listdir(orig_dir)
                        if n.lower().endswith((".png", ".jpg")))
    pred_names = sorted(n for n in os.listdir(pred_dir)
                        if n.lower().endswith((".png", ".jpg")))
    pred_set = set(pred_names)
    # GOP phase is a property of the *original* frame number: select inter
    # frames over the full original listing first, then drop missing pairs
    # (`uvc_codec_eval.py:19-41` applies get_inter_frames before
    # load_image_pairs skips missing files).  Pairing by surviving-pair
    # position would shift the GOP phase after a mid-sequence gap.
    common = [(i, n) for i, n in enumerate(orig_names) if n in pred_set]
    skipped = len(orig_names) - len(common)
    names = [n for _, n in common]
    orig = load_frames(orig_dir, names)
    pred = load_frames(pred_dir, names)
    inter_orig = set(get_inter_frames(len(orig_names), gop_size))
    inter_idx = [k for k, (i, _) in enumerate(common) if i in inter_orig]
    out = {
        "all": calculate_metrics_batch(orig, pred, device=device),
        "inter": calculate_metrics_batch(orig[inter_idx], pred[inter_idx],
                                         device=device)
        if inter_idx else {},
    }
    out["all"]["skipped_frames"] = skipped
    return out


def evaluate_prediction_root(root: str, orig_root: str, gop_size: int,
                             out_json: Optional[str] = None,
                             device="cuda") -> Dict:
    """Walk `{root}/{bpp_case}/{video}` prediction dirs
    (`uvc_codec_eval.py:62-123` layout) and aggregate."""
    results: Dict[str, Dict] = {}
    for bpp_case in sorted(os.listdir(root)):
        case_dir = os.path.join(root, bpp_case)
        if not os.path.isdir(case_dir):
            continue
        results[bpp_case] = {}
        for video in sorted(os.listdir(case_dir)):
            pred_dir = os.path.join(case_dir, video)
            orig_dir = os.path.join(orig_root, video)
            if not (os.path.isdir(pred_dir) and os.path.isdir(orig_dir)):
                continue
            results[bpp_case][video] = evaluate_video(orig_dir, pred_dir,
                                                      gop_size, device)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(results, f, indent=4)
    return results


def evaluate_classical_codec(decoded_root: str, orig_root: str,
                             gop_size: int, width: int = 1920,
                             height: int = 1080, num_frames: int = 96,
                             device="cuda") -> Dict:
    """Classical codec eval: metrics + bpp from `intra_inter_storage.txt`
    (`classical_codec_eval.py:104-133`)."""
    results = {}
    for video in sorted(os.listdir(decoded_root)):
        vdir = os.path.join(decoded_root, video)
        if not os.path.isdir(vdir):
            continue
        entry = evaluate_video(os.path.join(orig_root, video), vdir,
                               gop_size, device)
        storage = os.path.join(vdir, "intra_inter_storage.txt")
        if os.path.exists(storage):
            split = parse_intra_inter_storage(storage)
            total_pixels = num_frames * width * height
            entry["total_bpp"] = split.get("total_bytes", 0) * 8 / \
                total_pixels
            entry["inter_bpp"] = split.get("inter_bytes", 0) * 8 / \
                total_pixels
        results[video] = entry
    return results
