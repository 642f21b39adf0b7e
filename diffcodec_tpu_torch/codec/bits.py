"""Sparse-flow bitstream coding and bpp bookkeeping.

Counterpart: `diffcodec_tpu/codec/bits.py`, copied (numpy only): the
bitstream's bytes are the JAX package's.

The reference stores sparse flow as int8-quantized point lists
(`benchmark_results/sparse_flow_comp_stats.json`: 77-209 points at 556-1222
bytes, i.e. ~6 bytes/point incl. coordinates) produced by an external tool;
this module provides a concrete, self-contained bitstream with the same
cost profile, plus the report writer/parsers used by the bpp accounting
(`calculate_storage_stats_UVC.py:36-65`).

Format (little-endian):
  magic  b'SFL1'
  u16 H, u16 W, u16 count
  f32 scale_u, f32 scale_v          (dequant scales, max|.|/127)
  count x (u16 y, u16 x)            point coordinates
  count x (i8 qu, i8 qv)            quantized flow values
Total = 18 + 6*count bytes (matches the reference cost profile).
"""

from __future__ import annotations

import io
import os
import re
import struct
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = b"SFL1"
HEADER_BYTES = 18  # 4 magic + 2+2+2 (H,W,count) + 4+4 (scales)


def encode_sparse_flow(sparse: np.ndarray, mask: np.ndarray) -> bytes:
    """Encode (sparse flow [H,W,2], mask [H,W,2]) -> bitstream bytes."""
    H, W = sparse.shape[:2]
    ys, xs = np.where(mask[:, :, 0] > 0)
    u = sparse[ys, xs, 0].astype(np.float64)
    v = sparse[ys, xs, 1].astype(np.float64)
    scale_u = max(np.abs(u).max() if len(u) else 0.0, 1e-12) / 127.0
    scale_v = max(np.abs(v).max() if len(v) else 0.0, 1e-12) / 127.0
    qu = np.clip(np.rint(u / scale_u), -127, 127).astype(np.int8)
    qv = np.clip(np.rint(v / scale_v), -127, 127).astype(np.int8)
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(struct.pack("<HHH", H, W, len(ys)))
    buf.write(struct.pack("<ff", scale_u, scale_v))
    buf.write(np.stack([ys, xs], 1).astype("<u2").tobytes())
    buf.write(np.stack([qu, qv], 1).tobytes())
    return buf.getvalue()


def decode_sparse_flow(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Bitstream -> (sparse flow [H,W,2] float32, mask [H,W,2] int32)."""
    if data[:4] != _MAGIC:
        raise ValueError("bad sparse-flow magic")
    H, W, n = struct.unpack("<HHH", data[4:10])
    scale_u, scale_v = struct.unpack("<ff", data[10:18])
    off = 18
    coords = np.frombuffer(data[off:off + 4 * n], "<u2").reshape(n, 2)
    off += 4 * n
    q = np.frombuffer(data[off:off + 2 * n], np.int8).reshape(n, 2)
    sparse = np.zeros((H, W, 2), np.float32)
    mask = np.zeros((H, W, 2), np.int32)
    ys, xs = coords[:, 0].astype(np.int64), coords[:, 1].astype(np.int64)
    sparse[ys, xs, 0] = q[:, 0].astype(np.float32) * scale_u
    sparse[ys, xs, 1] = q[:, 1].astype(np.float32) * scale_v
    mask[ys, xs, :] = 1
    return sparse, mask


# ---------------------------------------------------------------------------
# Compression-report parsing / writing (calculate_storage_stats parity)
# ---------------------------------------------------------------------------

_REGEX_ARROW = re.compile(r"→\s*([\d.]+)\s*(B|KB|MB|KIB|MIB)?", re.IGNORECASE)
_REGEX_COLON = re.compile(r":\s*([\d.]+)\s*(B|KB|MB|KIB|MIB)?", re.IGNORECASE)


def parse_avg_size_any(report_path: str) -> float:
    """Average size in BYTES from a compression report; handles both the
    arrow ('→ 1.94 KB') and colon (': 1406 bytes') formats with KB=1024
    (`calculate_storage_stats_UVC.py:40-65`)."""
    sizes = []
    with open(report_path, "r", encoding="utf-8") as f:
        for line in f:
            m = _REGEX_ARROW.search(line) or _REGEX_COLON.search(line)
            if m:
                val = float(m.group(1))
                unit = (m.group(2) or "").upper()
                if unit in ("KB", "KIB"):
                    val *= 1024
                elif unit in ("MB", "MIB"):
                    val *= 1024 * 1024
                sizes.append(val)
    return float(np.mean(sizes)) if sizes else 0.0


def write_compression_report(path: str, entries: Dict[str, int]) -> None:
    """Write a report in the arrow format the parser understands."""
    with open(path, "w", encoding="utf-8") as f:
        for name, nbytes in entries.items():
            f.write(f"- Frame: {name} → {nbytes / 1024:.4f} KB\n")


def compute_bpp(avg_kb: Dict[str, Optional[float]], gop: int,
                total_frames: int = 96, width: int = 1920,
                height: int = 1080) -> Dict[str, float]:
    """Per-GOP bpp for the three flow-rate modes.

    Exact transcription of the accounting at
    `calculate_storage_stats_UVC.py:116-139`:
      intra_bits  = avg_intra_KB * n_intra * 1024 * 8
      sparse_bits = (fwd+bwd avg KB) * n_inter * 1024 * 8
      dense_bits  = dense avg KB * 2 * n_inter * 1024 * 8
      bpp_*       = (intra [+ flow]) / (frames * W * H)
    """
    n_intra = total_frames // gop
    n_inter = total_frames - n_intra
    total_pixels = total_frames * width * height
    intra_bits = (avg_kb["intra_frame"] or 0.0) * n_intra * 1024 * 8
    sparse_bits = (((avg_kb["flow_sparse_fwd"] or 0.0) +
                    (avg_kb["flow_sparse_bwd"] or 0.0)) * n_inter * 1024 * 8)
    dense_bits = (avg_kb["dense_flow"] or 0.0) * 2 * n_inter * 1024 * 8
    return {
        "none": intra_bits / total_pixels,
        "sparse": (intra_bits + sparse_bits) / total_pixels,
        "dense": (intra_bits + dense_bits) / total_pixels,
    }


def compute_inter_bpp(avg_kb: Dict[str, Optional[float]], gop: int,
                      total_frames: int = 96, width: int = 1920,
                      height: int = 1080) -> Dict[str, float]:
    """Inter-only bpp (flow bits / inter-frame pixels), the variant behind
    `benchmark_results/*_inter_bpp_results.json` / `inter_plots.py:34-53`."""
    n_intra = total_frames // gop
    n_inter = total_frames - n_intra
    total_pixels = total_frames * width * height
    sparse_bits = (((avg_kb["flow_sparse_fwd"] or 0.0) +
                    (avg_kb["flow_sparse_bwd"] or 0.0)) * n_inter * 1024 * 8)
    dense_bits = (avg_kb["dense_flow"] or 0.0) * 2 * n_inter * 1024 * 8
    return {
        "sparse": sparse_bits / total_pixels,
        "dense": dense_bits / total_pixels,
    }
