"""GOP structure and codec orchestration.

Counterpart: `diffcodec_tpu/codec/gop.py`, copied (numpy only).  Parity
targets:
  * intra/inter frame selection (`uvc_codec_eval.py:19-26`): every
    `gop_size`-th frame is intra, the rest inter.
  * decoder structure (SURVEY.md sections 0 and 3.2): inter frames are
    regenerated from the two neighbouring anchors + flow conditioning; the
    inter frames of a GOP are conditionally independent given the anchors, so
    they batch embarrassingly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


def get_inter_frames(num_frames: int, gop_size: int) -> List[int]:
    """Indices of inter (regenerated) frames (`uvc_codec_eval.py:19-26`)."""
    return [i for i in range(num_frames) if i % gop_size != 0]


def get_intra_frames(num_frames: int, gop_size: int) -> List[int]:
    return [i for i in range(num_frames) if i % gop_size == 0]


@dataclasses.dataclass(frozen=True)
class GopItem:
    """One inter frame's decode job: anchors + target index."""
    target: int
    anchor_prev: int
    anchor_next: int


def gop_schedule(num_frames: int, gop_size: int) -> List[GopItem]:
    """Decode jobs for all inter frames.  The next anchor of the last
    (possibly truncated) GOP is clamped to the final frame."""
    items = []
    for t in get_inter_frames(num_frames, gop_size):
        prev = (t // gop_size) * gop_size
        nxt = min(prev + gop_size, num_frames - 1)
        items.append(GopItem(target=t, anchor_prev=prev, anchor_next=nxt))
    return items


def batch_gop_conditions(frames: np.ndarray, flows_fwd: Dict[int, np.ndarray],
                         flows_bwd: Dict[int, np.ndarray],
                         schedule: Sequence[GopItem]) -> Dict[str, np.ndarray]:
    """Stack per-inter-frame conditioning into one batch for the sampler.

    frames: [N, H, W, 3] decoded anchor frames in [0, 1] float — or uint8
    in [0, 255], in which case 'cond' stays uint8 (for raw host->device
    transfer with on-device normalization; decoded anchors are uint8 at
    the source so this is lossless).  Only anchor indices are read.
    flows_*: per-target-index [H, W, 2] pixel-unit flows (fwd: anchor_prev
    -> target, bwd: anchor_next -> target, the reference's RAFT convention
    at `validation.py:84-95`).

    Returns {'cond' [B,H,W,6], 'flow' [B,H,W,4]} with cond = r1 ++ r2
    (anchor_prev ++ anchor_next, the UniDataset channel order).
    """
    conds, flows = [], []
    for item in schedule:
        r1 = frames[item.anchor_prev]
        r2 = frames[item.anchor_next]
        conds.append(np.concatenate([r1, r2], axis=-1))
        f = flows_fwd[item.target]
        b = flows_bwd[item.target]
        flows.append(np.concatenate([f, b], axis=-1))
    cond = np.stack(conds)
    if cond.dtype != np.uint8:
        cond = cond.astype(np.float32)
    return {"cond": cond,
            "flow": np.stack(flows).astype(np.float32)}
