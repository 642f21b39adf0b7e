"""Training data pipeline: Vimeo-style index datasets (UniDataset parity).

Copied from `diffcodec_tpu/train/dataset.py` (numpy and PIL, no JAX): the
same samples, the same `np.random.default_rng(seed)` draws in the same
order, so a sample is bit-identical to the JAX package's.

Parity target: `controlnet/dataset.py` —
  * caption lookup keyed by zero-padded path parts (`dataset.py:26-41`)
  * per-frame dir layout: target png + `r1.png`/`r2.png` anchors +
    `Flow/*.flo`, `Flow_b/*.flo` (npy-cached) (`dataset.py:107-176`)
  * flow downsample by adaptive average pooling (`dataset.py:43-50`)
  * jpg -> [-1,1], conds -> [0,1] (`dataset.py:146-155`)
  * shared ColorJitter across image+anchors (`dataset.py:97-103`) —
    reimplemented in numpy with the same parameter ranges (statistical, not
    bitwise, parity)
  * text dropout p=0.3 (`dataset.py:183-184`)
  * zero-fill fallbacks for missing conds/flows (`dataset.py:159-180`)

Pure numpy/PIL; emits NHWC batches ready for `ControlNetTrainer` and
`ConsistencyDistiller`.

The residue variant additionally warps the anchors to the target and
returns (warped, residual).  Two reference bugs are deliberately FIXED here
(SURVEY.md section 7 "known reference bugs"):
  * `dataset.py:239-250` warps image1 by flow1 twice — we warp image2 by
    flow2 for the backward direction;
  * `dataset.py:256-261` uses occlusion masks as confidences — we use the
    (1 - occlusion) validity weights.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from diffcodec_tpu_torch.utils.flo_io import read_flo


def load_caption_dict(txt_path: str) -> Dict[str, str]:
    """'path: caption' lines -> {zfill(parent1)_parent2: caption}."""
    captions = {}
    with open(txt_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            path, caption = line.split(":", 1)
            parts = path.strip().split("/")
            if len(parts) >= 3:
                key = f"{parts[-3].zfill(5)}_{parts[-2].zfill(4)}"
                captions[key] = caption.strip()
    return captions


def adaptive_avg_pool_flow(flow: np.ndarray, target_h: int,
                           target_w: int) -> np.ndarray:
    """[H,W,2] -> [target_h,target_w,2] by adaptive average pooling
    (torch `F.adaptive_avg_pool2d` bin semantics, `dataset.py:43-50`)."""
    H, W = flow.shape[:2]
    out = np.empty((target_h, target_w, flow.shape[2]), np.float32)
    ys = [(int(np.floor(i * H / target_h)),
           int(np.ceil((i + 1) * H / target_h))) for i in range(target_h)]
    xs = [(int(np.floor(j * W / target_w)),
           int(np.ceil((j + 1) * W / target_w))) for j in range(target_w)]
    for i, (y0, y1) in enumerate(ys):
        row = flow[y0:y1]
        for j, (x0, x1) in enumerate(xs):
            out[i, j] = row[:, x0:x1].reshape(-1, flow.shape[2]).mean(0)
    return out


def load_flow_cached(path: str, target_h: int, target_w: int) -> np.ndarray:
    """Load .npy-cached (or .flo) flow, downsample to target ([h,w,2])."""
    npy = str(path).replace(".flo", ".npy")
    if os.path.exists(npy):
        flow = np.load(npy)
        if flow.ndim == 3 and flow.shape[0] == 2:  # torch cache layout [2,H,W]
            flow = flow.transpose(1, 2, 0)
    else:
        flow = read_flo(str(path))
    return adaptive_avg_pool_flow(flow.astype(np.float32), target_h, target_w)


def _rgb_to_hsv(x):
    maxc = x.max(-1)
    minc = x.min(-1)
    v = maxc
    diff = maxc - minc
    s = np.where(maxc > 0, diff / np.maximum(maxc, 1e-12), 0.0)
    rc = (maxc - x[..., 0]) / np.maximum(diff, 1e-12)
    gc = (maxc - x[..., 1]) / np.maximum(diff, 1e-12)
    bc = (maxc - x[..., 2]) / np.maximum(diff, 1e-12)
    h = np.where(maxc == x[..., 0], bc - gc,
                 np.where(maxc == x[..., 1], 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(diff == 0, 0.0, (h / 6.0) % 1.0)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6
    out = np.zeros(h.shape + (3,), np.float32)
    conds = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q)]
    for k, (r, g, b) in enumerate(conds):
        m = i == k
        out[..., 0][m] = r[m]
        out[..., 1][m] = g[m]
        out[..., 2][m] = b[m]
    return out


def color_jitter(images: Sequence[np.ndarray], rng: np.random.Generator,
                 brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.1, hue: float = 0.1
                 ) -> List[np.ndarray]:
    """Shared-parameter color jitter over uint8 HWC images (the same jitter
    applied to the target and both anchors, `dataset.py:97-103`)."""
    b = rng.uniform(1 - brightness, 1 + brightness)
    c = rng.uniform(1 - contrast, 1 + contrast)
    s = rng.uniform(1 - saturation, 1 + saturation)
    dh = rng.uniform(-hue, hue)
    out = []
    for img in images:
        x = img.astype(np.float32) / 255.0
        x = np.clip(x * b, 0, 1)
        mean = x.mean()
        x = np.clip((x - mean) * c + mean, 0, 1)
        h, sat, v = _rgb_to_hsv(x)
        sat = np.clip(sat * s, 0, 1)
        h = (h + dh) % 1.0
        x = _hsv_to_rgb(h, sat, v)
        out.append((np.clip(x, 0, 1) * 255).astype(np.uint8))
    return out


def _load_image(path: str, resolution: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if img.size != (resolution, resolution):
        img = img.resize((resolution, resolution), Image.BILINEAR)
    return np.asarray(img)


@dataclasses.dataclass
class UniDataset:
    """Index-file dataset emitting numpy sample dicts (NHWC).

    Sample keys: 'image' [H,W,3] in [-1,1]; 'cond' [H,W,6] in [0,1]
    (r1 ++ r2); 'flow' [H,W,4] (fwd ++ bwd, pixel units at full res after
    adaptive-pool downsample); 'text' str.
    """
    anno_path: str
    index_file: str
    local_type_list: Sequence[str] = ("r1", "r2", "flow", "flow_b")
    resolution: int = 512
    drop_txt_prob: float = 0.3
    transform: bool = True
    seed: int = 0

    def __post_init__(self):
        self.annos = load_caption_dict(self.anno_path) if \
            os.path.exists(self.anno_path) else {}
        with open(self.index_file) as f:
            self.video_frames = f.read().splitlines()
        self._rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.video_frames)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img_path = Path(self.video_frames[index])
        seq_id = (f"{img_path.parent.parent.name.zfill(5)}_"
                  f"{img_path.parent.name}")
        anno = self.annos.get(seq_id, "")
        res = self.resolution

        image = _load_image(str(img_path), res)
        conds = []
        for t in self.local_type_list:
            if t in ("r1", "r2"):
                p = img_path.with_name(f"{t}.png")
                conds.append(_load_image(str(p), res) if p.exists() else None)

        present = [c for c in conds if c is not None]
        if self.transform:
            jittered = color_jitter([image] + present, self._rng)
            image = jittered[0]
            it = iter(jittered[1:])
            conds = [next(it) if c is not None else None for c in conds]

        jpg = image.astype(np.float32) / 127.5 - 1.0
        if present:
            cond = np.concatenate(
                [(c.astype(np.float32) / 255.0) if c is not None else
                 np.zeros((res, res, 3), np.float32) for c in conds], axis=2)
        else:
            cond = np.zeros((res, res, 6), np.float32)

        flows = []
        if "flow" in self.local_type_list:
            p = img_path.parent / "Flow" / img_path.name.replace(".png",
                                                                 ".flo")
            if p.exists() or os.path.exists(str(p).replace(".flo", ".npy")):
                flows.append(load_flow_cached(str(p), res, res))
        if "flow_b" in self.local_type_list:
            p = img_path.parent / "Flow_b" / img_path.name.replace(".png",
                                                                   ".flo")
            if p.exists() or os.path.exists(str(p).replace(".flo", ".npy")):
                flows.append(load_flow_cached(str(p), res, res))
        if flows:
            flow = np.concatenate(flows, axis=2)
            if flow.shape[2] == 2:
                flow = np.concatenate(
                    [flow, np.zeros_like(flow)], axis=2)
        else:
            flow = np.zeros((res, res, 4), np.float32)

        if self._rng.random() < self.drop_txt_prob:
            anno = ""
        return {"image": jpg, "cond": cond, "flow": flow, "text": anno}

    def validate(self, limit: Optional[int] = None):
        """Walk the dataset collecting per-sample errors instead of raising
        (the `controlnet/test_data.py:18-50` corrupt-sample sweep with its
        safe_collate semantics).  Returns (ok_count, [(index, error), ...])."""
        errors = []
        n = len(self) if limit is None else min(limit, len(self))
        ok = 0
        for i in range(n):
            try:
                s = self[i]
                for k in ("image", "cond", "flow"):
                    if not np.isfinite(s[k]).all():
                        raise ValueError(f"non-finite values in {k!r}")
                ok += 1
            except Exception as e:  # noqa: BLE001 — collect, don't crash
                errors.append((i, repr(e)))
        return ok, errors

    def iter_batches(self, batch_size: int, text_encoder=None,
                     shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Simple host-side batcher.  `text_encoder(texts) -> [B, L, D]`
        embeds captions (or pass None to emit zeros placeholder handled by
        the trainer)."""
        return iter_dataset_batches(self, batch_size, rng=self._rng,
                                    text_encoder=text_encoder,
                                    shuffle=shuffle)


def iter_dataset_batches(dataset, batch_size: int, rng=None,
                         text_encoder=None, shuffle: bool = True
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Batch any indexable sample-dict dataset: stacks every array key
    (so wrappers like LatentCachedDataset's 'latent_moments' ride along),
    gathers 'text' into a list."""
    rng = rng if rng is not None else np.random.default_rng(0)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[start:start + batch_size]
        samples = [dataset[i] for i in idx]
        batch = {k: np.stack([s[k] for s in samples])
                 for k in samples[0] if k != "text"}
        if "text" in samples[0]:
            batch["text"] = [s["text"] for s in samples]
        if text_encoder is not None:
            batch["text_embeds"] = text_encoder(batch["text"])
        yield batch
