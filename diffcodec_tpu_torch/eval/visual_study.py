"""Qualitative comparison figures: zoom-crop grids with per-method metrics.

Copied from `diffcodec_tpu/eval/visual_study.py`; matplotlib is
imported inside the function, since the card's machine has none.

Parity target: `bd_rate_visual_study/gen_ablation.py` (214 LoC) and
`gen_title_fig.py` (132 LoC) — rows of [full frame + zoom crop] per method,
metric captions with the best value bolded, PDF/PNG output.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

Crop = Tuple[int, int, int, int]  # (y, x, h, w)


def zoom_crop(frame: np.ndarray, crop: Crop) -> np.ndarray:
    y, x, h, w = crop
    return frame[y:y + h, x:x + w]


def _fmt(value: float, best: bool, decimals: int = 3) -> str:
    s = f"{value:.{decimals}f}"
    return rf"$\bf{{{s}}}$" if best else s


def comparison_figure(gt: np.ndarray,
                      methods: Dict[str, np.ndarray],
                      crop: Crop,
                      metrics: Optional[Dict[str, Dict[str, float]]] = None,
                      metric_higher_better: Optional[Dict[str, bool]] = None,
                      out_path: str = "comparison.png",
                      title: Optional[str] = None) -> None:
    """One comparison row-set: GT + each method, full frame with the crop
    rectangle + the zoomed crop below, metric captions with best-bolded
    values (gen_ablation.py layout).

    metrics: {method: {metric_name: value}}.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.patches as patches

    names = ["GT"] + list(methods.keys())
    frames = [gt] + [methods[k] for k in names[1:]]
    n = len(names)
    metric_higher_better = metric_higher_better or {}

    best: Dict[str, str] = {}
    if metrics:
        metric_names = sorted({m for v in metrics.values() for m in v})
        for m in metric_names:
            vals = {k: v[m] for k, v in metrics.items() if m in v}
            higher = metric_higher_better.get(m, True)
            best[m] = (max if higher else min)(vals, key=vals.get)

    fig, axes = plt.subplots(2, n, figsize=(2.2 * n, 4.6))
    if n == 1:
        axes = axes[:, None]
    y, x, h, w = crop
    for col, (name, frame) in enumerate(zip(names, frames)):
        ax = axes[0, col]
        ax.imshow(frame)
        ax.add_patch(patches.Rectangle((x, y), w, h, linewidth=1.5,
                                       edgecolor="red", facecolor="none"))
        ax.set_title(name, fontsize=9)
        ax.axis("off")
        axz = axes[1, col]
        axz.imshow(zoom_crop(frame, crop))
        axz.axis("off")
        if metrics and name in metrics:
            caption = "\n".join(
                f"{m}: {_fmt(v, best.get(m) == name)}"
                for m, v in sorted(metrics[name].items()))
            axz.set_xlabel(caption, fontsize=7)
            axz.axis("on")
            axz.set_xticks([])
            axz.set_yticks([])
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
