"""RD-curve plotting and BD-rate reporting.

Copied from `diffcodec_tpu/eval/plots.py`; matplotlib is imported
inside the functions, since the card's machine has none.

Parity targets: `uvg_plots.py` / `class_b_plots.py` (per-metric RD curves
vs anchors, PDF output), `inter_plots.py` (inter-only curves),
`BD_rate_eval.py:199-221` (BD-rate tables printed per metric).

Anchor RD data (H.264/HEVC/DVC/RLVC/PLVC/DiffVC) is supplied by the caller
as plain dicts — the hardcoded tables the reference embeds in its plot
scripts live in committed artifacts and BASELINE.md, not here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from diffcodec_tpu_torch.eval.bd_rate import bd_rate

# metric name -> higher is better?
METRIC_DIRECTIONS = {"psnr": True, "ms_ssim": True, "msssim": True,
                     "lpips": False, "fid": False, "fvd": False}

RDPoint = Tuple[float, float]  # (bpp, quality)


def plot_rd_curves(curves: Dict[str, Sequence[RDPoint]], metric: str,
                   out_path: str, title: Optional[str] = None,
                   ours_key: str = "Ours") -> None:
    """One RD figure: bpp (x, log-ish) vs metric (y), one line per codec
    (`uvg_plots.py` figure layout)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.5, 4.2))
    for name, pts in curves.items():
        pts = sorted(pts)
        bpp = [p[0] for p in pts]
        q = [p[1] for p in pts]
        style = dict(marker="o", linewidth=2.2) if name == ours_key else \
            dict(marker="s", linewidth=1.2, alpha=0.75)
        ax.plot(bpp, q, label=name, **style)
    ax.set_xlabel("bpp")
    ax.set_ylabel(metric.upper())
    ax.set_title(title or f"RD curve — {metric.upper()}")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)


def bd_rate_table(anchors: Dict[str, Dict[str, Sequence[RDPoint]]],
                  ours: Dict[str, Sequence[RDPoint]]) -> Dict[str,
                                                              Dict[str,
                                                                   float]]:
    """BD-rate % of ours vs each anchor per metric
    (`BD_rate_eval.py:199-221` output structure).

    anchors: {codec: {metric: [(bpp, q), ...]}}; ours: {metric: [...]}
    Returns {codec: {metric: bd_rate_percent}}.
    """
    out = {}
    for codec, metrics in anchors.items():
        out[codec] = {}
        for metric, pts in metrics.items():
            if metric not in ours:
                continue
            higher = METRIC_DIRECTIONS.get(metric.lower(), True)
            R1 = [p[0] for p in pts]
            Q1 = [p[1] for p in pts]
            R2 = [p[0] for p in ours[metric]]
            Q2 = [p[1] for p in ours[metric]]
            out[codec][metric] = bd_rate(R1, Q1, R2, Q2,
                                         higher_better=higher)
    return out


def format_bd_table(table: Dict[str, Dict[str, float]]) -> str:
    metrics = sorted({m for v in table.values() for m in v})
    lines = ["| anchor | " + " | ".join(m.upper() for m in metrics) + " |",
             "|" + "---|" * (len(metrics) + 1)]
    for codec, vals in table.items():
        row = [codec] + [
            f"{vals[m]:+.1f}%" if m in vals and np.isfinite(vals[m])
            else "n/a" for m in metrics]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)
