"""Regenerate the reference's RD-figure and BD-table set from anchors_data.

Counterpart: `scripts/make_figures.py`.  From the published data tables
alone (no model run):
  * UVG GOP-8 and GOP-4 7-codec RD curves per metric
    (`uvg_plots.py:183-243` figure set),
  * Class-B anchor RD curves (`class_b_plots.py:186-243`),
  * inter-frame-only GOP-4 UVG curves (`inter_plots.py`, from the
    committed results_gop4_inter.npy means),
  * BD-rate tables of Ours against every anchor per metric
    (`BD_rate_eval.py:199-221` output).

  python -m diffcodec_tpu_torch.cli.make_figures [outdir]

`outdir` defaults to `build/figures` (git-ignored); the JAX package's
committed `artifacts/bd_tables.md` and `artifacts/figures/` are not
touched.  Writes `{outdir}/bd_tables.md` and `{outdir}/figures/*.png`;
matplotlib is imported where a figure is drawn (`eval/plots.py`), so the
figures need a host that has it.
"""

from __future__ import annotations

import os
import sys

from diffcodec_tpu_torch.eval.anchors_data import (classb_rd_curves,
                                                   uvg_inter_rd_curves,
                                                   uvg_rd_curves)
from diffcodec_tpu_torch.eval.plots import (bd_rate_table, format_bd_table,
                                            plot_rd_curves)

METRICS = ("psnr", "ms_ssim", "lpips", "fid", "fvd")
DEFAULT_OUT = os.path.join("build", "figures")


def figures_for(anchors, ours, tag, outdir):
    for metric in METRICS:
        curves = {name: m[metric] for name, m in anchors.items()
                  if metric in m}
        if ours and metric in ours:
            curves["Ours"] = ours[metric]
        if not curves:
            continue
        plot_rd_curves(curves, metric,
                       os.path.join(outdir, f"{tag}_{metric}.png"),
                       title=f"{tag.replace('_', ' ')} — {metric.upper()}")


def bd_tables_md() -> str:
    """`bd_tables.md`'s text: the UVG GOP-8 and GOP-4 BD-rate tables and
    the inter-frame-only GOP-4 one."""
    sections = []
    for gop in (8, 4):
        anchors, ours = uvg_rd_curves(gop=gop)
        sections.append(f"## UVG GOP {gop}: BD-rate of Ours vs anchor "
                        f"(negative = Ours cheaper at equal quality)\n\n"
                        + format_bd_table(bd_rate_table(anchors, ours)))
    inter_anchors, inter_ours = uvg_inter_rd_curves()
    sections.append("## UVG GOP 4, inter-frame-only bits\n\n"
                    + format_bd_table(bd_rate_table(inter_anchors,
                                                    inter_ours)))
    return ("# BD-rate tables (regenerated from "
            "diffcodec_tpu_torch.eval.anchors_data)\n\n"
            + "\n\n".join(sections) + "\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else DEFAULT_OUT
    figdir = os.path.join(outdir, "figures")
    os.makedirs(figdir, exist_ok=True)

    for gop in (8, 4):
        anchors, ours = uvg_rd_curves(gop=gop)
        figures_for(anchors, ours, f"uvg_gop{gop}", figdir)
    figures_for(classb_rd_curves(), None, "classb", figdir)
    inter_anchors, inter_ours = uvg_inter_rd_curves()
    figures_for(inter_anchors, inter_ours, "uvg_gop4_inter", figdir)

    report = os.path.join(outdir, "bd_tables.md")
    with open(report, "w") as f:
        f.write(bd_tables_md())
    n_figs = len(os.listdir(figdir))
    print(f"wrote {n_figs} figures to {figdir} and {report}")


if __name__ == "__main__":
    main()
