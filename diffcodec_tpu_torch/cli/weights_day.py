"""Weights-day one-command playbook: checkpoints in -> the full RD gate out.

Counterpart: `scripts/weights_day.py` (the same options and report, with
`--device`).  The day real SD-1.5 / DualFlowControlNet / LPIPS / I3D / CMP
checkpoints land, one command produces the complete quality report:

  python -m diffcodec_tpu_torch.cli.weights_day \\
      --sd_checkpoint_dir /ckpts/sd15 --aux_checkpoint_dir /ckpts/aux \\
      --dataset_root /data/uvg --out /tmp/weights_day \\
      [--distilled_checkpoint /runs/distill] [--with_drift]

Stages:
  1. RD sweep (`cli.rd_sweep`): encode/decode every video at every
     (GOP x rate-mode) point, PSNR/MS-SSIM/LPIPS/FID/FVD, bpp bookkeeping
     in the calculate_storage_stats_UVC.py format, RD curve PDFs.
  2. BD-rate tables against the committed anchor RD data (bd_test.py:7-53
     tables vendored in `eval/anchors_data.py`): both the BD_rate_eval.py
     protocol (100-point trapezoid) and the bjontegaard-library math
     (exact PCHIP integration), per metric, per GOP, and a side-by-side
     of the measured points against the reference's committed "ours" RD
     points.
  3. Distilled-student quality gate (`cli.distill_eval`): student-K
     against the 30-step teacher's PSNR, when --distilled_checkpoint is
     given.
  4. Approximation drift (`cli.approx_drift`): exact-against-cached
     latent/pixel deltas for the caching knobs (--with_drift; seven
     decodes at 512 px, or at 128 px with --tiny), written to
     `{out}/approx_drift.json` and read back from there.

Emits {out}/weights_day_report.json and weights_day_report.md.  Frames
come through PIL and the RD plots through matplotlib (stage 1), so this
runs where both are; the decodes and the metrics run on `--device`.
"""

from __future__ import annotations

import argparse
import json
import os


def aggregate_rd_points(bpp_results, metric_results, modes):
    """{gop: {mode: (mean bpp, {metric: mean value})}} over videos —
    the reference aggregates UVG the same way (bd_test.py tables are
    dataset means)."""
    import numpy as np

    out = {}
    for g, vids in bpp_results.items():
        out[g] = {}
        for mode in modes:
            rows = [(vids[v][mode],
                     metric_results[g][v][mode]["all"])
                    for v in vids if mode in vids[v]]
            if not rows:
                continue
            bpp = float(np.mean([r[0] for r in rows]))
            metrics = {}
            for k in rows[0][1]:
                vals = [r[1][k] for r in rows
                        if r[1][k] is not None and np.isfinite(r[1][k])]
                if vals:
                    metrics[k] = float(np.mean(vals))
            out[g][mode] = (bpp, metrics)
    return out


def bd_tables(points, modes):
    """BD-rate of our measured (gop x mode) curves vs the committed
    anchors, per metric; NaN-safe for short/degenerate test curves."""
    import numpy as np

    from diffcodec_tpu_torch.eval.anchors_data import (H264_UVG,
                                                       HEVC_UVG_GOP4,
                                                       HEVC_UVG_GOP8,
                                                       OURS_UVG)
    from diffcodec_tpu_torch.eval.bd_rate import (bd_rate,
                                                  bd_rate_pchip_exact)

    # the H.264 anchor curve is GOP-independent (bd_test.py uses the same
    # H264 table for both GOP rows); HEVC tables are committed per GOP
    def anchors_for(g):
        out = [("H.264", H264_UVG)]
        if g == "8":
            out.append(("HEVC", HEVC_UVG_GOP8))
        elif g == "4":
            out.append(("HEVC", HEVC_UVG_GOP4))
        return out
    metric_dirs = (("psnr", True), ("ms_ssim", True), ("lpips", False),
                   ("fid", False))
    table, reference_rows = {}, {}
    for g, by_mode in points.items():
        curve_bpp = [by_mode[m][0] for m in modes if m in by_mode]
        if len(curve_bpp) < 2:
            continue
        table[g] = {}
        for metric, higher in metric_dirs:
            q = [by_mode[m][1].get(metric) for m in modes if m in by_mode]
            if any(v is None for v in q):
                continue
            sign = 1.0 if higher else -1.0
            qs = [sign * v for v in q]
            table[g][metric] = {}
            for name, anchor in anchors_for(g):
                if metric not in anchor:
                    continue
                qa = [sign * v for v in anchor[metric]]
                table[g][metric][name] = {
                    "bd_rate_protocol_pct": bd_rate(
                        anchor["bpp"], qa, curve_bpp, qs,
                        higher_better=True),
                    "bd_rate_pchip_exact_pct": bd_rate_pchip_exact(
                        anchor["bpp"], qa, curve_bpp, qs,
                        higher_better=True),
                }
        # side-by-side vs the reference's committed "ours" points
        gop_i = int(g)
        if gop_i in OURS_UVG:
            ref = OURS_UVG[gop_i]
            rows = []
            for i, m in enumerate(mm for mm in ("none", "sparse", "dense")
                                  if mm in by_mode):
                bpp, mets = by_mode[m]
                row = {"mode": m, "bpp_ours": bpp,
                       "bpp_reference": ref["bpp"][i]
                       if i < len(ref["bpp"]) else None}
                for metric, _ in metric_dirs:
                    if metric in mets and i < len(ref.get(metric, [])):
                        row[f"{metric}_ours"] = mets[metric]
                        row[f"{metric}_reference"] = ref[metric][i]
                rows.append(row)
            reference_rows[g] = rows
    return table, reference_rows


def render_md(report):
    """weights_day_report.md from the JSON report."""
    import numpy as np

    lines = ["# Weights-day report", ""]
    lines.append(f"- sd_checkpoint_dir: `{report['args']['sd']}`")
    lines.append(f"- aux_checkpoint_dir: `{report['args']['aux']}`")
    lines.append(f"- dataset_root: `{report['args']['dataset']}`")
    lines.append("")
    lines.append("## Measured RD points (dataset mean, all frames)")
    lines.append("")
    lines.append("| GOP | mode | bpp | PSNR | MS-SSIM | LPIPS | FID |")
    lines.append("|---|---|---|---|---|---|---|")
    for g, by_mode in sorted(report["rd_points"].items()):
        for mode, (bpp, mets) in by_mode.items():
            def f(k):
                v = mets.get(k)
                return f"{v:.4f}" if v is not None else "—"
            lines.append(f"| {g} | {mode} | {bpp:.5f} | {f('psnr')} | "
                         f"{f('ms_ssim')} | {f('lpips')} | {f('fid')} |")
    lines.append("")
    if report["bd_tables"]:
        lines.append("## BD-rate vs anchors (negative = we need fewer "
                     "bits at equal quality)")
        lines.append("")
        lines.append("| GOP | metric | anchor | BD-rate (protocol) | "
                     "BD-rate (pchip exact) |")
        lines.append("|---|---|---|---|---|")
        for g, per_metric in sorted(report["bd_tables"].items()):
            for metric, per_anchor in per_metric.items():
                for name, vals in per_anchor.items():
                    p = vals["bd_rate_protocol_pct"]
                    e = vals["bd_rate_pchip_exact_pct"]
                    ps = f"{p:+.2f}%" if np.isfinite(p) else "NaN"
                    es = f"{e:+.2f}%" if np.isfinite(e) else "NaN"
                    lines.append(f"| {g} | {metric} | {name} | {ps} "
                                 f"| {es} |")
        lines.append("")
    if report["reference_comparison"]:
        lines.append("## Side-by-side vs the reference's committed RD "
                     "points (bd_test.py:7-53)")
        lines.append("")
        for g, rows in sorted(report["reference_comparison"].items()):
            lines.append(f"GOP {g}:")
            lines.append("")
            lines.append("| mode | bpp ours / ref | PSNR ours / ref | "
                         "MS-SSIM ours / ref |")
            lines.append("|---|---|---|---|")
            for r in rows:
                def pair(k):
                    a, b = r.get(f"{k}_ours"), r.get(f"{k}_reference")
                    if a is None or b is None:
                        return "—"
                    return f"{a:.4f} / {b:.4f}"
                bp = (f"{r['bpp_ours']:.5f} / {r['bpp_reference']:.5f}"
                      if r.get("bpp_reference") is not None
                      else f"{r['bpp_ours']:.5f} / —")
                lines.append(f"| {r['mode']} | {bp} | {pair('psnr')} | "
                             f"{pair('ms_ssim')} |")
            lines.append("")
    if report.get("distill"):
        lines.append("## Distilled student quality gate")
        lines.append("")
        lines.append("| K | PSNR vs 30-step teacher (dB) |")
        lines.append("|---|---|")
        for k, row in sorted(report["distill"]["per_k"].items()):
            lines.append(f"| {k} | {row['psnr_vs_teacher_db']:.2f} |")
        lines.append("")
    if report.get("drift"):
        lines.append("## Caching-knob drift (exact vs cached)")
        lines.append("")
        lines.append("| mode | latent rel err | pixel PSNR (dB) |")
        lines.append("|---|---|---|")
        for mode, row in report["drift"].items():
            if not isinstance(row, dict) or "latent_rel_err" not in row:
                continue
            lines.append(f"| {mode} | {row['latent_rel_err']:.2e} | "
                         f"{row.get('pixel_psnr_db', float('nan')):.1f} |")
        lines.append("")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--sd_checkpoint_dir", required=True)
    ap.add_argument("--aux_checkpoint_dir", default="")
    ap.add_argument("--dataset_root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--controlnet_checkpoint", default="")
    ap.add_argument("--distilled_checkpoint", default="")
    ap.add_argument("--student_steps", type=int, default=4)
    ap.add_argument("--gops", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--modes", nargs="+",
                    default=["none", "sparse", "dense"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--guidance", type=float, default=3.5)
    ap.add_argument("--cond_scale", type=float, default=1.35)
    ap.add_argument("--intra_quality", type=int, default=30)
    ap.add_argument("--max_frames", type=int, default=96)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model configs (drill/smoke mode)")
    ap.add_argument("--with_drift", action="store_true",
                    help="also run the exact-against-cached drift matrix "
                         "(cli.approx_drift; seven decodes)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from diffcodec_tpu_torch.cli import approx_drift, distill_eval, rd_sweep

    os.makedirs(args.out, exist_ok=True)
    report = {"args": {"sd": args.sd_checkpoint_dir,
                       "aux": args.aux_checkpoint_dir,
                       "dataset": args.dataset_root,
                       "distilled": args.distilled_checkpoint}}

    # 1. RD sweep ---------------------------------------------------------
    rd_out = os.path.join(args.out, "rd")
    sweep_args = ["--dataset_root", args.dataset_root, "--out", rd_out,
                  "--gops", *map(str, args.gops), "--modes", *args.modes,
                  "--steps", str(args.steps),
                  "--guidance", str(args.guidance),
                  "--cond_scale", str(args.cond_scale),
                  "--intra_quality", str(args.intra_quality),
                  "--max_frames", str(args.max_frames),
                  "--sd_checkpoint_dir", args.sd_checkpoint_dir,
                  "--device", args.device]
    if args.tiny:
        sweep_args.append("--tiny")
    if args.aux_checkpoint_dir:
        sweep_args += ["--aux_checkpoint_dir", args.aux_checkpoint_dir]
    if args.controlnet_checkpoint:
        sweep_args += ["--controlnet_checkpoint",
                       args.controlnet_checkpoint]
    print("== stage 1/4: RD sweep ==", flush=True)
    rd_sweep.main(sweep_args)
    with open(os.path.join(rd_out, "bpp_results.json")) as f:
        bpp_results = json.load(f)
    with open(os.path.join(rd_out, "metric_results.json")) as f:
        metric_results = json.load(f)

    # 2. BD tables --------------------------------------------------------
    print("== stage 2/4: BD-rate tables ==", flush=True)
    points = aggregate_rd_points(bpp_results, metric_results, args.modes)
    report["rd_points"] = points
    table, ref_rows = bd_tables(points, args.modes)
    report["bd_tables"] = table
    report["reference_comparison"] = ref_rows

    # 3. Distilled quality gate --------------------------------------------
    if args.distilled_checkpoint:
        print("== stage 3/4: distilled student gate ==", flush=True)
        dout = os.path.join(args.out, "distill_eval.json")
        deval_args = ["--distilled_checkpoint", args.distilled_checkpoint,
                      "--k_values",
                      ",".join(str(k) for k in
                               sorted({1, 2, args.student_steps})),
                      "--steps", str(args.steps), "--out", dout,
                      "--device", args.device]
        if args.tiny:
            # the drill's gate runs from the student checkpoint alone, on
            # distill_eval's tiny models at 128 px
            deval_args += ["--small", "--batch", "1"]
        elif args.sd_checkpoint_dir:
            deval_args += ["--sd_checkpoint_dir", args.sd_checkpoint_dir]
        distill_eval.main(deval_args)
        with open(dout) as f:
            report["distill"] = json.load(f)
    else:
        print("== stage 3/4: skipped (no --distilled_checkpoint) ==",
              flush=True)

    # 4. Approximation drift ------------------------------------------------
    if args.with_drift:
        print("== stage 4/4: caching-knob drift ==", flush=True)
        drift_out = os.path.join(args.out, "approx_drift.json")
        approx_drift.main(["--out", drift_out, "--device", args.device]
                          + (["--small", "--batch", "1"] if args.tiny
                             else []))
        with open(drift_out) as f:
            report["drift"] = json.load(f)
    else:
        print("== stage 4/4: skipped (pass --with_drift) ==", flush=True)

    with open(os.path.join(args.out, "weights_day_report.json"), "w") as f:
        json.dump(report, f, indent=2, default=float)
    with open(os.path.join(args.out, "weights_day_report.md"), "w") as f:
        f.write(render_md(report))
    print("wrote", os.path.join(args.out, "weights_day_report.{json,md}"))
    return report


if __name__ == "__main__":
    main()
