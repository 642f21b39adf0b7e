"""The RD sweep: encode and decode every video at every (GOP, rate mode)
point and write the benchmark_results-format JSONs.

Counterpart: `scripts/rd_sweep.py` (the same options and files, and
`--device`; with `--distilled_checkpoint` and `--student_steps` it sweeps
with the K-step student of a `cli.train_distill` run).  Walks `{dataset_root}/{video}/frames` (with
`Flow/` and `Flow_b/` .flo directories for the sparse and dense modes),
runs the codec at GOPs x rate modes, evaluates PSNR and MS-SSIM (LPIPS,
FID and FVD with `--aux_checkpoint_dir`, whose CMP also densifies the
sparse mode), all frames and inter frames only, and writes

  {out}/bpp_results.json          (calculate_storage_stats_UVC.py format)
  {out}/inter_bpp_results.json
  {out}/metric_results.json
  {out}/rd_{metric}.pdf

  python -m diffcodec_tpu_torch.cli.rd_sweep --dataset_root UVG --out rd \\
      --sd_checkpoint_dir SD15 --controlnet_checkpoint CN.safetensors \\
      --aux_checkpoint_dir AUX

Frames come through PIL and the plots through matplotlib (imported where
they are drawn): run it where both are; the decode and the metrics run on
`--device`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    from diffcodec_tpu_torch.cli.run_codec import (add_decode_options,
                                                   build_sampler)

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--dataset_root", required=True,
                    help="dir of {video}/frames[/Flow, /Flow_b]")
    ap.add_argument("--out", required=True)
    ap.add_argument("--gops", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--modes", nargs="+",
                    default=["none", "sparse", "dense"])
    ap.add_argument("--intra_quality", type=int, default=30)
    ap.add_argument("--max_frames", type=int, default=96)
    ap.add_argument("--aux_checkpoint_dir", default="",
                    help="root of lpips/ i3d/ cmp/ inception/ torch "
                         "checkpoints: LPIPS, FVD and FID, and the CMP "
                         "densifier for the sparse mode")
    add_decode_options(ap)
    ap.set_defaults(prompt="a high quality video frame")
    args = ap.parse_args(argv)

    import torch

    from diffcodec_tpu_torch.codec.gop import gop_schedule
    from diffcodec_tpu_torch.codec.runner import decode_video, encode_video
    from diffcodec_tpu_torch.config import CodecConfig
    from diffcodec_tpu_torch.eval.codec_eval import load_frames
    from diffcodec_tpu_torch.eval.metrics import calculate_metrics_batch
    from diffcodec_tpu_torch.eval.plots import plot_rd_curves
    from diffcodec_tpu_torch.utils.flo_io import read_flo

    device = args.device
    videos = sorted(d for d in os.listdir(args.dataset_root)
                    if os.path.isdir(os.path.join(args.dataset_root, d)))
    if not videos:
        raise SystemExit(f"no videos under {args.dataset_root}")
    sample_fn = build_sampler(args, device)

    lpips_fn = fid_fn = fvd_fn = densify_fn = None
    if args.aux_checkpoint_dir:
        from diffcodec_tpu_torch.codec.runner import make_cmp_densifier
        from diffcodec_tpu_torch.eval.frechet import make_i3d_feature_fn
        from diffcodec_tpu_torch.eval.inception import make_fid64_feature_fn
        from diffcodec_tpu_torch.models.weights import load_aux_checkpoints
        from diffcodec_tpu_torch.train.lpips import make_lpips_fn

        aux = load_aux_checkpoints(args.aux_checkpoint_dir, strict=False,
                                   device=device)
        if "lpips" in aux:
            lpips_fn = make_lpips_fn(aux["lpips"], device=device)
        if "inception" in aux:
            fid_fn = make_fid64_feature_fn(aux["inception"], device=device)
        if "i3d" in aux:
            fvd_fn = make_i3d_feature_fn(aux["i3d"], device=device)
        if "cmp" in aux:
            densify_fn = make_cmp_densifier(aux["cmp"], device)
        print(f"aux checkpoints loaded: {sorted(aux)}")

    bpp_results, inter_bpp, metrics_out = {}, {}, {}
    for gop in args.gops:
        g = str(gop)
        bpp_results[g], inter_bpp[g], metrics_out[g] = {}, {}, {}
        for video in videos:
            vdir = os.path.join(args.dataset_root, video)
            frames = load_frames(os.path.join(vdir, "frames"))
            frames = frames[:args.max_frames]
            N = frames.shape[0]
            flows_f = flows_b = None
            if os.path.isdir(os.path.join(vdir, "Flow")):
                flows_f, flows_b = {}, {}
                for item in gop_schedule(N, gop):
                    t = item.target
                    flows_f[t] = read_flo(os.path.join(
                        vdir, "Flow", f"flow_{t:04d}.flo"))
                    flows_b[t] = read_flo(os.path.join(
                        vdir, "Flow_b", f"flow_{t:04d}.flo"))
            bpp_results[g][video] = {}
            inter_bpp[g][video] = {}
            metrics_out[g][video] = {}
            for mode in args.modes:
                if mode != "none" and flows_f is None:
                    continue
                tag = f"gop{gop}_{mode}"
                enc = encode_video(
                    frames, os.path.join(args.out, "bitstreams", video, tag),
                    CodecConfig(gop_size=gop, flow_rate_mode=mode),
                    flows_fwd=flows_f, flows_bwd=flows_b,
                    intra_quality=args.intra_quality)
                bpp_results[g][video][mode] = enc.meta["bpp"]["total"]
                inter_bpp[g][video][mode] = enc.meta["bpp"]["flow"]
                decoded = decode_video(enc, sample_fn, densify_fn,
                                       transfer_dtype=torch.bfloat16,
                                       device=device)
                inter_idx = [i for i in range(N) if i % gop != 0]
                # I3D's temporal receptive field wants a real clip: FVD
                # only where the subset has 16 frames or more
                metrics_out[g][video][mode] = {
                    "all": calculate_metrics_batch(
                        frames, decoded, lpips_fn=lpips_fn, fid_fn=fid_fn,
                        fvd_fn=fvd_fn if N >= 16 else None, device=device),
                    "inter": calculate_metrics_batch(
                        frames[inter_idx], decoded[inter_idx],
                        lpips_fn=lpips_fn, fid_fn=fid_fn,
                        fvd_fn=fvd_fn if len(inter_idx) >= 16 else None,
                        device=device),
                }
                print(f"{video} {tag}: bpp={enc.meta['bpp']['total']:.5f} "
                      f"psnr={metrics_out[g][video][mode]['all']['psnr']:.2f}")

    os.makedirs(args.out, exist_ok=True)
    for name, table in (("bpp_results", bpp_results),
                        ("inter_bpp_results", inter_bpp),
                        ("metric_results", metrics_out)):
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(table, f, indent=4)

    # RD curves: the mean over videos, one point per (gop, mode)
    for metric in ("psnr", "ms_ssim"):
        pts = []
        for g in bpp_results:
            for mode in args.modes:
                vals = [(bpp_results[g][v][mode],
                         metrics_out[g][v][mode]["all"][metric])
                        for v in bpp_results[g] if mode in bpp_results[g][v]]
                if vals:
                    pts.append((float(np.mean([x[0] for x in vals])),
                                float(np.mean([x[1] for x in vals]))))
        if pts:
            plot_rd_curves({"Ours": pts}, metric,
                           os.path.join(args.out, f"rd_{metric}.pdf"))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
