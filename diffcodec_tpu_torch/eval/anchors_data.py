"""Published anchor RD points for BD-rate comparisons.

Copied from `diffcodec_tpu/eval/anchors_data.py` (data only).

These are the benchmark *data* tables the reference hardcodes in its
BD/plot scripts (`bd_test.py:7-53`, `BD_rate_eval.py:84-133`,
`uvg_plots.py:97-148,132-148`, `class_b_plots.py:91-159`,
`inter_plots.py:34-53`) plus across-video means of its committed artifacts
(`benchmark_results/rlvc_*.json`, `plvc_*`, `results_gop4_inter.npy`) —
the operating points of "Ours" and the classical/learned anchors on UVG
and HEVC Class B.  Format: {codec: {metric: [(bpp, quality), ...]}} ready
for `eval.plots.bd_rate_table` / `plot_rd_curves`.
"""

from __future__ import annotations

# "Ours" (the reference's published operating points), UVG, all frames.
# Columns per GOP: flow-rate modes none / sparse / dense.
OURS_UVG = {
    8: {
        "bpp": [0.008151, 0.013398, 0.024487],
        "psnr": [24.7537, 25.2568, 24.7502],
        "ms_ssim": [0.8587, 0.8702, 0.8514],
        "lpips": [0.1159, 0.1137, 0.1241],
        "fid": [1.2553, 1.2684, 1.2775],
    },
    4: {
        "bpp": [0.0163, 0.0208, 0.0303],
        "psnr": [26.0057, 27.3825, 25.9525],
        "ms_ssim": [0.9067, 0.9218, 0.9023],
        "lpips": [0.1295, 0.1217, 0.1365],
        "fid": [2.2353, 2.1344, 2.2206],
    },
}

# Anchors (bd_test.py tables), UVG
H264_UVG = {
    "bpp": [0.00511, 0.00862, 0.0469],
    "psnr": [24.363, 24.844, 25.617],
    "ms_ssim": [0.7921, 0.8038, 0.8097],
    "lpips": [0.1672, 0.1261, 0.0789],
    "fid": [1.2512, 0.6382, 0.0513],
}

HEVC_UVG_GOP8 = {
    "bpp": [0.00733, 0.00935, 0.0387],
    "psnr": [24.693, 24.925, 25.312],
    "ms_ssim": [0.8616, 0.8738, 0.8917],
    "lpips": [0.1757, 0.1346, 0.0602],
    "fid": [2.1156, 1.1488, 0.1045],
}

HEVC_UVG_GOP4 = {
    "bpp": [0.00873, 0.01087, 0.0387],
    "psnr": [24.110, 24.327, 25.197],
    "ms_ssim": [0.7920, 0.7986, 0.8085],
    "lpips": [0.2152, 0.1780, 0.0906],
    "fid": [3.7534, 2.2539, 0.1849],
}

# PLVC (benchmark_results/plvc_metrics_uvg.csv rows lo/mi/hi)
PLVC_UVG = {
    "bpp": [0.0229, 0.0497, 0.0745],
    "psnr": [35.12, 37.91, 39.98],
    "ms_ssim": [0.9774, 0.9861, 0.9895],
    "lpips": [0.0212, 0.0128, 0.0072],
    "fid": [0.0837, 0.0591, 0.0331],
    "fvd": [21094.9156, 6380.0007, 3109.0713],
}

# DVC (literature points hardcoded at `uvg_plots.py:132-139`)
DVC_UVG = {
    "bpp": [0.05, 0.10, 0.15, 0.20],
    "psnr": [33.1, 34.85, 36.3, 37.5],
    "ms_ssim": [0.939, 0.953, 0.964, 0.971],
    "lpips": [0.155, 0.13, 0.121, 0.105],
    "fid": [22, 15, 11.5, 8],
    "fvd": [19000, 10002, 7000, 4000],
}

# DiffVC (literature points hardcoded at `uvg_plots.py:141-148`)
DIFFVC_UVG = {
    "bpp": [0.02, 0.05, 0.1, 0.155],
    "psnr": [30.3, 31.6, 32.3, 32.5],
    "ms_ssim": [0.91, 0.93, 0.95, 0.956],
    "lpips": [0.25, 0.065, 0.095, 0.014],
    "fid": [5, 4.3, 2.1, 1.09],
    "fvd": [700000, 670000, 500200, 350000],
}

# RLVC: per-resolution-block means over the committed per-video tables
# (`benchmark_results/rlvc_uvg_results.json` averaged the way
# `uvg_plots.py:9-55` does, blocks _PSNR_256 / _PSNR_512 / _PSNR_1024),
# sorted by bpp.
RLVC_UVG = {
    "bpp": [0.105029, 0.16794, 0.284151],
    "psnr": [38.037338, 40.334753, 42.064852],
    "ms_ssim": [0.987303, 0.991701, 0.994114],
    "lpips": [0.023153, 0.014749, 0.006207],
    "fid": [0.183445, 0.141391, 0.022798],
    "fvd": [7934.29677, 3722.73996, 2366.726228],
}

# --- HEVC Class B (class_b_plots.py anchor set) ---

# DVC (`class_b_plots.py:134-141`)
DVC_CLASSB = {
    "bpp": [0.1, 0.2, 0.3],
    "psnr": [31.5, 33.0, 34.0],
    "ms_ssim": [0.942, 0.955, 0.962],
    "lpips": [0.156, 0.135, 0.10],
    "fid": [74, 40, 28.5],
    "fvd": [35000, 25000, 20000],
}

# RLVC (`class_b_plots.py:143-150`; identical to the per-block means of
# `benchmark_results/rlvc_classb_results.json`)
RLVC_CLASSB = {
    "bpp": [0.060807, 0.097379, 0.165579],
    "psnr": [37.707968, 40.265765, 41.997304],
    "ms_ssim": [0.989323, 0.993480, 0.995341],
    "lpips": [0.020047, 0.011311, 0.005088],
    "fid": [0.078204, 0.058928, 0.009942],
    "fvd": [18223.082329, 5635.863374, 2166.578799],
}

# DiffVC (`class_b_plots.py:152-159`)
DIFFVC_CLASSB = {
    "bpp": [0.03, 0.06, 0.11, 0.15],
    "psnr": [26, 27, 27.5, 27.8],
    "ms_ssim": [0.90, 0.925, 0.935, 0.938],
    "lpips": [0.124, 0.085, 0.075, 0.07],
    "fid": [20, 12, 8, 4.2],
    "fvd": [890000, 755600, 675956, 578000],
}

# PLVC: per-block means of `benchmark_results/plvc_classb_results.json`
# (averaged the way `class_b_plots.py:9-55` does), sorted by bpp.
PLVC_CLASSB = {
    "bpp": [0.049767, 0.09009, 0.170975],
    "psnr": [25.758655, 27.380988, 29.284939],
    "ms_ssim": [0.874575, 0.904184, 0.930614],
    "lpips": [0.062432, 0.050501, 0.034984],
    "fid": [0.052854, 0.040125, 0.007087],
    "fvd": [652991.110474, 940036.963806, 700049.275763],
}

# "Ours" Class-B total bpp per rate mode at GOP 8 (`class_b_plots.py:91-93`).
# The matching quality metrics are read from `all_videos_metrics.json` files
# on the authors' cluster (`class_b_plots.py:78-87`) and are NOT committed to
# the reference repo, so only the rate side is reproducible here.
OURS_CLASSB_BPP_GOP8 = {"none": 0.010576381713085276,
                        "sparse": 0.016294097465696863,
                        "dense": 0.02433612870366008}

# --- Inter-frame-only bpp tables (`inter_plots.py:34-53`): flow bits only,
# intra bits excluded; "none" mode stores no inter bits at all. ---
INTER_BPP_UVG = {
    2: {"none": 0.0, "sparse": 0.002998393196309863,
        "dense": 0.009334509112286891},
    4: {"none": 0.0, "sparse": 0.004497589794464794,
        "dense": 0.014001763668430336},
    8: {"none": 0.0, "sparse": 0.00524718809354226,
        "dense": 0.01633539094650206},
}

INTER_BPP_CLASSB = {
    2: {"none": 0.0, "sparse": 0.0032672661443494773,
        "dense": 0.007862712566042745},
    4: {"none": 0.0, "sparse": 0.004900899216524217,
        "dense": 0.011794068849064119},
    8: {"none": 0.0, "sparse": 0.005717715752611587,
        "dense": 0.013759746990574803},
}


# --- Inter-frame-only RD tables (GOP 4, UVG): across-video means of the
# committed per-video artifact `benchmark_results/results_gop4_inter.npy`
# (the data behind `inter_plots.py`-style figures; HEVC rows are the four
# rate points per video, Ours rows the hi/mi/lo quality settings, here
# sorted by bpp). ---
HEVC_UVG_GOP4_INTER = {
    "bpp": [0.000715, 0.000902, 0.005787, 0.014634],
    "psnr": [24.12389, 24.314055, 25.134315, 25.386973],
    "ms_ssim": [0.794791, 0.800077, 0.808179, 0.808983],
    "lpips": [0.216961, 0.179713, 0.09146, 0.081177],
    "fid": [4.009987, 2.444586, 0.216531, 0.094668],
}

OURS_UVG_GOP4_INTER = {
    "bpp": [0.005952, 0.006269, 0.007142],
    "psnr": [23.826249, 23.827501, 23.826525],
    "ms_ssim": [0.879882, 0.879959, 0.879951],
    "lpips": [0.107067, 0.106955, 0.106987],
    "fid": [1.323439, 1.326203, 1.329397],
}


def _to_curves(table):
    bpp = table["bpp"]
    return {m: list(zip(bpp, v)) for m, v in table.items() if m != "bpp"}


def uvg_rd_curves(gop: int = 8):
    """{codec: {metric: [(bpp, q), ...]}} for the 7-codec UVG comparison at
    a GOP (`uvg_plots.py:183-191` dataset list)."""
    anchors = {
        "H.264": _to_curves(H264_UVG),
        "HEVC": _to_curves(HEVC_UVG_GOP8 if gop == 8 else HEVC_UVG_GOP4),
        "DVC": _to_curves(DVC_UVG),
        "RLVC": _to_curves(RLVC_UVG),
        "PLVC": _to_curves(PLVC_UVG),
        "DiffVC": _to_curves(DIFFVC_UVG),
    }
    ours = _to_curves(OURS_UVG[gop])
    return anchors, ours


def uvg_inter_rd_curves():
    """Inter-frame-only GOP-4 UVG comparison (`inter_plots.py` figure,
    HEVC + Ours from the committed results_gop4_inter.npy artifact)."""
    return ({"HEVC": _to_curves(HEVC_UVG_GOP4_INTER)},
            _to_curves(OURS_UVG_GOP4_INTER))


def classb_rd_curves():
    """Class-B anchor curves (`class_b_plots.py:186-194` dataset list minus
    the H.264/HEVC results_fast.json sweeps, which the reference reads from
    uncommitted files).  "Ours" Class-B quality metrics are likewise not
    committed upstream (see OURS_CLASSB_BPP_GOP8), so only anchors return."""
    return {
        "DVC": _to_curves(DVC_CLASSB),
        "RLVC": _to_curves(RLVC_CLASSB),
        "PLVC": _to_curves(PLVC_CLASSB),
        "DiffVC": _to_curves(DIFFVC_CLASSB),
    }
