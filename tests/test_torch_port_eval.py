"""The port's evaluation layer against the JAX package's, on the CPU.

Same numpy inputs from seeds on both sides:
  * PSNR, SSIM and MS-SSIM at 192 x 256 (MS-SSIM's five scales need 161
    px a side), uint8 and float frames, and `calculate_metrics_batch` with
    an identical pair (PSNR inf, left out of the mean); fp32 sums in
    another order: rtol 1e-5 on PSNR (tens of dB), atol 2e-5 / rtol 1e-4
    on the SSIMs;
  * LPIPS, the FID-64 features and the I3D features at full width, each
    network loaded through the JAX bridge maps from one set of seeded
    variables; fp32 through a handful of convs (I3D: 60): atol 2e-5 of the
    output's largest magnitude, rtol 1e-4;
  * the copied numpy modules, exactly: the Fréchet distances (FID, FVD and
    the clip-length sweep), the torchscript I3D loader (a scripted
    stand-in; a named file that is missing raises), every BD-rate variant over `anchors_data`'s
    curves, the BD-rate table, the .flo reader and writer, the anchors'
    log parsers;
  * the feature functions refuse a module that is not fp32 on their
    device rather than move it;
  * `freq_analysis.frequency_errors` (its blur a depthwise conv);
  * `codec_eval.evaluate_video` on PNG directories with a gap in the
    prediction, and the prediction-root and classical-codec walks, against
    JAX's result dicts; the plots write their files.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffcodec_tpu.codec import anchors as janchors
from diffcodec_tpu.eval import anchors_data as jdata
from diffcodec_tpu.eval import bd_rate as jbd
from diffcodec_tpu.eval import codec_eval as jce
from diffcodec_tpu.eval import frechet as jfr
from diffcodec_tpu.eval import freq_analysis as jfreq
from diffcodec_tpu.eval import inception as jinc
from diffcodec_tpu.eval import metrics as jm
from diffcodec_tpu.eval import plots as jplots
from diffcodec_tpu.eval import visual_study as jvisual
from diffcodec_tpu.models import i3d as ji3d
from diffcodec_tpu.train import lpips as jlpips
from diffcodec_tpu.utils import flo_io as jflo

from diffcodec_tpu_torch import weights as bridge
from diffcodec_tpu_torch.codec import anchors
from diffcodec_tpu_torch.eval import (anchors_data, bd_rate, codec_eval,
                                      frechet, freq_analysis, inception,
                                      metrics, plots, visual_study)
from diffcodec_tpu_torch.models import i3d
from diffcodec_tpu_torch.train import lpips
from diffcodec_tpu_torch.utils import flo_io
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

SSIM_TOL = dict(atol=2e-5, rtol=1e-4)
PSNR_RTOL = 1e-5
NET_RTOL, NET_ATOL_REL = 1e-4, 2e-5
H, W = 192, 256


def _frames(seed, n=3, dtype="uint8"):
    """A smooth random field plus noise: SSIMs well inside (0, 1)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (n, H // 16, W // 16, 3))
    x = np.repeat(np.repeat(base, 16, 1), 16, 2)
    x = np.clip(x + rng.normal(0, 12, x.shape), 0, 255)
    return x.astype(np.uint8) if dtype == "uint8" else x.astype(np.float32)


def _pair(dtype):
    a = _frames(0, dtype=dtype)
    rng = np.random.default_rng(1)
    b = np.clip(a.astype(np.float32) + rng.normal(0, 30, a.shape), 0, 255)
    return a, b.astype(a.dtype)


@pytest.mark.parametrize("dtype", ["uint8", "float"])
@pytest.mark.parametrize("fn", ["psnr", "ssim", "ms_ssim"])
def test_image_metrics_match_jax(fn, dtype):
    a, b = _pair(dtype)
    want = np.asarray(getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(metrics, fn)(torch.from_numpy(a),
                               torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (3,)
    if fn == "psnr":
        np.testing.assert_allclose(got, want, rtol=PSNR_RTOL)
    else:
        assert 0.1 < want.min() and want.max() < 0.99
        np.testing.assert_allclose(got, want, **SSIM_TOL)


@pytest.mark.parametrize("size", [(64, 64), (160, 200), (161, 161)])
def test_ms_ssim_below_its_scales_is_jaxs(size):
    """Below 161 px a scale of the 11-tap blur is empty: NaN, as JAX's
    valid-mode filter gives (the codec's metrics on small frames then
    report MS-SSIM NaN, not an error); from 161 px both compute it."""
    a, b = (f[:, :size[0], :size[1]] for f in _pair("uint8"))
    want = np.asarray(jm.ms_ssim(jnp.asarray(a, jnp.float32),
                                 jnp.asarray(b, jnp.float32)))
    got = metrics.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (3,)
    if min(size) < 161:
        assert np.isnan(want).all() and np.isnan(got).all()
        summary = metrics.calculate_metrics_batch(a, b, device="cpu")
        assert np.isnan(summary["ms_ssim"]) and np.isnan(
            jm.calculate_metrics_batch(a, b)["ms_ssim"])
    else:
        np.testing.assert_allclose(got, want, **SSIM_TOL)


def test_psnr_of_identical_frames_is_inf():
    a = torch.from_numpy(_frames(2))
    assert torch.isinf(metrics.psnr(a, a)).all()


def test_calculate_metrics_batch_skips_identical_pairs():
    a, b = _pair("uint8")
    b[1] = a[1]  # PSNR inf: left out of the mean
    want = jm.calculate_metrics_batch(a, b)
    got = metrics.calculate_metrics_batch(a, b, device="cpu")
    assert set(got) == set(want) == {"psnr", "ms_ssim"}
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=PSNR_RTOL)
    np.testing.assert_allclose(got["ms_ssim"], want["ms_ssim"], **SSIM_TOL)
    only = metrics.calculate_metrics_batch(a[[0, 2]], b[[0, 2]],
                                           device="cpu")
    np.testing.assert_allclose(got["psnr"], only["psnr"], rtol=PSNR_RTOL)


# ---------------------------------------------------------------------------
# metric networks through the JAX bridge
# ---------------------------------------------------------------------------

def _randomize(shapes, seed):
    """Seeded fp32 variables: kernels ~ N(0, 1.3 / fan_in), scales and
    variances in [0.5, 1.5], small biases and means."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.standard_normal(p.shape) * np.sqrt(
                1.3 / int(np.prod(p.shape[:-1])))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, p.shape)
        else:
            v = rng.uniform(-0.1, 0.1, p.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want):
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=NET_RTOL,
                               atol=NET_ATOL_REL * np.abs(want).max())


def test_lpips_matches_jax():
    z = jnp.zeros((1, 64, 64, 3))
    params = _randomize(jax.eval_shape(jlpips.LPIPS().init,
                                       jax.random.PRNGKey(0), z, z), 1)
    model = lpips.LPIPS().eval()
    bridge.load_flax_params(model, params, bridge.lpips_alex_name_map())
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax.jit(jlpips.LPIPS().apply)(params, a, b))
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        same = model(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    _close(got, want)
    np.testing.assert_array_equal(same, 0.0)


def test_fid64_features_match_jax():
    variables = _randomize(jax.eval_shape(
        jinc.InceptionFID64().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 299, 299, 3))), 3)
    model = inception.InceptionFID64()
    bridge.load_flax_variables(model, variables,
                               bridge.inception64_name_map(),
                               bridge.inception64_batch_stats_map())
    images = np.random.default_rng(4).integers(0, 256, (3, 100, 120, 3),
                                               dtype=np.uint8)
    want = jinc.make_fid64_feature_fn(variables, batch_size=2)(images)
    got = inception.make_fid64_feature_fn(model, batch_size=2,
                                          device="cpu")(images)
    assert got.shape == (3, 64)
    _close(got, want)


def test_i3d_features_match_jax():
    """Full width, one [1, 16, 64, 64, 3] clip: the stride-2 stem and
    pools pad as flax's SAME does."""
    variables = _randomize(jax.eval_shape(
        ji3d.InceptionI3D().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, 64, 64, 3))), 5)
    model = i3d.InceptionI3D()
    bridge.load_flax_variables(model, variables, bridge.i3d_name_map(),
                               bridge.i3d_batch_stats_map())
    videos = np.random.default_rng(6).uniform(
        0, 1, (1, 16, 64, 64, 3)).astype(np.float32)
    want = jfr.make_i3d_feature_fn(variables)(videos)
    got = frechet.make_i3d_feature_fn(model, device="cpu")(videos)
    assert got.shape == (1, 400)
    _close(got, want)


@pytest.mark.parametrize("n,k,stride,want", [
    (16, 7, 2, (2, 3)), (64, 7, 2, (2, 3)), (32, 3, 2, (0, 1)),
    (5, 3, 1, (1, 1)), (8, 2, 2, (0, 0)), (7, 3, 2, (1, 1))])
def test_same_pads_are_flaxs(n, k, stride, want):
    assert i3d.same_pads([n], [k], [stride]) == want
    pads = jax.lax.padtype_to_pads((n,), (k,), (stride,), "SAME")
    assert tuple(pads[0]) == want


# ---------------------------------------------------------------------------
# the copied numpy modules
# ---------------------------------------------------------------------------

def _features(seed, n=40, d=6):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) @ rng.standard_normal((d, d))


def test_frechet_distances_match_jax():
    a, b = _features(0), _features(1) + 0.5
    assert frechet.activations_to_frechet(a, b) == \
        jfr.activations_to_frechet(a, b)
    images = np.random.default_rng(2).integers(0, 256, (2, 40, 4, 4, 3))
    fn = lambda x: np.asarray(x, np.float64).reshape(len(x), -1)[:, :6]
    assert frechet.fid_score(images[0], images[1], fn) == \
        jfr.fid_score(images[0], images[1], fn)
    videos = np.random.default_rng(3).uniform(0, 1, (2, 6, 20, 2, 2, 3))
    vfn = lambda v: v.reshape(len(v), v.shape[1], -1).mean(1)
    assert frechet.fvd_score(videos[0], videos[1], vfn) == \
        jfr.fvd_score(videos[0], videos[1], vfn)
    got = frechet.fvd_sweep(videos[0], videos[1], vfn)
    assert got == jfr.fvd_sweep(videos[0], videos[1], vfn)
    assert set(got["fvd"]) == {"[:10]", "[:15]", "[:20]", "final"}



class _ScriptedFeatures(torch.nn.Module):
    """Stands in for the reference's `i3d_torchscript.pt`: its call
    signature, a fixed projection of the clip's mean colour per frame."""

    def forward(self, x: torch.Tensor, rescale: bool = True,
                resize: bool = True, return_features: bool = False):
        return x.mean(dim=(3, 4)).flatten(1) * 2.0 + 0.25


def test_load_i3d_torchscript_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "i3d_torchscript.pt")
    torch.jit.script(_ScriptedFeatures()).save(path)
    videos = np.random.default_rng(7).uniform(0, 1, (2, 5, 8, 8, 3))
    got = frechet.load_i3d_torchscript(path, device="cpu")(videos)
    np.testing.assert_array_equal(got,
                                  jfr.load_i3d_torchscript(path)(videos))
    monkeypatch.setenv("DIFFCODEC_I3D_PATH", path)
    np.testing.assert_array_equal(
        frechet.load_i3d_torchscript(device="cpu")(videos), got)


def test_load_i3d_torchscript_refuses_a_missing_file(tmp_path, monkeypatch):
    """None only where no file was named; a named one that is missing
    raises, so the FVD is never dropped without a word."""
    monkeypatch.delenv("DIFFCODEC_I3D_PATH", raising=False)
    assert frechet.load_i3d_torchscript(device="cpu") is None
    missing = str(tmp_path / "absent.pt")
    with pytest.raises(FileNotFoundError):
        frechet.load_i3d_torchscript(missing, device="cpu")
    monkeypatch.setenv("DIFFCODEC_I3D_PATH", missing)
    with pytest.raises(FileNotFoundError):
        frechet.load_i3d_torchscript(device="cpu")


@pytest.mark.parametrize("make", ["lpips", "fid64", "i3d"])
def test_feature_fns_leave_the_callers_module_as_it_is(make):
    """A module in another dtype or on another device is refused, not
    moved or recast."""
    model, build = {
        "lpips": (lpips.LPIPS, lpips.make_lpips_fn),
        "fid64": (inception.InceptionFID64,
                  inception.make_fid64_feature_fn),
        "i3d": (i3d.InceptionI3D, frechet.make_i3d_feature_fn)}[make]
    model = model()
    with pytest.raises(ValueError):
        build(model.double(), device="cpu")
    assert next(model.parameters()).dtype == torch.float64
    with pytest.raises(ValueError):
        build(model.float(), device="cuda")
    assert next(model.parameters()).device.type == "cpu"
    build(model, device="cpu")


def _curves():
    return [jdata.uvg_rd_curves(8), jdata.uvg_rd_curves(4),
            jdata.uvg_inter_rd_curves(), (jdata.classb_rd_curves(), None)]


@pytest.mark.parametrize("fn", ["bd_rate", "bd_rate_safe",
                                "bd_rate_pchip_exact",
                                "bd_rate_extrapolated", "bd_quality"])
def test_bd_rates_match_jax_on_the_anchor_curves(fn):
    assert anchors_data.uvg_rd_curves(8) == jdata.uvg_rd_curves(8)
    assert anchors_data.classb_rd_curves() == jdata.classb_rd_curves()
    n = 0
    for anchor_set, ours in _curves():
        for codec, table in anchor_set.items():
            for metric, pts in table.items():
                other = (ours or anchor_set["DiffVC"]).get(metric)
                if not other or len(pts) < 2:
                    continue
                R1, Q1 = zip(*pts)
                R2, Q2 = zip(*other)
                higher = jplots.METRIC_DIRECTIONS.get(metric.lower(), True)
                want = getattr(jbd, fn)(R1, Q1, R2, Q2, higher)
                got = getattr(bd_rate, fn)(R1, Q1, R2, Q2, higher)
                np.testing.assert_array_equal(got, want)
                n += 1
    assert n >= 20


def test_bd_rate_table_and_extrapolation_match_jax():
    anchor_set, ours = jdata.uvg_rd_curves(8)
    want = jplots.bd_rate_table(anchor_set, ours)
    got = plots.bd_rate_table(anchor_set, ours)
    assert plots.format_bd_table(got) == jplots.format_bd_table(want)
    bpp, q = zip(*ours["psnr"])
    for a, b in zip(bd_rate.extrapolate_rd_curve(bpp, q),
                    jbd.extrapolate_rd_curve(bpp, q)):
        np.testing.assert_array_equal(a, b)


def test_flo_files_and_anchor_logs_read_as_jax(tmp_path):
    flow = np.random.default_rng(7).standard_normal((5, 7, 2)).astype(
        np.float32)
    flo_io.write_flo(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(jflo.read_flo(str(tmp_path / "a.flo")),
                                  flow)
    jflo.write_flo(str(tmp_path / "b.flo"), flow)
    np.testing.assert_array_equal(flo_io.read_flo(str(tmp_path / "b.flo")),
                                  flow)
    split = {"intra_bytes": 900, "inter_bytes": 300, "total_bytes": 1200}
    anchors.write_intra_inter_storage(str(tmp_path / "s.txt"), split)
    assert janchors.parse_intra_inter_storage(str(tmp_path / "s.txt")) == \
        anchors.parse_intra_inter_storage(str(tmp_path / "s.txt")) == split
    log = ("POC    0 TId: 0 ( CRA, I-SLICE, QP 37 )     91520 bits\n"
           "POC    1 TId: 3 ( B-SLICE, QP 41 )   2312 bits\n")
    assert anchors.parse_vvdec_poc_log(log) == \
        janchors.parse_vvdec_poc_log(log) == [(0, "I", 91520),
                                             (1, "B", 2312)]


def test_frequency_errors_match_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(0, 1, (2, 48, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    want = jfreq.frequency_errors(a, b)
    got = freq_analysis.frequency_errors(a, b, device="cpu")
    assert set(got) == set(want) == {"low_error", "high_error"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    one = freq_analysis.frequency_errors(a[0], b[0], device="cpu")
    np.testing.assert_allclose(one["low_error"],
                               jfreq.frequency_errors(a[0], b[0])
                               ["low_error"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the per-video codec evaluation
# ---------------------------------------------------------------------------

def _write_pngs(d, frames, skip=()):
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames):
        if i not in skip:
            Image.fromarray(f).save(os.path.join(d, f"frame_{i:04d}.png"))


def _assert_results_close(got, want):
    assert got.keys() == want.keys()
    for part in want:
        assert got[part].keys() == want[part].keys(), part
        for k, v in want[part].items():
            if k == "skipped_frames":
                assert got[part][k] == v
            elif k == "psnr":
                np.testing.assert_allclose(got[part][k], v, rtol=PSNR_RTOL)
            else:
                np.testing.assert_allclose(got[part][k], v, **SSIM_TOL)


def test_evaluate_video_matches_jax(tmp_path):
    """Seven frames, GOP 4, frame 2 missing from the prediction: the GOP
    phase follows the original listing (inter frames 1, 3, 5, 6 survive,
    frame 3 is not shifted onto an anchor)."""
    orig = _frames(9, n=7)
    rng = np.random.default_rng(10)
    pred = np.clip(orig + rng.normal(0, 6, orig.shape), 0,
                   255).astype(np.uint8)
    pred[4] = orig[4]  # an anchor decoded exactly: PSNR inf, skipped
    _write_pngs(tmp_path / "orig", orig)
    _write_pngs(tmp_path / "pred", pred, skip={2})
    want = jce.evaluate_video(str(tmp_path / "orig"), str(tmp_path / "pred"),
                              4)
    got = codec_eval.evaluate_video(str(tmp_path / "orig"),
                                    str(tmp_path / "pred"), 4, device="cpu")
    assert got["all"]["skipped_frames"] == 1
    _assert_results_close(got, want)


def test_prediction_root_and_classical_codec_match_jax(tmp_path):
    """`uvc_codec_eval.py`'s walk over {root}/{bpp_case}/{video} (its JSON
    written) and `classical_codec_eval.py`'s over {root}/{video} with the
    bytes of `intra_inter_storage.txt`, against JAX's."""
    orig = _frames(11, n=4)
    rng = np.random.default_rng(12)
    pred = np.clip(orig + rng.normal(0, 7, orig.shape), 0,
                   255).astype(np.uint8)
    _write_pngs(tmp_path / "orig" / "beauty", orig)
    _write_pngs(tmp_path / "pred" / "0.01" / "beauty", pred)
    _write_pngs(tmp_path / "classical" / "beauty", pred)
    anchors.write_intra_inter_storage(
        str(tmp_path / "classical" / "beauty" / "intra_inter_storage.txt"),
        {"intra_bytes": 9000, "inter_bytes": 1000, "total_bytes": 10000})
    want = jce.evaluate_prediction_root(str(tmp_path / "pred"),
                                        str(tmp_path / "orig"), 2)
    got = codec_eval.evaluate_prediction_root(
        str(tmp_path / "pred"), str(tmp_path / "orig"), 2,
        out_json=str(tmp_path / "inter_results.json"), device="cpu")
    assert got.keys() == want.keys() == {"0.01"}
    _assert_results_close(got["0.01"]["beauty"], want["0.01"]["beauty"])
    with open(tmp_path / "inter_results.json") as f:
        assert json.load(f) == got
    kw = dict(width=W, height=H, num_frames=4)
    want = jce.evaluate_classical_codec(str(tmp_path / "classical"),
                                        str(tmp_path / "orig"), 2, **kw)
    got = codec_eval.evaluate_classical_codec(
        str(tmp_path / "classical"), str(tmp_path / "orig"), 2,
        device="cpu", **kw)
    entry, jentry = got["beauty"], want["beauty"]
    assert entry["total_bpp"] == jentry["total_bpp"] == 10000 * 8 / (
        4 * W * H)
    assert entry["inter_bpp"] == jentry["inter_bpp"]
    _assert_results_close({k: entry[k] for k in ("all", "inter")},
                          {k: jentry[k] for k in ("all", "inter")})


@pytest.mark.parametrize("plot", ["rd_curves", "comparison_figure",
                                  "frequency_errors"])
def test_plots_write_files(tmp_path, plot):
    """The plots run (matplotlib imported inside them) and write a file;
    the zoom crop is JAX's."""
    out = str(tmp_path / "fig.pdf")
    if plot == "rd_curves":
        anchor_set, ours = anchors_data.uvg_rd_curves(8)
        curves = {"Ours": ours["psnr"], "HEVC": anchor_set["HEVC"]["psnr"]}
        plots.plot_rd_curves(curves, "psnr", out)
    elif plot == "comparison_figure":
        gt = _frames(13, n=1)[0]
        crop = (10, 20, 24, 24)
        np.testing.assert_array_equal(visual_study.zoom_crop(gt, crop),
                                      jvisual.zoom_crop(gt, crop))
        visual_study.comparison_figure(
            gt, {"Ours": gt, "H264": (gt * 0.9).astype(np.uint8)}, crop,
            metrics={"Ours": {"psnr": 30.1}, "H264": {"psnr": 28.0}},
            metric_higher_better={"psnr": True}, out_path=out)
    else:
        freq_analysis.plot_frequency_errors(
            {"beauty": {"low_error": 0.01, "high_error": 0.02}}, out)
    assert os.path.getsize(out) > 1000
