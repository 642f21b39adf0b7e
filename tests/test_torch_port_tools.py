"""The port's checkpoint export, approximation-drift, weights-day and figure
tools against the JAX package's scripts, on the CPU.

  * `cli.export_checkpoint`: a port checkpoint of the same weights as a
    JAX one exports to the same tensor names with bit-identical tensors
    as `scripts/export_checkpoint.py` writes (its `export_state_dict` of
    the restored tree; the script itself, from orbax checkpoints, in a
    `slow` test), for the ControlNet and, with `--distilled`, for the
    student's EMA pair; the port's export read by JAX's
    `load_torch_state_dict` + `convert_state_dict` gives a JAX ControlNet
    whose output matches the port's;
  * `cli.approx_drift`: each mode's final latents against JAX's pipeline
    with the same (ControlNet, UNet-encoder) intervals on the same weights
    and draws, and `--small --device cpu` end to end;
  * `cli.weights_day`: `aggregate_rd_points`, `bd_tables` and `render_md`
    (byte for byte) equal to JAX's on the same inputs, and the playbook
    end to end from synthesized checkpoints with `--tiny --device cpu`;
  * `cli.make_figures`: the BD tables' text equal to JAX's.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from safetensors.numpy import load_file

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models import hf_import
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.sampling.pipeline import DualFlowPipeline as JPipeline
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule
from diffcodec_tpu.train import checkpoint as jckpt
from diffcodec_tpu.train import distill as jdistill
from diffcodec_tpu.train import trainer as jtrainer
from diffcodec_tpu.utils.flo_io import write_flo

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights as bridge
from diffcodec_tpu_torch.cli import (approx_drift, export_checkpoint,
                                     make_figures, weights_day)
from diffcodec_tpu_torch.cli.run_codec import model_configs
from diffcodec_tpu_torch.models import weights
from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.train import checkpoint as tckpt
from diffcodec_tpu_torch.train import distill as tdistill
from diffcodec_tpu_torch.train.trainer import Optimizer, TrainState
from torch_threads import few_torch_threads

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)
import export_checkpoint as jexport  # noqa: E402  (scripts/)
import make_figures as jfigures  # noqa: E402
import weights_day as jweights_day  # noqa: E402

H, L = 64, 5


_one_torch_thread = few_torch_threads(1)


def _randomize(params, seed, std=None):
    """Seeded float32 values for a tree of shapes: norm scales near 1,
    small biases, kernels ~ N(0, 1/fan_in); or every leaf ~ N(0, std^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if std is not None:
            v = rng.standard_normal(p.shape) * std
        elif name == "scale":
            v = rng.uniform(0.7, 1.3, p.shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, p.shape)
        else:
            fan_in = int(np.prod(p.shape[:-1])) if len(p.shape) > 1 else 1
            v = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _shapes(res=H):
    h = res // 8
    key = jax.random.PRNGKey(0)
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, L, 32))
    return {"unet": jax.eval_shape(JUNet(jcfg.UNetConfig.tiny()).init, key,
                                   sample, t0, ctx),
            "controlnet": jax.eval_shape(
                JControlNet(jcfg.ControlNetConfig.tiny()).init, key, sample,
                t0, ctx, jnp.zeros((1, res, res, 6)),
                jnp.zeros((1, res, res, 4)))}


def _port_controlnet(params):
    net = DualFlowControlNet(tcfg.ControlNetConfig.tiny())
    bridge.load_flax_params(net, params,
                            bridge.controlnet_name_map(net.cfg))
    return net


# --- export ------------------------------------------------------------


def _jax_export(tree, name_map):
    """What `scripts/export_checkpoint.py` writes for a restored tree
    (its `as_sd`, :70-72)."""
    return {k: np.ascontiguousarray(v)
            for k, v in hf_import.export_state_dict(tree, name_map).items()}


def _same_tensors(got_path, want):
    got = load_file(got_path)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def _port_train_checkpoint(params, run):
    """A port `checkpoint-5` whose masters are the JAX tree `params`."""
    net = _port_controlnet(params)
    state = TrainState.create(dict(net.named_parameters()),
                              Optimizer(tcfg.TrainConfig()))
    tckpt.save_checkpoint(run, 5, state.state_dict())
    return net


def _port_distill_checkpoint(params, ema, run):
    """A port distillation `checkpoint-2` with the JAX trees `params` as
    masters and `ema` as the EMA ({'unet', 'controlnet'} each)."""
    def port_params(tree):
        unet = UNet2DConditionModel(tcfg.UNetConfig.tiny())
        bridge.load_flax_params(unet, tree["unet"],
                                bridge.unet_name_map(unet.cfg))
        return dict(tdistill.denoiser(unet, _port_controlnet(
            tree["controlnet"])).named_parameters())

    state = tdistill.DistillState.create(port_params(params),
                                         Optimizer(tcfg.TrainConfig()))
    with torch.no_grad():
        for n, t in port_params(ema).items():
            state.ema_params[n].copy_(t)
    state.step = 2
    tdistill.save_distill_checkpoint(run, state)
    return state


def _trees():
    """Masters and a different EMA, {'unet', 'controlnet'} each."""
    shapes = _shapes()
    return ({k: _randomize(v, i) for i, (k, v) in enumerate(shapes.items())},
            {k: _randomize(v, 10 + i)
             for i, (k, v) in enumerate(shapes.items())})


def test_export_matches_jax_and_reloads_in_jax(tmp_path):
    params = _trees()[0]["controlnet"]
    cfg = jcfg.ControlNetConfig.tiny()
    net = _port_train_checkpoint(params, str(tmp_path / "run"))
    path = str(tmp_path / "port.safetensors")
    export_checkpoint.main(["--checkpoint_dir", str(tmp_path / "run"),
                            "--out", path, "--tiny"])
    sd = _same_tensors(path, _jax_export(
        params, hf_import.controlnet_name_map(cfg)))

    # the port's file read by JAX's converter into a JAX ControlNet: its
    # residuals against the port's ControlNet (fp32, sums in another order)
    back, missing, unused = hf_import.convert_state_dict(
        hf_import.load_torch_state_dict(path),
        hf_import.controlnet_name_map(cfg), params)
    assert not missing and not unused and len(sd) == len(
        dict(net.named_parameters()))
    rng = np.random.default_rng(2)
    x = [rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
         np.asarray([10, 900]),
         (rng.standard_normal((2, L, 32)) * 0.5).astype(np.float32),
         rng.uniform(0, 1, (2, H, H, 6)).astype(np.float32),
         (rng.standard_normal((2, H, H, 4)) * 2).astype(np.float32)]
    jdown, jmid = jax.jit(JControlNet(cfg).apply)(back,
                                                  *map(jnp.asarray, x))
    with torch.no_grad():
        down, mid = net(*map(torch.from_numpy, x))
    for got, want in zip(list(down) + [mid], list(jdown) + [jmid]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
    assert max(float(np.abs(np.asarray(w)).max()) for w in jdown) > 1e-2

    # a step no checkpoint has
    with pytest.raises(SystemExit, match="no checkpoint"):
        export_checkpoint.main(["--checkpoint_dir", str(tmp_path / "run"),
                                "--out", path, "--tiny", "--step", "4"])


def test_export_distilled_matches_jax(tmp_path):
    """The EMA pair of a distillation state whose EMA differs from its
    masters (so an export of the masters shows)."""
    params, ema = _trees()
    state = _port_distill_checkpoint(params, ema, str(tmp_path / "run"))
    out = str(tmp_path / "port_out")
    export_checkpoint.main(["--distilled", "--tiny", "--checkpoint_dir",
                            str(tmp_path / "run"), "--out", out])
    assert sorted(os.listdir(out)) == ["controlnet.safetensors",
                                       "unet.safetensors"]
    maps = {"controlnet": hf_import.controlnet_name_map(
                jcfg.ControlNetConfig.tiny()),
            "unet": hf_import.unet_name_map(jcfg.UNetConfig.tiny())}
    for name, name_map in maps.items():
        sd = _same_tensors(os.path.join(out, f"{name}.safetensors"),
                   _jax_export(ema[name], name_map))
        for n, t in sd.items():
            np.testing.assert_array_equal(
                t, state.ema_params[f"{name}.{n}"].numpy())
            assert not np.array_equal(
                t, state.params[f"{name}.{n}"].numpy()), n


@pytest.mark.slow
def test_exports_match_jax_scripts(tmp_path):
    """The same checkpoints through JAX's own script (orbax checkpoints
    of the same trees; its flax inits take ~30 s): the files' names and
    tensors equal the port's, for the ControlNet and `--distilled`."""
    params, ema = _trees()
    jstate = jtrainer.TrainState.create(
        params["controlnet"], jtrainer.make_optimizer(jcfg.TrainConfig()))
    jckpt.save_checkpoint(str(tmp_path / "jax_cn"), 5, jstate)
    jdstate = jdistill.DistillState.create(
        params, jtrainer.make_optimizer(jcfg.TrainConfig()))
    jckpt.save_checkpoint(str(tmp_path / "jax_st"), 2,
                          jdstate.replace(ema_params=ema))
    _port_train_checkpoint(params["controlnet"], str(tmp_path / "cn"))
    _port_distill_checkpoint(params, ema, str(tmp_path / "st"))
    for pkg, main in (("jax_", jexport.main), ("", export_checkpoint.main)):
        main(["--checkpoint_dir", str(tmp_path / (pkg + "cn")), "--out",
              str(tmp_path / (pkg + "cn.safetensors")), "--tiny"])
        main(["--distilled", "--tiny", "--checkpoint_dir",
              str(tmp_path / (pkg + "st")), "--out",
              str(tmp_path / (pkg + "st_out"))])
    for a, b in (("cn.safetensors", "jax_cn.safetensors"),
                 ("st_out/controlnet.safetensors",
                  "jax_st_out/controlnet.safetensors"),
                 ("st_out/unet.safetensors", "jax_st_out/unet.safetensors")):
        _same_tensors(str(tmp_path / a), load_file(str(tmp_path / b)))


# --- approx_drift ------------------------------------------------------


def test_approx_drift_modes_match_jax():
    """Every mode's final latents (the denoise loop with its ControlNet and
    UNet-encoder intervals, CFG 3.5, ControlNet scale 1.35, FreeU) from
    `approx_drift.run_mode` against JAX's `DualFlowPipeline.denoise` with
    the same intervals, on the same tiny weights (every leaf ~ N(0, 0.02^2),
    the script's draw) and inputs, fp32, 5 steps at 64 px; the call counts
    from the intervals."""
    params = {k: _randomize(v, i, std=approx_drift.WEIGHT_STD)
              for i, (k, v) in enumerate(_shapes().items())}
    pipe = approx_drift.build(True, "cpu", torch.float32)
    bridge.load_flax_params(pipe.unet, params["unet"],
                            bridge.unet_name_map(pipe.unet.cfg))
    bridge.load_flax_params(pipe.controlnet, params["controlnet"],
                            bridge.controlnet_name_map(pipe.controlnet.cfg))
    inputs = approx_drift.make_inputs(pipe, 1, H)
    jx = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    steps = 5
    finals = {}
    for name, ci, ei in approx_drift.MODES:
        final, images, calls = approx_drift.run_mode(pipe, inputs, steps, ci,
                                                     ei)
        assert calls == {"controlnet": math.ceil(steps / ci),
                         "unet_encoder": math.ceil(steps / ei)}
        assert images.shape == (1, H, H, 3) and images.abs().max() <= 1
        jpipe = JPipeline(
            unet=JUNet(jcfg.UNetConfig.tiny()),
            controlnet=JControlNet(jcfg.ControlNetConfig.tiny()), vae=None,
            schedule=JSchedule.create(jcfg.SchedulerConfig()),
            sampler=jcfg.SamplerConfig(
                num_inference_steps=steps, guidance_scale=3.5,
                controlnet_conditioning_scale=1.35, controlnet_interval=ci,
                unet_encoder_interval=ei, freeu=True))
        want = np.asarray(jax.jit(jpipe.denoise)(
            params, jx["latents"], jx["text"], jx["uncond"], jx["cond"],
            jx["flow"]))
        # fp32 on both sides through 5 UniPC steps (the limits of
        # tests/test_torch_port_pipeline.py's decode, here on latents)
        np.testing.assert_allclose(final.numpy(), want, atol=1e-3,
                                   rtol=1e-3, err_msg=name)
        finals[name] = final
    # the cached modes do drift from exact (the weights are not zero-convs)
    assert all(not torch.equal(finals[n], finals["exact"])
               for n in finals if n != "exact")


def test_approx_drift_cli_small(tmp_path):
    out = str(tmp_path / "drift" / "approx_drift.json")
    record, runs = approx_drift.main(["--small", "--batch", "1",
                                      "--device", "cpu", "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(record))
    # the JAX script's record, read only for its keys
    with open(os.path.join(os.path.dirname(SCRIPTS), "artifacts",
                           "approx_drift.json")) as f:
        jrecord = json.load(f)
    assert record.keys() == jrecord.keys()
    assert record["operating_point"].keys() == \
        jrecord["operating_point"].keys()
    assert record["metric_defs"] == jrecord["metric_defs"]
    assert record["modes"].keys() == jrecord["modes"].keys()
    for name, rec in record["modes"].items():
        assert rec.keys() == jrecord["modes"][name].keys(), name
        if name != "exact":
            assert 0 < rec["latent_rel_rms"] < 0.1
    assert record["modes"]["exact"] == {"latent_mse": 0.0,
                                        "pixel_psnr_db": None,
                                        "note": "reference output"}
    assert record["operating_point"]["resolution"] == 128
    assert record["operating_point"]["steps"] == 5
    for name, ci, ei in approx_drift.MODES:
        assert runs[name]["calls"] == {"controlnet": math.ceil(5 / ci),
                                       "unet_encoder": math.ceil(5 / ei)}
        assert runs[name]["seconds"] > 0


# --- weights_day -------------------------------------------------------


def _rd_inputs():
    """bpp_results / metric_results as rd_sweep writes them: three GOPs,
    two videos, three modes, a None and a NaN among the metrics, one mode
    missing for one video."""
    rng = np.random.default_rng(3)
    bpp, metrics = {}, {}
    for g in ("2", "4", "8"):
        bpp[g], metrics[g] = {}, {}
        for v in ("beauty", "jockey"):
            bpp[g][v], metrics[g][v] = {}, {}
            for i, mode in enumerate(("none", "sparse", "dense")):
                if v == "jockey" and mode == "sparse" and g == "4":
                    continue
                bpp[g][v][mode] = float(0.01 + 0.02 * i + rng.uniform(
                    0, 0.005))
                m = {"psnr": float(26 + 2 * i + rng.uniform(0, 1)),
                     "ms_ssim": float(0.9 + 0.02 * i),
                     "lpips": float(0.2 - 0.03 * i),
                     "fid": float(60 - 10 * i), "fvd": None}
                if v == "beauty" and mode == "dense":
                    m["lpips"] = float("nan")
                metrics[g][v][mode] = {"all": m, "inter": m}
    return bpp, metrics


def _same_report(a, b):
    """Equality of nested reports, NaN equal to NaN, tuples as lists."""
    a, b = json.loads(json.dumps(a)), json.loads(json.dumps(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_report(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_report(x, y)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b


def test_weights_day_tables_match_jax():
    bpp, metrics = _rd_inputs()
    modes = ["none", "sparse", "dense"]
    points = weights_day.aggregate_rd_points(bpp, metrics, modes)
    jpoints = jweights_day.aggregate_rd_points(bpp, metrics, modes)
    _same_report(points, jpoints)
    table, rows = weights_day.bd_tables(points, modes)
    jtable, jrows = jweights_day.bd_tables(jpoints, modes)
    _same_report(table, jtable)
    _same_report(rows, jrows)
    assert set(table) == {"2", "4", "8"} and "HEVC" in table["8"]["psnr"]
    report = {"args": {"sd": "/sd", "aux": "", "dataset": "/uvg",
                       "distilled": "/run"},
              "rd_points": points, "bd_tables": table,
              "reference_comparison": rows,
              "distill": {"per_k": {"K1": {"psnr_vs_teacher_db": 21.5},
                                    "K4": {"psnr_vs_teacher_db": 30.25}}},
              "drift": {"exact": {"latent_mse": 0.0},
                        "cnint2": {"latent_rel_err": 1.5e-4,
                                   "pixel_psnr_db": 88.1},
                        "modes": {"cnint2": {"latent_rel_rms": 1e-4}}}}
    md = weights_day.render_md(report)
    assert md == jweights_day.render_md(report)
    assert "## Caching-knob drift" in md and "| cnint2 | 1.50e-04" in md
    empty = dict(report, bd_tables={}, reference_comparison={},
                 distill=None, drift=None)
    assert weights_day.render_md(empty) == jweights_day.render_md(empty)


def _tiny_sd_root(root):
    unet_cfg, cn_cfg, vae_cfg, clip_cfg = model_configs(True)
    torch.manual_seed(11)
    modules = {"unet": UNet2DConditionModel(unet_cfg),
               "controlnet": DualFlowControlNet(cn_cfg),
               "vae": AutoencoderKL(vae_cfg),
               "text": CLIPTextEncoder(clip_cfg)}
    weights.synthesize_sd_checkpoint_dir(root, modules)
    return modules


def test_weights_day_playbook(tmp_path):
    """Stages 1-4 from synthesized checkpoints: a tiny diffusers root, a
    distillation checkpoint whose EMA is that root's UNet and ControlNet,
    one 64 px video with forward and backward .flo flows; no auxiliary
    root, so PSNR and MS-SSIM only."""
    modules = _tiny_sd_root(str(tmp_path / "sd"))
    state = tdistill.DistillState.create(
        dict(tdistill.denoiser(modules["unet"], modules["controlnet"])
             .named_parameters()), Optimizer(tcfg.TrainConfig()))
    state.step = 2
    tdistill.save_distill_checkpoint(str(tmp_path / "distill"), state)
    vdir = tmp_path / "dataset" / "vid0"
    for d in ("frames", "Flow", "Flow_b"):
        (vdir / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.random((H, H, 3)) * 255).astype(np.uint8)
                        ).save(vdir / "frames" / f"frame_{i:04d}.png")
        flow = rng.normal(0, 1.5, (H, H, 2)).astype(np.float32)
        write_flo(str(vdir / "Flow" / f"flow_{i:04d}.flo"), flow)
        write_flo(str(vdir / "Flow_b" / f"flow_{i:04d}.flo"), -flow)
    out = str(tmp_path / "wd")
    report = weights_day.main(
        ["--sd_checkpoint_dir", str(tmp_path / "sd"), "--dataset_root",
         str(tmp_path / "dataset"), "--out", out, "--gops", "2",
         "--modes", "none", "dense", "--steps", "2", "--tiny", "--device",
         "cpu", "--distilled_checkpoint", str(tmp_path / "distill"),
         "--student_steps", "2", "--with_drift"])
    with open(os.path.join(out, "weights_day_report.json")) as f:
        assert json.load(f).keys() == report.keys()
    with open(os.path.join(out, "weights_day_report.md")) as f:
        md = f.read()
    assert md == weights_day.render_md(json.loads(json.dumps(
        report, default=float)))
    assert "Measured RD points" in md and "Distilled student" in md
    pts = report["rd_points"]["2"]
    assert set(pts) == {"none", "dense"}
    for bpp, mets in pts.values():
        assert bpp > 0 and np.isfinite(mets["psnr"])
    assert pts["dense"][0] > pts["none"][0]  # the dense flow's bits
    assert "2" in report["bd_tables"] and {"H.264"} <= set(
        report["bd_tables"]["2"]["psnr"])
    assert report["distill"]["student_checkpoint_step"] == 2
    assert sorted(report["distill"]["per_k"]) == ["K1", "K2"]
    assert report["drift"]["operating_point"]["resolution"] == 128
    assert os.path.exists(os.path.join(out, "approx_drift.json"))
    assert os.path.exists(os.path.join(out, "rd", "rd_psnr.pdf"))


# --- make_figures ------------------------------------------------------


def test_make_figures_bd_tables_match_jax(tmp_path, monkeypatch):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", ["make_figures.py", jdir])
    jfigures.main()
    make_figures.main([tdir])
    with open(os.path.join(jdir, "bd_tables.md")) as f:
        want = f.read().split("\n", 1)
    with open(os.path.join(tdir, "bd_tables.md")) as f:
        got = f.read().split("\n", 1)
    # the tables byte for byte; the heading names the module it read
    assert got[1] == want[1]
    assert got[0] == want[0].replace("diffcodec_tpu.", "diffcodec_tpu_torch.")
    assert got[1] == make_figures.bd_tables_md().split("\n", 1)[1]
    assert sorted(os.listdir(os.path.join(tdir, "figures"))) == sorted(
        os.listdir(os.path.join(jdir, "figures")))
    assert make_figures.DEFAULT_OUT.startswith("build")
