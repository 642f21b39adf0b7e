"""The port's training data pipeline and its training and distillation CLIs,
on the CPU.

  * `UniDataset` (every sample, `validate`, `iter_batches`) and
    `PrefetchLoader` against the JAX package's, bit for bit, on synthetic
    frames, .flo and .npy-cached flows and captions written by the test,
    with the zero-fill fallbacks of a sample that lacks an anchor and a
    flow; `load_caption_dict` and `adaptive_avg_pool_flow` beside them;
  * `cli.train_distill --tiny --device cpu` from a tiny diffusers root for
    2 steps (rotated checkpoints, the student warm-started from the
    root's teacher), then resumed to step 3;
  * `run_codec decode --distilled_checkpoint --student_steps 2`: its PNGs
    bit-identical to `DistilledPipeline` over modules filled from the root
    and the checkpoint's EMA by hand, on the same seeded draws;
  * `rd_sweep` over one tiny video with the student, `distill_eval` at
    K = 1, 2 and `cli.train_residual` for one step at 32 px;
  * the metrics logger's lines and meters.
"""

import argparse
import json
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffcodec_tpu.train import dataset as jdataset
from diffcodec_tpu.train import prefetch as jprefetch
from diffcodec_tpu.utils.flo_io import write_flo

from diffcodec_tpu_torch.cli import (distill_eval, rd_sweep, run_codec,
                                     train_distill, train_residual)
from diffcodec_tpu_torch.cli.run_codec import model_configs
from diffcodec_tpu_torch.codec.runner import EncodedVideo, decode_video
from diffcodec_tpu_torch.config import DistillConfig, SamplerConfig
from diffcodec_tpu_torch.models import weights
from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d import UNet2DModel
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.train import checkpoint as tckpt
from diffcodec_tpu_torch.train import dataset as tdataset
from diffcodec_tpu_torch.train.distill import denoiser
from diffcodec_tpu_torch.train import prefetch as tprefetch
from diffcodec_tpu_torch.utils import logging as tlogging
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

RES = 32


def _write_dataset(root, n, res=48, seed=0):
    """n Vimeo-style samples under root/sequences/000NN/0001/: a target
    frame, the r1/r2 anchors, Flow/ and Flow_b/ .flo files; sample 1 keeps
    its forward flow as a torch-layout [2, H, W] .npy cache instead, the
    last lacks r2.png and its backward flow.  Returns (index file, caption
    file)."""
    rng = np.random.default_rng(seed)
    paths, lines = [], []
    for i in range(n):
        d = os.path.join(root, "sequences", f"{i + 1:05d}", "0001")
        os.makedirs(os.path.join(d, "Flow"))
        os.makedirs(os.path.join(d, "Flow_b"))
        names = ["im2", "r1"] + (["r2"] if i < n - 1 else [])
        for name in names:
            img = rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{name}.png"))
        fwd = (rng.standard_normal((res, res, 2)) * 3).astype(np.float32)
        if i == 1:
            np.save(os.path.join(d, "Flow", "im2.npy"), fwd.transpose(2, 0, 1))
        else:
            write_flo(os.path.join(d, "Flow", "im2.flo"), fwd)
        if i < n - 1:
            write_flo(os.path.join(d, "Flow_b", "im2.flo"),
                      (rng.standard_normal((res, res, 2)) * 3).astype(
                          np.float32))
        paths.append(os.path.join(d, "im2.png"))
        lines.append(f"sequences/{i + 1}/1/im2.png: caption number {i}")
    index = os.path.join(root, "index.txt")
    with open(index, "w") as f:
        f.write("\n".join(paths) + "\n")
    captions = os.path.join(root, "captions.txt")
    with open(captions, "w") as f:
        f.write("\n".join(lines + ["no colon here", ""]) + "\n")
    return index, captions


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "text":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("drop_txt_prob,transform", [(0.3, True),
                                                     (0.0, False)])
def test_dataset_matches_jax(tmp_path, drop_txt_prob, transform):
    index, captions = _write_dataset(str(tmp_path), 5)
    kw = dict(resolution=RES, drop_txt_prob=drop_txt_prob,
              transform=transform, seed=3)
    jds = jdataset.UniDataset(captions, index, **kw)
    tds = tdataset.UniDataset(captions, index, **kw)
    assert tds.annos == jds.annos and len(tds.annos) == 5
    assert len(tds) == len(jds) == 5
    for i in range(5):
        want = jds[i]
        _same_batch(tds[i], want)
        assert want["image"].shape == (RES, RES, 3)
        assert want["flow"].shape == (RES, RES, 4)
    # the last sample has no r2 and no backward flow: zero-filled
    assert not want["cond"][..., 3:].any() and not want["flow"][..., 2:].any()
    assert tds.validate() == jds.validate() == (5, [])

    def embed(texts):
        return np.asarray([[len(t), t.count("1")] for t in texts],
                          np.float32)

    want = list(jds.iter_batches(2, text_encoder=embed))
    got = list(tds.iter_batches(2, text_encoder=embed))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _same_batch(a, b)
        assert b["text_embeds"].shape == (2, 2)

    # several workers draw the jitter and the text dropout from the
    # dataset's one generator in the order the threads run, in both
    # packages: bit-identical batches need one worker or no draws that
    # change a sample
    for workers in ((1, 3) if not transform and not drop_txt_prob else (1,)):
        jl = jprefetch.PrefetchLoader(
            jdataset.UniDataset(captions, index, **kw), 2,
            num_workers=workers, seed=5, text_encoder=embed)
        tl = tprefetch.PrefetchLoader(
            tdataset.UniDataset(captions, index, **kw), 2,
            num_workers=workers, seed=5, text_encoder=embed)
        assert len(tl) == len(jl) == 2
        for _ in range(2):  # two epochs: the shuffle goes on
            batches = list(jl.epoch())
            for a, b in zip(list(tl.epoch()), batches):
                _same_batch(a, b)


def test_caption_dict_and_flow_pool_match_jax(tmp_path):
    _, captions = _write_dataset(str(tmp_path), 2)
    assert tdataset.load_caption_dict(captions) == \
        jdataset.load_caption_dict(captions) == {
            "00001_0001": "caption number 0",
            "00002_0001": "caption number 1"}
    flow = np.random.default_rng(1).standard_normal((37, 53, 2)).astype(
        np.float32)
    for h, w in ((8, 8), (16, 24), (37, 53)):
        np.testing.assert_array_equal(
            tdataset.adaptive_avg_pool_flow(flow, h, w),
            jdataset.adaptive_avg_pool_flow(flow, h, w))


def test_prefetch_loader_surfaces_a_failing_sample(tmp_path):
    index, captions = _write_dataset(str(tmp_path), 4)
    ds = tdataset.UniDataset(captions, index, resolution=RES)
    os.remove(ds.video_frames[2])
    loader = tprefetch.PrefetchLoader(ds, 1, num_workers=2, shuffle=False)
    with pytest.raises(FileNotFoundError):
        list(loader.epoch())
    ok, errors = ds.validate()
    assert ok == 3 and [i for i, _ in errors] == [2]


def test_metrics_logger_and_meters(caplog):
    m = tlogging.AverageMeter(window=2)
    for v in (1.0, 2.0, 4.0):
        m.update(v)
    assert m.val == 4.0 and m.avg == 3.0 and m.count == 3
    assert tlogging.AverageMeter().avg == 0.0
    timer = tlogging.StepTimer()
    assert timer.steps_per_sec == 0.0
    with timer:
        pass
    assert timer.steps_per_sec > 0
    logger = tlogging.create_logger("test_train_cli")
    assert tlogging.create_logger("test_train_cli") is logger
    with caplog.at_level(logging.INFO, logger="test_train_cli"):
        sink = tlogging.MetricsLogger(logger=logger,
                                      wandb_project="offline-project")
        sink.log({"loss": 0.123456789, "t_mean": 500}, 7)
    assert "step 7: loss=0.12346 t_mean=500" in caplog.text
    if sink.wandb is None:  # the package is absent: a notice, no sink
        assert "wandb requested but unavailable" in caplog.text


def _tiny_root(root):
    """A tiny diffusers root (unet/ vae/ text_encoder/ controlnet/) with
    seeded weights; returns the modules written."""
    unet_cfg, cn_cfg, vae_cfg, clip_cfg = model_configs(True)
    torch.manual_seed(11)
    modules = {"unet": UNet2DConditionModel(unet_cfg),
               "controlnet": DualFlowControlNet(cn_cfg),
               "vae": AutoencoderKL(vae_cfg),
               "text": CLIPTextEncoder(clip_cfg)}
    weights.synthesize_sd_checkpoint_dir(root, modules)
    return modules


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """A tiny root and a `train_distill` run on it: 2 steps with
    checkpoints every step (limit 2), then resumed to step 3.  At lr 1e-3
    (the CLI's default is 1e-6): the EMA then moves ~1e-5, which changes
    the bf16 rounding of most of the student's tensors, so a decode can
    tell the EMA from the teacher and from the masters."""
    base = tmp_path_factory.mktemp("distill")
    root = str(base / "sd")
    teacher = _tiny_root(root)
    index, captions = _write_dataset(str(base / "data"), 4)
    run = str(base / "run")
    args = ["--index_file", index, "--caption_file", captions,
            "--resolution", str(RES), "--sd_checkpoint_dir", root,
            "--output_dir", run, "--tiny", "--device", "cpu",
            "--checkpointing_steps", "1", "--checkpoints_total_limit", "2",
            "--log_every", "1", "--mixed_precision", "fp32",
            "--learning_rate", "1e-3"]
    train_distill.main(args + ["--max_train_steps", "2",
                               "--dataloader_num_workers", "0"])
    after2 = [s for s, _ in tckpt.list_checkpoints(run)]
    state2, _ = tckpt.restore_checkpoint(run, 2)
    train_distill.main(args + ["--max_train_steps", "3",
                               "--resume_from_checkpoint", "latest",
                               "--dataloader_num_workers", "2"])
    return dict(root=root, run=run, teacher=teacher, after2=after2,
                state2=state2, base=base)


def test_train_distill_cli_runs_and_resumes(distilled):
    assert distilled["after2"] == [1, 2]
    run = distilled["run"]
    assert [s for s, _ in tckpt.list_checkpoints(run)] == [2, 3]
    state3, step = tckpt.restore_checkpoint(run)
    state2 = distilled["state2"]
    assert step == 3 and state3["step"] == 3 and state2["step"] == 2
    assert state3["opt_state"]["count"] == 3
    teacher = {f"{k}.{n}": p for k in ("unet", "controlnet")
               for n, p in distilled["teacher"][k].named_parameters()}
    assert set(state3["params"]) == set(teacher)
    moved = 0
    for n, p in teacher.items():
        # warm-started from the root's teacher: 3 Adam steps at lr 1e-3
        # move a weight by at most ~3e-3, the EMA by 0.005 of the masters'
        # moves summed, ~3e-5
        for s in (state2, state3):
            assert (s["params"][n] - p).abs().max() <= 4e-3, n
            assert (s["ema_params"][n] - p).abs().max() <= 4e-5, n
        moved += not torch.equal(state3["params"][n], state2["params"][n])
        # ema <- 0.005 new + 0.995 ema, in fp32
        want = (0.005 * state3["params"][n]
                + (1.0 - (1.0 - 0.995)) * state2["ema_params"][n])
        torch.testing.assert_close(state3["ema_params"][n], want,
                                   atol=1e-7, rtol=1e-6)
    assert moved > 0.9 * len(teacher)


def test_train_distill_cli_refuses_fsdp(tmp_path):
    with pytest.raises(SystemExit, match="mesh"):
        train_distill.main(["--index_file", "x", "--output_dir",
                            str(tmp_path), "--fsdp", "2"])


def _tiny_clip(d, n=3, h=64, w=64):
    os.makedirs(d)
    rng = np.random.default_rng(2)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(d, f"frame_{i:04d}.png"))


def _student_pipeline(root, ema, K):
    """The tiny DualFlow pipeline in bf16 on the CPU filled by hand: the
    root's VAE, the EMA's UNet and ControlNet."""
    unet_cfg, cn_cfg, vae_cfg, _ = model_configs(True)
    pipe = DualFlowPipeline.create(unet_cfg, cn_cfg, vae_cfg,
                                   SamplerConfig(), device="cpu")
    weights.load_sd_checkpoint_dir(root, {"vae": pipe.vae})
    for name, module in (("unet", pipe.unet),
                         ("controlnet", pipe.controlnet)):
        module.load_state_dict({n[len(name) + 1:]: t for n, t in ema.items()
                                if n.startswith(name + ".")})
    return DistilledPipeline.from_pipeline(
        pipe, DistillConfig(num_student_steps=K))


def test_run_codec_decode_with_the_student(distilled, tmp_path):
    frames = str(tmp_path / "frames")
    _tiny_clip(frames)
    enc, dec = str(tmp_path / "enc"), str(tmp_path / "dec")
    run_codec.main(["encode", "--frames", frames, "--out", enc, "--gop", "2",
                    "--mode", "none"])
    run_codec.main(["decode", "--bitstream", enc, "--out", dec, "--tiny",
                    "--device", "cpu", "--sd_checkpoint_dir",
                    distilled["root"], "--distilled_checkpoint",
                    distilled["run"], "--student_steps", "2", "--seed", "4"])
    got = np.stack([np.asarray(Image.open(os.path.join(dec, n)))
                    for n in sorted(os.listdir(dec))])

    state, _ = tckpt.restore_checkpoint(distilled["run"])
    ema, masters = state["ema_params"], state["params"]
    dpipe = _student_pipeline(distilled["root"], ema, 2)

    def sample_fn(cond, flow):
        B, H, W = cond.shape[:3]
        gen = torch.Generator().manual_seed(4)
        latents = torch.randn((B, H // 8, W // 8, 4), generator=gen)
        return dpipe.sample(latents, text.expand(B, -1, -1), cond, flow,
                            generator=gen)

    # the CLI's prompt embedding: the root's CLIP on the empty prompt
    _, _, _, clip_cfg = model_configs(True)
    clip = CLIPTextEncoder(clip_cfg).to(torch.bfloat16).eval()
    weights.load_sd_checkpoint_dir(distilled["root"], {"text": clip})
    from diffcodec_tpu_torch.utils.tokenizer import default_tokenizer
    text, _ = DualFlowPipeline.encode_prompt(
        clip, default_tokenizer(clip_cfg.max_length), [""], [""])
    want = decode_video(EncodedVideo.load(enc), sample_fn,
                        transfer_dtype=torch.bfloat16, device="cpu")
    assert got.shape == want.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(got, want)

    # the decode options' loader put the EMA into the student: the bf16
    # EMA, which differs from the bf16 masters and from the root's teacher
    p = argparse.ArgumentParser()
    run_codec.add_decode_options(p)
    cli_pipe, _, uncond = run_codec.load_decoder(p.parse_args(
        ["--tiny", "--device", "cpu", "--sd_checkpoint_dir",
         distilled["root"], "--distilled_checkpoint", distilled["run"],
         "--student_steps", "2"]), "cpu")
    assert isinstance(cli_pipe, DistilledPipeline) and uncond is None
    assert cli_pipe.config.num_student_steps == 2
    teacher = {f"{k}.{n}": t for k in ("unet", "controlnet")
               for n, t in distilled["teacher"][k].named_parameters()}
    own = dict(denoiser(cli_pipe.unet, cli_pipe.controlnet)
               .named_parameters())
    assert set(own) == set(ema)
    off_masters = off_teacher = 0
    for n, t in own.items():
        assert t.dtype == torch.bfloat16
        torch.testing.assert_close(t, ema[n].to(torch.bfloat16), atol=0,
                                   rtol=0)
        off_masters += not torch.equal(t, masters[n].to(torch.bfloat16))
        off_teacher += not torch.equal(t, teacher[n].detach().to(
            torch.bfloat16))
    assert off_masters > 0.9 * len(own) and off_teacher > 0.5 * len(own)
    with pytest.raises(SystemExit, match="no checkpoint-N"):
        run_codec.main(["decode", "--bitstream", enc, "--out", dec,
                        "--tiny", "--device", "cpu", "--distilled_checkpoint",
                        str(tmp_path / "nothing")])


def test_rd_sweep_and_distill_eval_with_the_student(distilled, tmp_path):
    # MS-SSIM's 5 scales of 11-tap blurs need 176 px or more
    _tiny_clip(str(tmp_path / "videos" / "clip" / "frames"), n=3, h=192,
               w=192)
    out = str(tmp_path / "rd")
    rd_sweep.main(["--dataset_root", str(tmp_path / "videos"), "--out", out,
                   "--gops", "2", "--modes", "none", "--tiny", "--device",
                   "cpu", "--sd_checkpoint_dir", distilled["root"],
                   "--distilled_checkpoint", distilled["run"],
                   "--student_steps", "2"])
    with open(os.path.join(out, "metric_results.json")) as f:
        metrics = json.load(f)
    psnr = metrics["2"]["clip"]["none"]["all"]["psnr"]
    assert np.isfinite(psnr)
    assert os.path.exists(os.path.join(out, "rd_psnr.pdf"))

    path = str(tmp_path / "eval" / "distill_eval.json")
    distill_eval.main(["--small", "--device", "cpu", "--steps", "3",
                       "--k_values", "1,2", "--batch", "1",
                       "--sd_checkpoint_dir", distilled["root"],
                       "--distilled_checkpoint", distilled["run"],
                       "--out", path])
    with open(path) as f:
        res = json.load(f)
    assert res["distilled"] and res["student_checkpoint_step"] == 3
    assert res["height"] == 128 and res["teacher_steps"] == 3
    assert sorted(res["per_k"]) == ["K1", "K2"]
    for rec in res["per_k"].values():
        assert np.isfinite(rec["psnr_vs_teacher_db"])
        assert 0 < rec["max_abs_pixel_delta"] <= 2.0


def test_train_residual_cli_one_step(tmp_path):
    index, captions = _write_dataset(str(tmp_path / "data"), 2)
    out = str(tmp_path / "run")
    train_residual.main(["--index_file", index, "--caption_file", captions,
                         "--output_dir", out, "--resolution", "32",
                         "--train_batch_size", "2", "--num_epochs", "1",
                         "--device", "cpu", "--seed", "3"])
    state, step = tckpt.restore_checkpoint(out)
    assert step == 1
    torch.manual_seed(3)
    fresh = dict(UNet2DModel().named_parameters())
    assert set(state["params"]) == set(fresh)
    moved = [n for n, p in fresh.items()
             if not torch.equal(state["params"][n], p.detach())]
    # AdamW's first step moves every weight by about lr = 4e-4
    assert len(moved) == len(fresh)
    assert all(torch.isfinite(p).all() for p in state["params"].values())
