"""The port's ControlNet trainer CLI and its in-training validation against
the JAX package, on the CPU.

  * `utils/png_io.py`: its files read back by PIL pixel for pixel;
  * `train.validation.run_validation`: with a stand-in pipeline handing
    both packages the same images, the metrics, the logged panels and the
    PNG pixels equal JAX's; the tiny `DualFlowPipeline` fed JAX's own
    latent draws against JAX's `run_validation` over the JAX pipeline on
    the same weights;
  * `cli.train_controlnet --tiny --device cpu` over a dataset written by
    the test: each step bit-identical to `ControlNetTrainer.train_step` by
    hand on the loader's batch with `step_generator(seed, step)`; the
    checkpoint rotation of JAX's script under the same flags; a resumed
    run bit-identical to an uninterrupted one; `--pretrained_checkpoint`
    (a reference-named file written by JAX's `export_state_dict`) warm
    starting the tensors and count of JAX's `warm_start_filter`;
    `--latent_cache_dir` and `--model_variant res` each taking a step,
    and `--validation_steps` writing panels; the options that need the
    mesh or another attention refused.
"""

import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models import hf_import
from diffcodec_tpu.models.controlnet import DualFlowControlNet as JControlNet
from diffcodec_tpu.models.unet2d_condition import (
    UNet2DConditionModel as JUNet)
from diffcodec_tpu.models.vae import AutoencoderKL as JVAE
from diffcodec_tpu.sampling.pipeline import DualFlowPipeline as JPipeline
from diffcodec_tpu.sampling.schedulers import NoiseSchedule as JSchedule
from diffcodec_tpu.train import checkpoint as jckpt
from diffcodec_tpu.train import validation as jvalidation

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.cli import train_controlnet
from diffcodec_tpu_torch.cli.train_distill import step_generator
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.train import checkpoint as tckpt
from diffcodec_tpu_torch.train import dataset as tdataset
from diffcodec_tpu_torch.train import validation as tvalidation
from diffcodec_tpu_torch.utils import png_io
from diffcodec_tpu_torch.weights import load_pipeline_params

from tests.test_torch_port_train_cli import _write_dataset
from torch_threads import few_torch_threads

VAE_KW = dict(base_channels=8, channel_mults=(1, 1, 2, 2), layers_per_block=1)
RES = 32


_one_torch_thread = few_torch_threads(1)


def _randomize(params, seed):
    """Seeded float32 values for a tree of shapes: norm scales near 1,
    small biases, kernels ~ N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            v = rng.uniform(0.7, 1.3, p.shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, p.shape)
        else:
            fan_in = int(np.prod(p.shape[:-1])) if len(p.shape) > 1 else 1
            v = rng.standard_normal(p.shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _controlnet_shapes(H=64):
    h = H // 8
    return jax.eval_shape(
        JControlNet(jcfg.ControlNetConfig.tiny()).init,
        jax.random.PRNGKey(0), jnp.zeros((1, h, h, 4)), jnp.asarray([0]),
        jnp.zeros((1, 5, 32)), jnp.zeros((1, H, H, 6)),
        jnp.zeros((1, H, H, 4)))


class _Recorder:
    """The logger interface `run_validation` uses, recording."""

    def __init__(self):
        self.scalars, self.images = [], []

    def log(self, metrics, step):
        self.scalars.append((dict(metrics), step))

    def log_image(self, tag, image, step):
        self.images.append((tag, np.asarray(image), step))


# --- PNG ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (48, 200, 3)])
def test_png_writer_reads_in_pil(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    path = str(tmp_path / "x.png")
    assert png_io.write_png(path, img) == os.path.getsize(path)
    with Image.open(path) as f:
        assert f.mode == "RGB" and f.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(f), img)
    np.testing.assert_array_equal(png_io.read_png(path), img)


def test_png_reader_refuses_other_forms():
    img = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
    data = png_io.encode_png(img)
    bad_crc = bytearray(data)
    bad_crc[-20] ^= 1  # inside the IDAT body
    with pytest.raises(ValueError, match="CRC"):
        png_io.decode_png(bytes(bad_crc))
    # the same pixels with scanline filter 1 (sub) on every row
    import struct
    import zlib
    rows = np.concatenate([np.ones((4, 1), np.uint8), img.reshape(4, 15)], 1)
    idat = zlib.compress(rows.tobytes())
    chunk = (struct.pack(">I", len(idat)) + b"IDAT" + idat
             + struct.pack(">I", zlib.crc32(b"IDAT" + idat)))
    start = data.index(b"IDAT") - 4
    end = data.index(b"IEND") - 4
    with pytest.raises(ValueError, match="filter"):
        png_io.decode_png(data[:start] + chunk + data[end:])
    with pytest.raises(ValueError, match="uint8"):
        png_io.encode_png(img.astype(np.float32))


# --- validation --------------------------------------------------------


class _JStandin:
    def __init__(self, images):
        self.images = images

    def sample(self, params, rng, text, uncond, cond, flow):
        return jnp.asarray(self.images)


class _TStandin:
    def __init__(self, images):
        self.images = images

    def sample(self, latents, text, uncond, cond, flow):
        return torch.from_numpy(self.images)


def _val_batch(B, H, seed):
    rng = np.random.default_rng(seed)
    return {"cond": rng.uniform(-0.1, 1.1, (B, H, H, 6)).astype(np.float32),
            "flow": rng.standard_normal((B, H, H, 4)).astype(np.float32),
            "image": rng.uniform(-1.1, 1.1, (B, H, H, 3)).astype(np.float32)}


@pytest.mark.parametrize("H,same", [(192, False), (64, False), (64, True)])
def test_run_validation_matches_jax_with_a_standin(tmp_path, H, same):
    """The same images to both packages (outside [-1, 1] in places, so the
    clip shows): metrics, logged panels and PNG pixels.  At 192 px MS-SSIM
    is computed, at 64 px it is NaN; identical prediction and ground truth
    give an infinite PSNR."""
    B = 2
    batch = _val_batch(B, H, H)
    images = (batch["image"] if same else np.random.default_rng(5).uniform(
        -1.2, 1.2, (B, H, H, 3)).astype(np.float32))
    jrec, trec = _Recorder(), _Recorder()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jvalidation.run_validation(
        _JStandin(images), None, batch, None, None, None, out_dir=jdir,
        logger=jrec, step=12)
    got = tvalidation.run_validation(
        _TStandin(images), batch, torch.zeros(B, 5, 8),
        torch.zeros(B, 5, 8), torch.zeros(B, H // 8, H // 8, 4),
        out_dir=tdir, logger=trec, step=12)
    assert got.keys() == want.keys() == {"val_psnr", "val_ms_ssim"}
    if same:
        assert got["val_psnr"] == want["val_psnr"] == float("inf")
    else:
        # fp32 means of ~1e5 squared errors of the same uint8 pixels,
        # summed in another order (1.7e-6 relative apart at 192 px): the
        # limits of tests/test_torch_port_cli.py's metrics
        np.testing.assert_allclose(got["val_psnr"], want["val_psnr"],
                                   rtol=1e-5)
    if H >= 176:
        np.testing.assert_allclose(got["val_ms_ssim"], want["val_ms_ssim"],
                                   atol=2e-5, rtol=1e-4)
    else:
        assert np.isnan(got["val_ms_ssim"]) and np.isnan(
            want["val_ms_ssim"])
    assert [s for _, s in trec.scalars] == [s for _, s in jrec.scalars]
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == [f"val_0000012_{b}.png"
                                                 for b in range(B)]
    for name, (jtag, jimg, _), (ttag, timg, _) in zip(names, jrec.images,
                                                      trec.images):
        with Image.open(os.path.join(jdir, name)) as a, \
                Image.open(os.path.join(tdir, name)) as b:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
            np.testing.assert_array_equal(np.asarray(b), timg)
        assert ttag == jtag
        np.testing.assert_array_equal(timg, jimg)
        assert timg.shape == (H, 4 * H, 3)


@pytest.fixture(scope="module")
def tiny_pipelines():
    H, h = 64, 8
    key = jax.random.PRNGKey(0)
    sample, t0 = jnp.zeros((1, h, h, 4)), jnp.asarray([0])
    ctx = jnp.zeros((1, 5, 32))
    unet = JUNet(jcfg.UNetConfig.tiny())
    vae = JVAE(jcfg.VAEConfig(**VAE_KW))
    shapes = {"unet": jax.eval_shape(unet.init, key, sample, t0, ctx),
              "controlnet": _controlnet_shapes(H),
              "vae": jax.eval_shape(vae.init, key, jnp.zeros((1, H, H, 3)))}
    params = {k: _randomize(v, i) for i, (k, v) in enumerate(shapes.items())}
    sampler = dict(num_inference_steps=3, guidance_scale=3.5)
    jpipe = JPipeline(unet=unet, controlnet=JControlNet(
        jcfg.ControlNetConfig.tiny()), vae=vae,
        schedule=JSchedule.create(jcfg.SchedulerConfig()),
        sampler=jcfg.SamplerConfig(**sampler))
    pipe = DualFlowPipeline.create(
        tcfg.UNetConfig.tiny(), tcfg.ControlNetConfig.tiny(),
        tcfg.VAEConfig(**VAE_KW), tcfg.SamplerConfig(**sampler),
        dtype=torch.float32, device="cpu")
    load_pipeline_params(pipe, params)
    return jpipe, params, pipe


def test_run_validation_tiny_pipeline_matches_jax(tiny_pipelines, tmp_path):
    """JAX's `run_validation` over the JAX pipeline (its latents drawn
    from its key) against the port's over the tiny `DualFlowPipeline` fed
    JAX's own draw (`prepare_latents` of the same key), the same weights,
    batch and embeddings, fp32."""
    jpipe, params, pipe = tiny_pipelines
    B, H = 2, 64
    batch = _val_batch(B, H, 9)
    text = np.random.default_rng(10).standard_normal((B, 5, 32)).astype(
        np.float32) * 0.5
    key = jax.random.PRNGKey(4)

    class Jitted:
        sample = staticmethod(jax.jit(jpipe.sample))

    jrec, trec = _Recorder(), _Recorder()
    want = jvalidation.run_validation(
        Jitted(), params, batch, jnp.asarray(text),
        jnp.zeros_like(jnp.asarray(text)), key,
        out_dir=str(tmp_path / "jax"), logger=jrec, step=2)
    latents = torch.from_numpy(np.asarray(jpipe.prepare_latents(key, B, H,
                                                                H)))
    got = tvalidation.run_validation(
        pipe, batch, torch.from_numpy(text), torch.zeros(B, 5, 32), latents,
        out_dir=str(tmp_path / "port"), logger=trec, step=2)
    # fp32 through 3 CFG steps and the VAE on both sides: the images agree
    # to ~1e-3 (tests/test_torch_port_pipeline.py), so a uint8 pixel may
    # round one level apart and the PSNR move by a few thousandths of a dB
    assert abs(got["val_psnr"] - want["val_psnr"]) <= 0.01
    assert np.isnan(got["val_ms_ssim"]) and np.isnan(want["val_ms_ssim"])
    for (_, jimg, _), (_, timg, _) in zip(jrec.images, trec.images):
        # the anchors and the ground truth exactly, the prediction to one
        # uint8 level
        np.testing.assert_array_equal(timg[:, :2 * H], jimg[:, :2 * H])
        np.testing.assert_array_equal(timg[:, 3 * H:], jimg[:, 3 * H:])
        diff = np.abs(timg[:, 2 * H:3 * H].astype(int)
                      - jimg[:, 2 * H:3 * H].astype(int))
        assert diff.max() <= 1 and diff.mean() < 0.01
        assert 5 < jimg[:, 2 * H:3 * H].std()  # not a flat prediction


# --- the CLI -----------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("cn_data")), 4)


def _cli(data, run, *extra):
    index, captions = data
    return ["--index_file", index, "--caption_file", captions,
            "--resolution", str(RES), "--train_batch_size", "2",
            "--output_dir", str(run), "--tiny", "--device", "cpu",
            "--mixed_precision", "no", "--dataloader_num_workers", "0",
            "--log_every", "1", "--seed", "3", "--learning_rate", "1e-3",
            *extra]


def _torch_batch(raw):
    batch = {k: torch.from_numpy(v) for k, v in raw.items()
             if k not in ("text", "text_embeds")}
    batch["text_embeds"] = raw["text_embeds"]
    return batch


def test_train_controlnet_steps_are_the_trainers(data, tmp_path):
    """Three CLI steps (two batches an epoch of 4 samples, so the third
    starts a reshuffled epoch), checkpointed each step, against
    `train_step` by hand on the dataset's batches with
    `step_generator(seed, step)`: masters and Adam's moments bit for
    bit."""
    run = tmp_path / "run"
    argv = _cli(data, run, "--max_train_steps", "3",
                "--checkpointing_steps", "1")
    train_controlnet.main(argv)
    assert [s for s, _ in tckpt.list_checkpoints(str(run))] == [1, 2, 3]

    args = train_controlnet.parse_args(argv)
    trainer, state, text_encoder, tokenizer = train_controlnet.build_trainer(
        args)
    index, captions = data
    ds = tdataset.UniDataset(captions, index, resolution=RES,
                             drop_txt_prob=0.3, transform=True, seed=3)

    @torch.no_grad()
    def embed(texts):
        return text_encoder(torch.from_numpy(tokenizer(list(texts))))

    step = 0
    while step < 3:
        for raw in ds.iter_batches(2, text_encoder=embed):
            if step >= 3:
                break
            state, _ = trainer.train_step(state, _torch_batch(raw),
                                          step_generator(3, step, "cpu"))
            step += 1
            saved, _ = tckpt.restore_checkpoint(str(run), step)
            assert saved["step"] == state.step == step
            assert saved["opt_state"]["count"] == step
            for n, p in state.params.items():
                assert torch.equal(saved["params"][n], p), (step, n)
                for k in ("mu", "nu"):
                    assert torch.equal(saved["opt_state"][k][n],
                                       state.opt_state[k][n]), (step, k, n)


def _jax_rotation(tmp_path, checkpointing_steps, total_limit, max_steps,
                  start=0):
    """The checkpoint-N set JAX's script leaves: its loop's saves (every
    `checkpointing_steps`, then one at the end,
    `scripts/train_controlnet.py:356-366`) through JAX's own
    `save_checkpoint` and its rotation, over a small state."""
    d = str(tmp_path / "jax_run")
    state = {"w": np.zeros(3, np.float32)}
    for step in range(start + 1, max_steps + 1):
        if step % checkpointing_steps == 0:
            jckpt.save_checkpoint(d, step, state, total_limit=total_limit)
    jckpt.save_checkpoint(d, max_steps, state, total_limit=total_limit)
    return [s for s, _ in jckpt.list_checkpoints(d)]


def test_train_controlnet_rotation_matches_jax(data, tmp_path):
    run = tmp_path / "run"
    flags = ["--checkpointing_steps", "2", "--checkpoints_total_limit", "2"]
    train_controlnet.main(_cli(data, run, "--max_train_steps", "6", *flags))
    got = [s for s, _ in tckpt.list_checkpoints(str(run))]
    assert got == _jax_rotation(tmp_path, 2, 2, 6) == [4, 6]
    train_controlnet.main(_cli(data, run, "--max_train_steps", "8",
                               "--resume_from_checkpoint", "latest",
                               *flags))
    got = [s for s, _ in tckpt.list_checkpoints(str(run))]
    assert got == _jax_rotation(tmp_path, 2, 2, 8, start=6) == [6, 8]
    state, _ = tckpt.restore_checkpoint(str(run))
    assert state["step"] == 8 and state["opt_state"]["count"] == 8


@pytest.mark.slow
def test_train_controlnet_rotation_matches_jax_script(data, tmp_path):
    """The same flags through JAX's own script (its jitted step on the
    8-device CPU mesh, ~100 s) and the port's CLI: the same checkpoint-N
    sets after 6 steps and after resuming to 8."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import train_controlnet as jcli

    index, _ = data
    sets = {}
    for name, main in (("jax", jcli.main), ("port", train_controlnet.main)):
        run = str(tmp_path / name)
        common = ["--index_file", index, "--output_dir", run, "--tiny",
                  "--resolution", str(RES), "--train_batch_size", "2",
                  "--learning_rate", "1e-4", "--lr_warmup_steps", "0",
                  "--checkpointing_steps", "2",
                  "--checkpoints_total_limit", "2", "--log_every", "1",
                  "--dataloader_num_workers", "0"]
        if name == "port":
            common += ["--device", "cpu"]
        main(common + ["--max_train_steps", "6"])
        after6 = [s for s, _ in jckpt.list_checkpoints(run)]
        main(common + ["--max_train_steps", "8",
                       "--resume_from_checkpoint", "latest"])
        sets[name] = (after6, [s for s, _ in jckpt.list_checkpoints(run)])
    assert sets["port"] == sets["jax"]


def test_train_controlnet_resume_equals_uninterrupted(data, tmp_path):
    """`build_trainer` + `train` to step 3 in one run, and to step 2 then
    `--resume_from_checkpoint latest` to 3 in another, on the same fixed
    batch: the same masters and moments, bit for bit."""
    index, captions = data
    ds = tdataset.UniDataset(captions, index, resolution=RES, seed=3)
    raw0 = next(ds.iter_batches(2))
    logger = logging.getLogger("test_train_controlnet")
    final = {}
    for name, legs in (("straight", [("3", "")]),
                       ("resumed", [("2", ""), ("3", "latest")])):
        run = tmp_path / name
        for max_steps, resume in legs:
            args = train_controlnet.parse_args(_cli(
                (index, captions), run, "--max_train_steps", max_steps,
                "--resume_from_checkpoint", resume))
            trainer, state, text_encoder, tokenizer = (
                train_controlnet.build_trainer(args, logger))
            raw = dict(raw0, text_embeds=text_encoder(
                torch.from_numpy(tokenizer(raw0["text"]))).detach())
            state = train_controlnet.train(args, trainer, state,
                                           lambda: [raw], None, logger)
        final[name] = state
    a, b = final["straight"], final["resumed"]
    assert a.step == b.step == 3
    assert a.opt_state["count"] == b.opt_state["count"] == 3
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
        for k in ("mu", "nu"):
            assert torch.equal(a.opt_state[k][n], b.opt_state[k][n]), n


def test_pretrained_checkpoint_warm_starts_like_jax(data, tmp_path, caplog):
    """A reference-named ControlNet file written by JAX's
    `export_state_dict` warm-starts the same tensors, and counts as many,
    as JAX's script does (`convert_state_dict` + `warm_start_filter`)."""
    from safetensors.numpy import save_file

    cfg = jcfg.ControlNetConfig.tiny()
    name_map = hf_import.controlnet_name_map(cfg)
    shapes = _controlnet_shapes()
    pretrained = _randomize(shapes, 21)
    path = str(tmp_path / "pretrained.safetensors")
    save_file(hf_import.export_state_dict(pretrained, name_map), path)
    fresh = _randomize(shapes, 22)
    loaded, _, _ = hf_import.convert_state_dict(
        hf_import.load_torch_state_dict(path), name_map, fresh, strict=False)
    want, copied = jckpt.warm_start_filter(fresh, loaded)
    want_sd = hf_import.export_state_dict(want, name_map)

    args = train_controlnet.parse_args(_cli(
        data, tmp_path / "run", "--pretrained_checkpoint", path))
    with caplog.at_level(logging.INFO, logger="test_warm_start"):
        trainer, state, _, _ = train_controlnet.build_trainer(
            args, logging.getLogger("test_warm_start"))
    assert f"warm-started {copied} tensors" in caplog.text
    assert copied == len(want_sd) == len(state.params)
    assert set(state.params) == set(want_sd)
    for n, p in state.params.items():
        np.testing.assert_array_equal(p.numpy(), want_sd[n], err_msg=n)
        assert torch.equal(dict(trainer.controlnet.named_parameters())[n]
                           .detach(), p), n


def test_latent_cache_res_variant_and_validation_take_steps(data, tmp_path):
    """`--latent_cache_dir` (the cache written once, then read), `--model_
    variant res` (the residue batch made in the loop) and
    `--validation_steps` (panels of every validation batch row): each run
    takes its steps and moves the masters."""
    index, _ = data
    for name, extra in (
            ("cache", ["--latent_cache_dir", str(tmp_path / "cache")]),
            ("res", ["--model_variant", "res"]),
            ("val", ["--validation_steps", "2", "--validation_index_file",
                     index])):
        run = tmp_path / name
        train_controlnet.main(_cli(data, run, "--max_train_steps", "2",
                                   *extra))
        state, step = tckpt.restore_checkpoint(str(run))
        assert step == 2 and state["step"] == 2
        args = train_controlnet.parse_args(_cli(data, run, *extra))
        _, fresh, _, _ = train_controlnet.build_trainer(args)
        assert set(state["params"]) == set(fresh.params)
        moved = sum(not torch.equal(state["params"][n], p)
                    for n, p in fresh.params.items())
        assert moved > 0.9 * len(fresh.params), name
    cache = sorted(os.listdir(tmp_path / "cache"))
    assert len([f for f in cache if f.endswith(".npy")]) == 4
    panels = sorted(os.listdir(tmp_path / "val" / "validation"))
    assert panels == ["val_0000002_0.png", "val_0000002_1.png"]
    for name in panels:
        img = png_io.read_png(str(tmp_path / "val" / "validation" / name))
        assert img.shape == (RES, 4 * RES, 3)


@pytest.mark.parametrize("extra,match", [
    (["--fsdp", "2"], "mesh"),
    (["--long_attn_impl", "einsum"], "flash"),
    (["--latent_cache_dir", "c", "--model_variant", "res"], "dualflow-only")])
def test_train_controlnet_refuses(data, tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        train_controlnet.main(_cli(data, tmp_path / "run",
                                   "--max_train_steps", "1", *extra))
