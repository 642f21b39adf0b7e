"""The port's codec CLIs against the JAX package's scripts, on the CPU.

  * `run_codec encode` writes, in all three flow modes, a bitstream
    directory byte-identical to `scripts/run_codec.py encode`'s;
  * `run_codec decode --tiny --device cpu --sd_checkpoint_dir <a tiny
    root>` loads the root (CLIP included) and writes uint8 PNGs of the
    clip's shape (the decode's numbers are `test_torch_port_codec.py`'s
    business; the two CLIs draw different noise);
  * `run_codec eval` prints JAX's result dict (PSNR to rtol 1e-5, the
    SSIMs to atol 2e-5 / rtol 1e-4: fp32 sums in another order);
  * `rd_sweep` over two tiny videos writes the three JSONs with JAX's
    keys, JAX's bpp values (from JAX's `encode_video` on the same frames
    and flows, bit for bit) and the RD plots.
"""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from diffcodec_tpu.codec import runner as jrunner
from diffcodec_tpu.config import CodecConfig as JCodecConfig
from diffcodec_tpu.utils.flo_io import write_flo

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.cli import rd_sweep, run_codec
from diffcodec_tpu_torch.models import weights
from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
from diffcodec_tpu_torch.models.unet2d_condition import UNet2DConditionModel
from diffcodec_tpu_torch.models.vae import AutoencoderKL

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import run_codec as jcli  # noqa: E402  (scripts/run_codec.py)
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

PSNR_RTOL = 1e-5
SSIM_TOL = dict(atol=2e-5, rtol=1e-4)


def _clip(d, n, h, w, seed):
    """n frames of a moving gradient and noise under d/frames, their
    forward and backward flows under d/Flow and d/Flow_b for every frame
    (the codec reads the GOP's inter frames')."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    os.makedirs(os.path.join(d, "frames"))
    os.makedirs(os.path.join(d, "Flow"))
    os.makedirs(os.path.join(d, "Flow_b"))
    frames = []
    for i in range(n):
        img = np.stack([(yy * 2 + 3 * i) % 256, (xx + 5 * i) % 256,
                        (yy + xx) // 2 % 256], -1).astype(np.float32)
        img = np.clip(img + rng.normal(0, 10, img.shape), 0, 255)
        frames.append(img.astype(np.uint8))
        Image.fromarray(frames[-1]).save(
            os.path.join(d, "frames", f"frame_{i:04d}.png"))
        flow = (rng.standard_normal((h, w, 2)) * 2 + [3, -1]).astype(
            np.float32)
        write_flo(os.path.join(d, "Flow", f"flow_{i:04d}.flo"), flow)
        write_flo(os.path.join(d, "Flow_b", f"flow_{i:04d}.flo"), -flow)
    return np.stack(frames)


def _same_tree(a, b):
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return files


@pytest.mark.parametrize("mode", ["none", "sparse", "dense"])
def test_encode_writes_jax_bitstreams(tmp_path, mode):
    _clip(str(tmp_path), 5, 64, 96, 0)
    args = ["encode", "--frames", str(tmp_path / "frames"), "--gop", "4",
            "--mode", mode, "--flow_fwd", str(tmp_path / "Flow"),
            "--flow_bwd", str(tmp_path / "Flow_b")]
    jcli.main(args + ["--out", str(tmp_path / "jax")])
    run_codec.main(args + ["--out", str(tmp_path / "port")])
    files = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert "meta.json" in files
    assert any(f.startswith("flow_fwd") for f in files) == (mode != "none")


def _tiny_sd_root(d):
    modules = {"unet": UNet2DConditionModel(tcfg.UNetConfig.tiny()),
               "controlnet": DualFlowControlNet(tcfg.ControlNetConfig.tiny()),
               "vae": AutoencoderKL(tcfg.VAEConfig(
                   base_channels=8, channel_mults=(1, 1, 2, 2),
                   layers_per_block=1)),
               "text": CLIPTextEncoder(tcfg.CLIPTextConfig.tiny())}
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in modules.values():
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    weights.synthesize_sd_checkpoint_dir(d, modules)
    return d


def test_decode_from_a_checkpoint_root(tmp_path):
    frames = _clip(str(tmp_path), 3, 64, 64, 1)
    run_codec.main(["encode", "--frames", str(tmp_path / "frames"), "--out",
                    str(tmp_path / "enc"), "--gop", "2", "--mode", "dense",
                    "--flow_fwd", str(tmp_path / "Flow"), "--flow_bwd",
                    str(tmp_path / "Flow_b")])
    root = _tiny_sd_root(str(tmp_path / "sd"))
    out = tmp_path / "dec"
    run_codec.main(["decode", "--bitstream", str(tmp_path / "enc"),
                    "--out", str(out), "--tiny", "--device", "cpu",
                    "--steps", "2", "--sd_checkpoint_dir", root,
                    "--prompt", "a red car", "--negative_prompt", "blur"])
    names = sorted(os.listdir(out))
    assert names == [f"frame_{i:04d}.png" for i in range(3)]
    for n in names:
        img = np.asarray(Image.open(out / n))
        assert img.dtype == np.uint8 and img.shape == frames.shape[1:]
    # the anchors are the JPEG round trips, the inter frame is generated
    dec = np.stack([np.asarray(Image.open(out / n)) for n in names])
    assert np.abs(dec[0].astype(int) - frames[0]).mean() < 10
    assert not np.array_equal(dec[1], dec[0])


def test_eval_prints_jax_dict(tmp_path, capsys):
    frames = _clip(str(tmp_path / "o"), 5, 192, 256, 2)
    rng = np.random.default_rng(3)
    os.makedirs(tmp_path / "pred")
    for i in (0, 1, 3, 4):  # frame 2 missing
        p = np.clip(frames[i] + rng.normal(0, 9, frames[i].shape), 0, 255)
        Image.fromarray(p.astype(np.uint8)).save(
            tmp_path / "pred" / f"frame_{i:04d}.png")
    args = ["eval", "--orig", str(tmp_path / "o" / "frames"), "--pred",
            str(tmp_path / "pred"), "--gop", "2"]
    jcli.main(args)
    want = json.loads(capsys.readouterr().out)
    run_codec.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys() == {"all", "inter"}
    for part in want:
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            if k == "psnr":
                np.testing.assert_allclose(got[part][k], v, rtol=PSNR_RTOL)
            elif k == "ms_ssim":
                np.testing.assert_allclose(got[part][k], v, **SSIM_TOL)
            else:
                assert got[part][k] == v, k


def test_rd_sweep_writes_jax_tables(tmp_path):
    root = tmp_path / "data"
    clips = {v: _clip(str(root / v), 3, 192, 192, s)
             for s, v in enumerate(["beauty", "jockey"])}
    out = tmp_path / "rd"
    rd_sweep.main(["--dataset_root", str(root), "--out", str(out),
                   "--gops", "2", "--modes", "none", "dense", "--tiny",
                   "--steps", "1", "--guidance", "1.0", "--device", "cpu"])
    tables = {n: json.load(open(out / f"{n}.json"))
              for n in ("bpp_results", "inter_bpp_results",
                        "metric_results")}
    for video, frames in clips.items():
        for mode in ("none", "dense"):
            flows = None
            if mode == "dense":
                from diffcodec_tpu.utils.flo_io import read_flo
                flows = [{1: read_flo(str(root / video / d /
                                          "flow_0001.flo"))}
                         for d in ("Flow", "Flow_b")]
            enc = jrunner.encode_video(
                frames, str(tmp_path / "jax" / video / mode),
                JCodecConfig(gop_size=2, flow_rate_mode=mode),
                flows_fwd=flows and flows[0], flows_bwd=flows and flows[1])
            assert tables["bpp_results"]["2"][video][mode] == \
                enc.meta["bpp"]["total"]
            assert tables["inter_bpp_results"]["2"][video][mode] == \
                enc.meta["bpp"]["flow"]
            m = tables["metric_results"]["2"][video][mode]
            assert m.keys() == {"all", "inter"}
            assert m["all"].keys() == m["inter"].keys() == {"psnr",
                                                            "ms_ssim"}
            assert np.isfinite(m["all"]["psnr"])
    assert tables["bpp_results"].keys() == {"2"}
    assert (out / "rd_psnr.pdf").exists() and (out / "rd_ms_ssim.pdf").exists()
