"""The port's codec layer against the JAX package's, on the CPU: the GOP
schedule, the flow bitstreams and reports, the sparse-flow sampler, the
encoder's files and the decoder's orchestration.

Everything here is host code or exact arithmetic, so the tolerance is
zero: equal arrays, byte-identical bitstreams and files, and uint8 frames
equal bit for bit.  The decoder is driven by a stand-in sampler (the same
elementwise function written for both frameworks: sums, and products by
powers of 2, so no rounding can differ) that puts NaN and +-inf into some
frames, so the conversion to uint8 is held on every branch.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu import config as jconfig
from diffcodec_tpu.codec import bits as jbits
from diffcodec_tpu.codec import gop as jgop
from diffcodec_tpu.codec import runner as jrunner
from diffcodec_tpu.codec import sparse_flow as jsf

from diffcodec_tpu_torch import config
from diffcodec_tpu_torch.codec import bits, gop, runner, sparse_flow

H, W = 48, 64


def test_codec_config_matches_jax():
    assert (dataclasses.asdict(config.CodecConfig())
            == dataclasses.asdict(jconfig.CodecConfig()))


@pytest.mark.parametrize("n,g", [(9, 8), (10, 4), (7, 3), (1, 8), (16, 8)])
def test_gop_schedule_matches_jax(n, g):
    assert gop.get_inter_frames(n, g) == jgop.get_inter_frames(n, g)
    assert gop.get_intra_frames(n, g) == jgop.get_intra_frames(n, g)
    assert ([dataclasses.astuple(i) for i in gop.gop_schedule(n, g)]
            == [dataclasses.astuple(i) for i in jgop.gop_schedule(n, g)])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_batch_gop_conditions_matches_jax(dtype):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (10, 8, 12, 3)).astype(dtype)
    flows = {t: rng.standard_normal((8, 12, 2)).astype(np.float32)
             for t in range(10)}
    back = {t: -f for t, f in flows.items()}
    got = gop.batch_gop_conditions(frames, flows, back,
                                   gop.gop_schedule(10, 4))
    want = jgop.batch_gop_conditions(frames, flows, back,
                                     jgop.gop_schedule(10, 4))
    for k in ("cond", "flow"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _flow(seed, h=H, w=W):
    """A smooth field with a moving square: edges for the watershed
    sampler, a background for the grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([np.sin(xx / 9.0) * 3, np.cos(yy / 7.0) * 2], -1)
    y0, x0 = rng.integers(4, h // 2), rng.integers(4, w // 2)
    flow[y0:y0 + h // 3, x0:x0 + w // 3] += rng.uniform(-8, 8, 2)
    return flow.astype(np.float32)


@pytest.mark.parametrize("strategy", [("grid",), ("uniform",), ("gradnms",),
                                      ("watershed",), ("watershed", "grid"),
                                      ("single",), ("full",)])
def test_flow_sampler_matches_jax(strategy):
    flow = _flow(2)
    kw = dict(strategy=strategy, bg_ratio=40 / (H * W), nms_ks=7)
    got = sparse_flow.flow_sampler(flow, rng=np.random.default_rng(3), **kw)
    want = jsf.flow_sampler(flow, rng=np.random.default_rng(3), **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 0


def test_sampler_helpers_match_jax():
    flow = _flow(4)
    for blur in (False, True):
        np.testing.assert_array_equal(sparse_flow.get_edge(flow, blur),
                                      jsf.get_edge(flow, blur))
    score = sparse_flow.get_edge(flow)
    np.testing.assert_array_equal(sparse_flow.nms(score, 5),
                                  jsf.nms(score, 5))
    rng = np.random.default_rng(5)
    ph, pw = rng.integers(0, H, 40), rng.integers(0, W, 40)
    got = sparse_flow.neighbor_elim(ph, pw, 6.0, np.random.default_rng(6))
    want = jsf.neighbor_elim(ph, pw, 6.0, np.random.default_rng(6))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sparse_flow_bitstream_matches_jax():
    flow = _flow(7)
    sparse, mask = sparse_flow.flow_sampler(
        flow, ("watershed", "grid"), bg_ratio=40 / (H * W), nms_ks=7)
    data = bits.encode_sparse_flow(sparse, mask)
    assert data == jbits.encode_sparse_flow(sparse, mask)
    assert len(data) == bits.HEADER_BYTES + 6 * int(mask[..., 0].sum())
    for g, w in zip(bits.decode_sparse_flow(data),
                    jbits.decode_sparse_flow(data)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    empty = np.zeros((H, W, 2), np.int32)
    assert (bits.encode_sparse_flow(sparse, empty)
            == jbits.encode_sparse_flow(sparse, empty))


def test_dense_flow_bitstream_matches_jax():
    flow = _flow(8) * 3.3
    data = runner.encode_dense_flow(flow)
    assert data == jrunner.encode_dense_flow(flow)
    np.testing.assert_array_equal(runner.decode_dense_flow(data),
                                  jrunner.decode_dense_flow(data))


def test_reports_and_bpp_match_jax(tmp_path):
    entries = {"frame_0000.jpg": 12345, "frame_0008.jpg": 999}
    for mod, name in ((bits, "port.txt"), (jbits, "jax.txt")):
        mod.write_compression_report(str(tmp_path / name), entries)
    port, jax_ = ((tmp_path / n).read_bytes() for n in ("port.txt",
                                                         "jax.txt"))
    assert port == jax_
    colon = tmp_path / "colon.txt"
    colon.write_text("a: 1406 bytes\nb: 2.5 KB\nc → 1.94 KB\n",
                     encoding="utf-8")
    for path in (tmp_path / "port.txt", colon):
        assert (bits.parse_avg_size_any(str(path))
                == jbits.parse_avg_size_any(str(path)))
    avg = {"intra_frame": 41.5, "flow_sparse_fwd": 0.9,
           "flow_sparse_bwd": 1.1, "dense_flow": 310.0}
    for g in (8, 4):
        assert bits.compute_bpp(avg, g) == jbits.compute_bpp(avg, g)
        assert (bits.compute_inter_bpp(avg, g)
                == jbits.compute_inter_bpp(avg, g))


def _video(n=10, seed=0):
    """Moving gradients with noise: JPEG-friendly but not flat."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([yy, xx, (yy + xx) / 2], -1).astype(np.float32)
    base = base / base.max() * 200 + 20
    frames = [np.roll(base, 2 * t, axis=1) + rng.normal(0, 4, base.shape)
              for t in range(n)]
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


def _flows(n, seed):
    return {t: _flow(seed + t) for t in range(n)}


def _encode(mod, cfg_mod, frames, out, mode):
    n = frames.shape[0]
    return mod.encode_video(frames, str(out),
                            cfg_mod.CodecConfig(gop_size=4,
                                                flow_rate_mode=mode),
                            flows_fwd=_flows(n, 10), flows_bwd=_flows(n, 30),
                            sparse_bg_ratio=40 / (H * W))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("mode", ["none", "sparse", "dense"])
def test_encode_video_files_match_jax(tmp_path, mode):
    frames = _video()
    enc = _encode(runner, config, frames, tmp_path / "port", mode)
    jenc = _encode(jrunner, jconfig, frames, tmp_path / "jax", mode)
    assert enc.meta == jenc.meta
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    n_flow_files = 0 if mode == "none" else 2 * (7 + 1)  # + the reports
    assert len(got) == 1 + 3 * 2 + 1 + n_flow_files
    for name in got:
        assert got[name] == want[name], name


def _standin_jax(cond, flow):
    c, f = cond.astype(jnp.float32), flow.astype(jnp.float32)
    x = c[..., :3] + c[..., 3:] - 1.0 + f[..., :1] * 0.25
    x = jnp.where(f[..., 1:2] > 2.5, jnp.inf, x)
    x = jnp.where(f[..., 1:2] < -2.5, -jnp.inf, x)
    return jnp.where(c[..., :1] < 0.1, jnp.nan, x)


def _standin_torch(cond, flow):
    c, f = cond.float(), flow.float()
    x = c[..., :3] + c[..., 3:] - 1.0 + f[..., :1] * 0.25
    x = torch.where(f[..., 1:2] > 2.5, torch.inf, x)
    x = torch.where(f[..., 1:2] < -2.5, -torch.inf, x)
    return torch.where(c[..., :1] < 0.1, torch.nan, x)


def _densify(sparse, mask, anchor):
    return sparse * 2 + anchor[..., :2] - mask[..., :2] * 0.5


@pytest.mark.parametrize("mode,fetch,dtype,max_batch", [
    ("dense", "device", "float32", 3),
    ("dense", "device", "bfloat16", 3),
    ("dense", "host", "float32", 3),
    ("dense", "device", "float32", 0),
    ("sparse", "device", "float32", 4),
    ("sparse", "host", "bfloat16", 7),
    ("none", "device", "float32", 5),
])
def test_decode_video_matches_jax(tmp_path, mode, fetch, dtype, max_batch):
    """10 frames, GOP 4: anchors 0, 4 and 8; 7 inter frames (the last one,
    9, takes itself as its next anchor), so max_batch 3 gives chunks of 3,
    3 and 1 padded to 3; max_batch 0 decodes all 7 in one call."""
    frames = _video()
    enc = _encode(runner, config, frames, tmp_path / "port", mode)
    jenc = _encode(jrunner, jconfig, frames, tmp_path / "jax", mode)
    calls = []

    def port_fn(cond, flow):
        assert cond.dtype == flow.dtype == getattr(torch, dtype)
        calls.append(cond.shape[0])
        out = _standin_torch(cond, flow)
        return out.numpy() if fetch == "host" else out

    def jax_fn(cond, flow):
        out = _standin_jax(cond, flow)
        return np.asarray(out) if fetch == "host" else out

    densify = _densify if mode == "sparse" else None
    got = runner.decode_video(enc, port_fn, densify, max_batch,
                              getattr(torch, dtype), device="cpu")
    want = jrunner.decode_video(jenc, jax_fn, densify, max_batch,
                                getattr(jnp, dtype))
    assert got.dtype == np.uint8 and got.shape == frames.shape
    np.testing.assert_array_equal(got, want)
    step = max_batch or 7
    assert calls == [step] * -(-7 // step)
    inter = got[[1, 2, 3, 5, 6, 7, 9]]
    assert (inter == 0).any()                          # NaN (and -inf)
    assert mode == "none" or (inter == 255).any()      # +inf: flow > 2.5


def test_decode_inter_frames_keeps_its_input(tmp_path):
    """The PIL-free half of decode_video: anchors read by the caller pass
    through unchanged and the input array is not written."""
    frames = _video()
    enc = _encode(runner, config, frames, tmp_path / "enc", "dense")
    anchors = np.zeros_like(frames)
    anchors[[0, 4, 8]] = frames[[0, 4, 8]]
    before = anchors.copy()
    out = runner.decode_inter_frames(anchors, enc, _standin_torch,
                                     max_batch=3, device="cpu")
    np.testing.assert_array_equal(anchors, before)
    np.testing.assert_array_equal(out[[0, 4, 8]], frames[[0, 4, 8]])
    assert (out[[1, 2, 3, 5, 6, 7, 9]] > 0).any()
