"""End-to-end video codec: encode (anchors + flow bits) and decode
(diffusion).

Counterpart: `diffcodec_tpu/codec/runner.py`.  I-frames are stored as JPEG
anchors; inter frames carry only flow bits (mode 'none' nothing, 'sparse'
CMP-decodable point lists, 'dense' full fields) and are regenerated at
decode time by the ControlNet-conditioned pipeline, batched over the inter
frames.  The bitstream's layout and bytes are the JAX package's:
  {out}/intra/frame_%04d.jpg            anchor JPEGs (and a .png of each
                                        decoded anchor)
  {out}/intra/compression_report.txt
  {out}/flow_fwd/flow_%04d.sfl          sparse (or .dfl dense) bitstreams
  {out}/flow_fwd/compression_report.txt
  {out}/flow_bwd/...
  {out}/meta.json

PIL is imported inside the functions that read or write JPEGs, as in the
JAX package: the card's machine has none.  `decode_video` reads the
anchors with it and hands everything after that read to
`decode_inter_frames`, which needs no PIL.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from diffcodec_tpu_torch.codec.bits import (decode_sparse_flow,
                                            encode_sparse_flow,
                                            write_compression_report)
from diffcodec_tpu_torch.codec.gop import (batch_gop_conditions,
                                           get_intra_frames, gop_schedule)
from diffcodec_tpu_torch.codec.sparse_flow import flow_sampler
from diffcodec_tpu_torch.config import CodecConfig
from diffcodec_tpu_torch.sampling.tiled import unit_from_uint8


def encode_dense_flow(flow: np.ndarray) -> bytes:
    """Dense-mode flow payload: float16 + zlib (the reference stores
    compressed dense RAFT flow; sizes tracked via the report)."""
    H, W = flow.shape[:2]
    header = np.asarray([H, W], "<u4").tobytes()
    return header + zlib.compress(flow.astype("<f2").tobytes(), 6)


def decode_dense_flow(data: bytes) -> np.ndarray:
    H, W = np.frombuffer(data[:8], "<u4")
    raw = zlib.decompress(data[8:])
    return np.frombuffer(raw, "<f2").astype(np.float32).reshape(H, W, 2)


def _jpeg_roundtrip(frame_u8: np.ndarray, quality: int):
    """JPEG-encode one frame; returns (decoded uint8 frame, nbytes)."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame_u8).save(buf, format="JPEG", quality=quality)
    nbytes = buf.tell()
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB")), nbytes


@dataclasses.dataclass
class EncodedVideo:
    path: str
    meta: Dict

    @classmethod
    def load(cls, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            return cls(path=path, meta=json.load(f))


def encode_flows(out_dir: str, schedule, flows_fwd: Dict[int, np.ndarray],
                 flows_bwd: Dict[int, np.ndarray], mode: str,
                 sparse_strategy=("watershed", "grid"),
                 sparse_bg_ratio: float = 130.0 / (1080 * 1920)
                 ) -> Dict[str, Dict[int, int]]:
    """The inter frames' flow bitstreams ('sparse' point lists or 'dense'
    fields) and their reports, written under {out_dir}/flow_{fwd,bwd}/;
    returns the bytes of each, {direction: {target: nbytes}}.  Needs no
    PIL: `encode_video` without the anchors."""
    rng = np.random.default_rng(0)
    flow_bytes = {"fwd": {}, "bwd": {}}
    for direction, flows in (("fwd", flows_fwd), ("bwd", flows_bwd)):
        fdir = os.path.join(out_dir, f"flow_{direction}")
        os.makedirs(fdir, exist_ok=True)
        report = {}
        for item in schedule:
            flow = flows[item.target]
            if mode == "sparse":
                sparse, mask = flow_sampler(
                    flow, strategy=sparse_strategy,
                    bg_ratio=sparse_bg_ratio, rng=rng)
                data = encode_sparse_flow(sparse, mask)
                ext = "sfl"
            else:
                data = encode_dense_flow(flow)
                ext = "dfl"
            name = f"flow_{item.target:04d}.{ext}"
            with open(os.path.join(fdir, name), "wb") as f:
                f.write(data)
            report[name] = len(data)
            flow_bytes[direction][item.target] = len(data)
        write_compression_report(
            os.path.join(fdir, "compression_report.txt"), report)
    return flow_bytes


def encode_video(frames: np.ndarray, out_dir: str,
                 cfg: CodecConfig = CodecConfig(),
                 flows_fwd: Optional[Dict[int, np.ndarray]] = None,
                 flows_bwd: Optional[Dict[int, np.ndarray]] = None,
                 intra_quality: int = 30,
                 sparse_strategy=("watershed", "grid"),
                 sparse_bg_ratio: float = 130.0 / (1080 * 1920)
                 ) -> EncodedVideo:
    """Encode [N, H, W, 3] uint8 frames.

    flows_* map inter-frame index -> [H, W, 2] flow (fwd: prev anchor ->
    target, bwd: next anchor -> target).  Required for the 'sparse' and
    'dense' modes; the flow estimator (RAFT in the reference) is an input,
    not part of the codec.
    """
    from PIL import Image
    N, H, W = frames.shape[:3]
    os.makedirs(out_dir, exist_ok=True)
    intra_dir = os.path.join(out_dir, "intra")
    os.makedirs(intra_dir, exist_ok=True)
    schedule = gop_schedule(N, cfg.gop_size)

    intra_report = {}
    for i in get_intra_frames(N, cfg.gop_size):
        decoded, nbytes = _jpeg_roundtrip(frames[i], intra_quality)
        Image.fromarray(decoded).save(
            os.path.join(intra_dir, f"frame_{i:04d}.png"))
        # the JPEG itself is the payload
        Image.fromarray(frames[i]).save(
            os.path.join(intra_dir, f"frame_{i:04d}.jpg"),
            quality=intra_quality)
        intra_report[f"frame_{i:04d}.jpg"] = nbytes
    write_compression_report(os.path.join(intra_dir,
                                          "compression_report.txt"),
                             intra_report)

    flow_bytes = {"fwd": {}, "bwd": {}}
    if cfg.flow_rate_mode != "none":
        if flows_fwd is None or flows_bwd is None:
            raise ValueError(
                f"flow_rate_mode={cfg.flow_rate_mode!r} requires flows")
        flow_bytes = encode_flows(out_dir, schedule, flows_fwd, flows_bwd,
                                  cfg.flow_rate_mode, sparse_strategy,
                                  sparse_bg_ratio)

    total_pixels = N * H * W
    intra_bits = sum(intra_report.values()) * 8
    flow_bits = sum(sum(d.values()) for d in flow_bytes.values()) * 8
    meta = {
        "num_frames": N, "height": H, "width": W,
        "gop_size": cfg.gop_size, "flow_rate_mode": cfg.flow_rate_mode,
        "intra_quality": intra_quality,
        "bpp": {
            "intra": intra_bits / total_pixels,
            "flow": flow_bits / total_pixels,
            "total": (intra_bits + flow_bits) / total_pixels,
        },
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return EncodedVideo(path=out_dir, meta=meta)


def make_cmp_densifier(cmp_model: torch.nn.Module, device="cuda"):
    """CMP network -> `decode_video`'s densify_fn, run on `device` in
    fp32: the 4-channel sparse input (flow + mask, `cmp/models/modules/
    shallownet.py`'s input convention) and the anchor go up, the dense
    flow comes back to the host."""
    cmp_model = cmp_model.to(device=device, dtype=torch.float32).eval()

    @torch.no_grad()
    def densify_fn(sparse: np.ndarray, mask: np.ndarray,
                   anchor: np.ndarray) -> np.ndarray:
        inp = np.concatenate(
            [sparse, mask[..., :2].astype(np.float32)], axis=-1)
        out = cmp_model(
            torch.as_tensor(anchor[None], dtype=torch.float32).to(device),
            torch.as_tensor(inp[None], dtype=torch.float32).to(device))
        return out[0].cpu().numpy()

    return densify_fn


def _read_flows(enc: EncodedVideo, frames: np.ndarray, schedule,
                densify_fn: Optional[Callable]):
    """Each inter frame's forward and backward flow [H, W, 2] from the
    bitstream: zero ('none'), the sparse field densified against its
    anchor ('sparse'; as sent where densify_fn is None) or the dense
    field ('dense')."""
    meta = enc.meta
    H, W, mode = meta["height"], meta["width"], meta["flow_rate_mode"]
    flows_fwd, flows_bwd = {}, {}
    for item in schedule:
        for direction, store in (("fwd", flows_fwd), ("bwd", flows_bwd)):
            if mode == "none":
                store[item.target] = np.zeros((H, W, 2), np.float32)
                continue
            fdir = os.path.join(enc.path, f"flow_{direction}")
            ext = "sfl" if mode == "sparse" else "dfl"
            with open(os.path.join(
                    fdir, f"flow_{item.target:04d}.{ext}"), "rb") as f:
                data = f.read()
            if mode == "sparse":
                sparse, mask = decode_sparse_flow(data)
                anchor = item.anchor_prev if direction == "fwd" else \
                    item.anchor_next
                if densify_fn is not None:
                    store[item.target] = densify_fn(
                        sparse, mask,
                        frames[anchor].astype(np.float32) / 255.0)
                else:
                    store[item.target] = sparse
            else:
                store[item.target] = decode_dense_flow(data)
    return flows_fwd, flows_bwd


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 on the tensor's device, in the JAX package's order:
    nan_to_num, then (x + 1) * 127.5 clipped to [0, 255], then a truncating
    cast (one byte a pixel to fetch)."""
    x = torch.nan_to_num(x.float(), nan=-1.0, posinf=1.0, neginf=-1.0)
    return ((x + 1.0) * 127.5).clamp(0.0, 255.0).to(torch.uint8)


def decode_inter_frames(anchors_u8: np.ndarray, enc: EncodedVideo,
                        sample_fn: Callable, densify_fn: Optional[Callable]
                        = None, max_batch: int = 7,
                        transfer_dtype: Optional[torch.dtype] = None,
                        device="cuda") -> np.ndarray:
    """Regenerate the inter frames of `enc` around its decoded anchors.

    anchors_u8: [N, H, W, 3] uint8 whose intra frames hold the decoded
    anchors (the other frames are not read).  Returns a copy with every
    inter frame filled in.  sample_fn(cond [B, H, W, 6] in [0, 1], flow
    [B, H, W, 4] px) -> [B, H, W, 3] in [-1, 1]: tensors on `device` in
    `transfer_dtype` (float32 where None) go in; a tensor on the device or
    a numpy array (a sampler that already fetched, such as
    `sample_tiled`) comes out.  densify_fn(sparse [H, W, 2], mask
    [H, W, 2], anchor [H, W, 3] in [0, 1]) -> [H, W, 2]: the CMP for the
    'sparse' mode (None keeps the sparse field).  max_batch: inter frames
    a sampler call; a short last chunk is padded to it with copies of its
    last frame, so the sampler sees two batch shapes at most.
    """
    meta = enc.meta
    out = np.array(anchors_u8, dtype=np.uint8, copy=True)
    schedule = gop_schedule(meta["num_frames"], meta["gop_size"])
    if not schedule:
        return out
    flows_fwd, flows_bwd = _read_flows(enc, out, schedule, densify_fn)

    # the conditioning stays uint8 on the way up (anchors are uint8 at the
    # source) and is normalised on the device in the transfer dtype
    batch = batch_gop_conditions(out, flows_fwd, flows_bwd, schedule)
    n = batch["cond"].shape[0]
    decoded_u8 = np.zeros((n,) + out.shape[1:], np.uint8)
    step = max_batch if max_batch and max_batch > 0 else n
    dtype = transfer_dtype or torch.float32
    cond_all = torch.from_numpy(batch["cond"]).to(device)
    flow_all = torch.from_numpy(batch["flow"]).to(dtype).to(device)

    def dispatch(s0):
        end = min(s0 + step, n)
        cond_c = unit_from_uint8(cond_all[s0:end], dtype)
        flow_c = flow_all[s0:end]
        nb = end - s0
        if nb < step and s0 > 0:
            # pad the tail to the steady batch shape
            pad = step - nb
            cond_c = torch.cat([cond_c] + [cond_c[-1:]] * pad)
            flow_c = torch.cat([flow_c] + [flow_c[-1:]] * pad)
        dev = sample_fn(cond_c, flow_c)
        if isinstance(dev, np.ndarray):
            return slice(s0, end), nb, dev, None
        # queue the conversion and the copy to the host behind the chunk
        u8 = _to_u8(dev)
        host = torch.empty(u8.shape, dtype=torch.uint8,
                           pin_memory=u8.is_cuda)
        host.copy_(u8, non_blocking=True)
        done = None
        if u8.is_cuda:
            done = torch.cuda.Event()
            done.record()
        return slice(s0, end), nb, host, done

    def drain(pending):
        sl, nb, res, done = pending
        if isinstance(res, np.ndarray):
            # the sampler fetched to the host already: convert there
            dec = np.nan_to_num(res.astype(np.float32)[:nb],
                                nan=-1.0, posinf=1.0, neginf=-1.0)
            decoded_u8[sl] = np.clip((dec + 1) * 127.5, 0,
                                     255).astype(np.uint8)
            return
        if done is not None:
            done.synchronize()
        decoded_u8[sl] = res.numpy()[:nb]

    # two-deep software pipeline: chunk i + 1 is dispatched before chunk i
    # is fetched, so the device runs the next chunk while the host drains
    # the last one; at most two decoded chunks are live
    pending = None
    for s0 in range(0, n, step):
        nxt = dispatch(s0)
        if pending is not None:
            drain(pending)
        pending = nxt
    if pending is not None:
        drain(pending)
    for k, item in enumerate(schedule):
        out[item.target] = decoded_u8[k]
    return out


def decode_video(enc: EncodedVideo,
                 sample_fn: Callable,
                 densify_fn: Optional[Callable] = None,
                 max_batch: int = 7,
                 transfer_dtype: Optional[torch.dtype] = None,
                 device="cuda") -> np.ndarray:
    """Decode to [N, H, W, 3] uint8: the JPEG anchors read with PIL on the
    host, then `decode_inter_frames` (see there for sample_fn, densify_fn,
    max_batch and transfer_dtype; pass the pipeline's compute dtype, such
    as torch.bfloat16, to halve the bytes uploaded)."""
    from PIL import Image
    meta = enc.meta
    N, H, W = meta["num_frames"], meta["height"], meta["width"]
    out = np.zeros((N, H, W, 3), np.uint8)
    intra_dir = os.path.join(enc.path, "intra")
    for i in get_intra_frames(N, meta["gop_size"]):
        out[i] = np.asarray(Image.open(
            os.path.join(intra_dir, f"frame_{i:04d}.jpg")).convert("RGB"))
    return decode_inter_frames(out, enc, sample_fn, densify_fn, max_batch,
                               transfer_dtype, device)
