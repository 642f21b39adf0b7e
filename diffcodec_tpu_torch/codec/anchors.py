"""Classical codec anchors via external binaries (ffmpeg x264/x265, vvenc).

Copied from `diffcodec_tpu/codec/anchors.py`: the subprocess drivers
and their log parsers (`eval.codec_eval` reads `parse_intra_inter_storage`).

Parity targets: `test.sh` (H.264/HEVC encode at target bpp, keyint=GOP,
scenecut off, ffprobe per-frame pkt_size/pict_type split into intra/inter
bytes), `vcc_test.sh` / `vvc_decode.sh` (VVC).  These remain subprocess
drivers — the anchors are not ML and the reference also shells out.

All functions raise RuntimeError with a clear message when the binary is
missing (zero-egress CI has no ffmpeg), and are exercised in tests through
the pure-python log parsers below.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
from typing import Dict, List, Tuple


def _require(binary: str):
    path = shutil.which(binary)
    if path is None:
        raise RuntimeError(
            f"{binary!r} not found; classical anchors require it "
            f"(see test.sh in the reference for the recipe)")
    return path


def bpp_to_bitrate(bpp: float, width: int, height: int, fps: float) -> int:
    """Target bitrate in bits/sec from bpp (`test.sh:23-25` formula)."""
    return int(bpp * width * height * fps)


def encode_x26x(frames_glob: str, out_path: str, codec: str, bpp: float,
                width: int, height: int, fps: float, gop: int,
                num_frames: int = 96) -> None:
    """Encode PNG frames with libx264/libx265 at a target bpp with fixed
    keyframe interval (`test.sh:27-38`)."""
    assert codec in ("libx264", "libx265")
    ffmpeg = _require("ffmpeg")
    bitrate = bpp_to_bitrate(bpp, width, height, fps)
    args = [ffmpeg, "-y", "-framerate", str(fps), "-i", frames_glob,
            "-frames:v", str(num_frames), "-c:v", codec,
            "-b:v", str(bitrate), "-pix_fmt", "yuv420p"]
    if codec == "libx264":
        args += ["-g", str(gop), "-keyint_min", str(gop), "-sc_threshold",
                 "0"]
    else:
        args += ["-x265-params",
                 f"keyint={gop}:min-keyint={gop}:scenecut=0:"
                 f"bitrate={bitrate // 1000}"]
    args.append(out_path)
    subprocess.run(args, check=True, capture_output=True)


def decode_to_frames(video_path: str, out_dir: str) -> None:
    """Decode to PNG frames (`test.sh:56`)."""
    ffmpeg = _require("ffmpeg")
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run([ffmpeg, "-y", "-i", video_path,
                    os.path.join(out_dir, "frame_%04d.png")],
                   check=True, capture_output=True)


def probe_frame_sizes(video_path: str) -> List[Tuple[str, int]]:
    """[(pict_type, pkt_size)] per frame via ffprobe (`test.sh:41-42`)."""
    ffprobe = _require("ffprobe")
    out = subprocess.run(
        [ffprobe, "-v", "error", "-select_streams", "v:0", "-show_entries",
         "frame=pkt_size,pict_type", "-of", "json", video_path],
        check=True, capture_output=True, text=True)
    frames = json.loads(out.stdout).get("frames", [])
    return [(f.get("pict_type", "?"), int(f.get("pkt_size", 0)))
            for f in frames]


def split_intra_inter_bytes(frame_sizes: List[Tuple[str, int]]
                            ) -> Dict[str, int]:
    """I vs P/B byte split (`test.sh:45-52` awk logic)."""
    intra = sum(s for t, s in frame_sizes if t == "I")
    inter = sum(s for t, s in frame_sizes if t != "I")
    return {"intra_bytes": intra, "inter_bytes": inter,
            "total_bytes": intra + inter}


def write_intra_inter_storage(path: str, split: Dict[str, int]) -> None:
    """The `intra_inter_storage.txt` consumed by
    `classical_codec_eval.py:104-127`."""
    with open(path, "w") as f:
        f.write(f"intra_bytes: {split['intra_bytes']}\n")
        f.write(f"inter_bytes: {split['inter_bytes']}\n")
        f.write(f"total_bytes: {split['total_bytes']}\n")


def parse_intra_inter_storage(path: str) -> Dict[str, int]:
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"(\w+):\s*(\d+)", line.strip())
            if m:
                out[m.group(1)] = int(m.group(2))
    return out


# ---------------------------------------------------------------------------
# VVC (vvenc/vvdec) — `vcc_test.sh`, `vvc_decode.sh`
# ---------------------------------------------------------------------------

def encode_vvenc(yuv_path: str, out_path: str, bpp: float, width: int,
                 height: int, fps: float, gop: int, num_frames: int = 97,
                 preset: str = "medium") -> None:
    """VVC-encode a raw YUV420p file via ffmpeg's libvvenc
    (`vcc_test.sh:40-50` loop body: rawvideo input geometry, -preset
    medium, -g GOP, bitrate from the bpp formula, .vvc bitstream out)."""
    ffmpeg = _require("ffmpeg")
    bitrate = bpp_to_bitrate(bpp, width, height, fps)
    subprocess.run(
        [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "yuv420p",
         "-s:v", f"{width}x{height}", "-r", str(fps), "-i", yuv_path,
         "-frames:v", str(num_frames), "-c:v", "libvvenc",
         "-preset", preset, "-g", str(gop), "-b:v", str(bitrate), out_path],
        check=True, capture_output=True)

_POC_BITS_RE = re.compile(r"POC\s+(\d+).*?(\d+)\s+bits", re.IGNORECASE)
_SLICE_RE = re.compile(r"\b([IPB])-?SLICE\b|\(\s*([IPB])[\s,)]",
                       re.IGNORECASE)


def parse_vvdec_poc_log(log_text: str) -> List[Tuple[int, str, int]]:
    """Parse vvdec per-POC log lines -> [(poc, slice_type, bits)]
    (`vvc_decode.sh:40-66` byte accounting).  Handles both
    '( CRA, I-SLICE, QP .. )' and bare '( I ...)' slice annotations."""
    out = []
    for line in log_text.splitlines():
        m = _POC_BITS_RE.search(line)
        if not m:
            continue
        sm = _SLICE_RE.search(line)
        if not sm:
            continue
        slice_type = (sm.group(1) or sm.group(2)).upper()
        out.append((int(m.group(1)), slice_type, int(m.group(2))))
    return out


def split_vvc_intra_inter(poc_entries: List[Tuple[int, str, int]]
                          ) -> Dict[str, int]:
    intra_bits = sum(b for _, t, b in poc_entries if t == "I")
    inter_bits = sum(b for _, t, b in poc_entries if t != "I")
    return {"intra_bytes": intra_bits // 8, "inter_bytes": inter_bits // 8,
            "total_bytes": (intra_bits + inter_bits) // 8}


# ---------------------------------------------------------------------------
# Chained per-operating-point drivers (the shell loop bodies)
# ---------------------------------------------------------------------------

def run_classical_anchor(frames_glob: str, out_dir: str, codec: str,
                         bpp: float, width: int, height: int, fps: float,
                         gop: int, num_frames: int = 96,
                         decode_frames: bool = True) -> Dict[str, int]:
    """One (video, bpp) operating point of the classical-anchor sweep:
    encode -> ffprobe per-frame sizes -> intra/inter byte split ->
    `intra_inter_storage.txt` -> (optionally) decode to PNG frames.

    Parity: the `test.sh:33-56` loop body.  Note the reference passes
    `-x265-params keyint=...` to a libx264 encode (test.sh:36-38), which
    x264 silently ignores — its H.264 anchors therefore run with default
    keyframe placement; `encode_x26x` sets the codec-appropriate keyint
    flags instead (`-g/-keyint_min/-sc_threshold` for x264).
    """
    os.makedirs(out_dir, exist_ok=True)
    video_path = os.path.join(out_dir, "output.mp4")
    encode_x26x(frames_glob, video_path, codec, bpp, width, height, fps,
                gop, num_frames)
    split = split_intra_inter_bytes(probe_frame_sizes(video_path))
    write_intra_inter_storage(
        os.path.join(out_dir, "intra_inter_storage.txt"), split)
    if decode_frames:
        decode_to_frames(video_path, os.path.join(out_dir, "decoded"))
    return split


def decode_vvc(vvc_path: str, out_dir: str, width: int, height: int,
               vvdec_binary: str = "vvdecapp",
               extract_frames: bool = True) -> Dict[str, int]:
    """One VVC bitstream of the `vvc_decode.sh:36-66` loop: vvdec to YUV
    (capturing the per-POC log), truncate the YUV to the decoded frame
    count (vvdec can over-emit), split intra/inter bits from the log,
    write `intra_inter_storage.txt`, and (optionally) extract PNG frames
    with ffmpeg.

    The reference script sums the `[DT ..]` decode-time column as "bytes"
    (vvc_decode.sh:57-62) — a units bug; this driver sums the per-POC bit
    counts from the same log lines (`parse_vvdec_poc_log`).
    """
    vvdec = _require(vvdec_binary)
    os.makedirs(out_dir, exist_ok=True)
    yuv_path = os.path.join(out_dir, "output_decoded.yuv")
    log_path = os.path.join(out_dir, "vvdec_log.txt")
    with open(log_path, "w") as log_f:
        subprocess.run([vvdec, "-b", vvc_path, "-o", yuv_path],
                       check=True, stdout=log_f, stderr=subprocess.STDOUT)
    with open(log_path) as f:
        entries = parse_vvdec_poc_log(f.read())
    # truncate to the decoded frame count (YUV420p: 1.5 bytes/pixel)
    frame_bytes = width * height * 3 // 2
    want = len(entries) * frame_bytes
    if os.path.exists(yuv_path) and os.path.getsize(yuv_path) > want:
        with open(yuv_path, "r+b") as f:
            f.truncate(want)
    split = split_vvc_intra_inter(entries)
    write_intra_inter_storage(
        os.path.join(out_dir, "intra_inter_storage.txt"), split)
    if extract_frames:
        ffmpeg = _require("ffmpeg")
        subprocess.run(
            [ffmpeg, "-y", "-s:v", f"{width}x{height}", "-pix_fmt",
             "yuv420p", "-i", yuv_path,
             os.path.join(out_dir, "f%03d.png")],
            check=True, capture_output=True)
    return split
