"""The safetensors file format, read and written with numpy and torch only.

The card's machine has no `safetensors` package, and the JAX package reads
and writes checkpoints through it (`safetensors.numpy.load_file` /
`save_file`).  A file is an 8-byte little-endian header length N, N bytes
of JSON (each tensor's `dtype`, `shape` and `data_offsets` [begin, end)
into the data that follows, and an optional `__metadata__` of strings),
then the tensors' raw little-endian bytes.

`load_file` maps the file copy-on-write and returns tensors that are views
of the mapping: no second host copy is made, and a page is read when a
tensor's bytes are first touched (copied to a module or to the card).
BF16 has no numpy dtype; every tensor is read through `torch.frombuffer`.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# the dtypes SD, CLIP and the metric networks' checkpoints hold
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}
_NAMES = {v: k for k, v in DTYPES.items()}
# a header larger than this is refused (the library's own limit)
MAX_HEADER = 100_000_000


def _parse(path: str) -> Tuple[Dict, mmap.mmap, int]:
    """(header, copy-on-write mapping of the file, offset of the data)."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a header")
        f.seek(0)
        (n,) = struct.unpack("<Q", f.read(8))
        if n > min(size - 8, MAX_HEADER):
            raise ValueError(f"{path}: header of {n} bytes in a file of "
                             f"{size}")
        try:
            header = json.loads(f.read(n).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: header is not JSON: {e}") from None
        if not isinstance(header, dict):
            raise ValueError(f"{path}: header is not a JSON object")
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    data_len = size - 8 - n
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if not isinstance(info, dict):
            raise ValueError(f"{path}: {name}: entry is not an object")
        dtype, shape = info.get("dtype"), info.get("shape")
        begin, end = info.get("data_offsets", (None, None))
        if dtype not in DTYPES:
            raise ValueError(f"{path}: {name}: unknown dtype {dtype!r}")
        if not (isinstance(shape, list)
                and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{path}: {name}: bad shape {shape!r}")
        if not (isinstance(begin, int) and isinstance(end, int)
                and 0 <= begin <= end):
            raise ValueError(f"{path}: {name}: bad offsets {begin}, {end}")
        if end > data_len:
            raise ValueError(f"{path}: {name}: bytes [{begin}, {end}) past "
                             f"the {data_len} bytes of data (truncated?)")
        want = math.prod(shape) * DTYPES[dtype].itemsize
        if end - begin != want:
            raise ValueError(f"{path}: {name}: {end - begin} bytes for "
                             f"{dtype} {shape} ({want} expected)")
    return header, mapped, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file; each tensor a view of the
    file's copy-on-write mapping (writing to one writes to no file)."""
    header, mapped, start = _parse(path)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // dtype.itemsize
        if count == 0:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        flat = torch.frombuffer(mapped, dtype=dtype, count=count,
                                offset=start + begin)
        out[name] = flat.view(info["shape"])
    return out


def load_metadata(path: str) -> Optional[Dict[str, str]]:
    """The file's `__metadata__`, or None."""
    return _parse(path)[0].get("__metadata__")


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    arr = np.asarray(value)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return torch.from_numpy(np.ascontiguousarray(arr))


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write {name: tensor or array} (on any device) as a safetensors file
    and return the bytes written.  Tensors are laid out by element size,
    largest first, then by name, so each starts aligned to its element
    size; each is copied to the host on its own as it is written."""
    if metadata is not None and not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in metadata.items()):
        raise ValueError("metadata must map strings to strings")
    items = {name: _as_tensor(v) for name, v in tensors.items()}
    for name, t in items.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
    order = sorted(items, key=lambda k: (-items[k].dtype.itemsize, k))
    header, offset = {}, 0
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    for name in order:
        t = items[name]
        nbytes = t.numel() * t.dtype.itemsize
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-(8 + len(raw)) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = items[name].reshape(-1)
            if t.numel():
                f.write(t.to("cpu").contiguous().view(torch.uint8).numpy()
                        .data)
    return 8 + len(raw) + offset
