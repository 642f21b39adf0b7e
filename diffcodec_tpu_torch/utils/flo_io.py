"""Middlebury .flo optical-flow file IO.

Copied from `diffcodec_tpu/utils/flo_io.py`.

Parity targets: `controlnet/utils.py:10-19` (float-magic variant),
`controlnet/dataset.py:15-24` (byte-magic 'PIEH' variant — same format, the
magic float 202021.25 is the little-endian interpretation of b'PIEH'), and the
writer `cmp/utils/flowlib.py:25-41`.
"""

from __future__ import annotations

import numpy as np

_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file -> [H, W, 2] float32 flow in pixel units."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)
        if magic.size == 0 or magic[0] != _MAGIC:
            raise ValueError(f"invalid .flo file {path!r}: bad magic")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h)
        if data.size != 2 * w * h:
            raise ValueError(f"invalid .flo file {path!r}: truncated payload")
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write [H, W, 2] float32 flow to a .flo file."""
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)
