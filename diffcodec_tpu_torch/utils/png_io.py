"""8-bit RGB PNG files written and read with `zlib` and `struct` alone.

The validation panels of the ControlNet trainer (`train/validation.py`) are
PNG files, as the JAX package writes them through PIL; the card's machine
has no PIL, so the port writes them itself: one IHDR (8-bit RGB, no
interlace), one IDAT of zlib-compressed scanlines, each with filter type 0
(none), and IEND.  Any PNG decoder reads them.  `read_png` reads back
exactly this form (filter 0 on every row) and refuses others.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """The PNG bytes of an [H, W, 3] uint8 image."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {image.dtype} "
                         f"{image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> int:
    """Write an [H, W, 3] uint8 image as `path`; returns the bytes."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3] uint8 of PNG bytes in `encode_png`'s form (8-bit RGB, no
    interlace, filter 0 on every scanline); checks every chunk's CRC."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"not an 8-bit RGB PNG without interlace: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("a scanline uses a PNG filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
