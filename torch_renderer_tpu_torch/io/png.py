"""An 8-bit PNG writer from the standard library (zlib, struct), so that
saving an image needs no imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}   # channels -> gray, RGB, RGBA


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write uint8 pixels, (H, W) gray or (H, W, C) with C in {1, 3, 4},
    as an 8-bit PNG (every row unfiltered)."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1|3|4) pixels, "
                         f"got {a.shape}")
    H, W, C = a.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), a.reshape(H, W * C)],
                          axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8,
                                           _COLOR_TYPE[C], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
