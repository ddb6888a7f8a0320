"""Image output helpers (PNG encode of RGBA u8 frames).

The reference encodes PNGs with the Rust ``image`` crate
(src/lib.rs:330-333, src/terrain/mod.rs:487-490). The port writes them with
a small stdlib encoder (``zlib`` + ``struct``): 8-bit RGBA, no interlace,
filter type 0 on every row. The output is a deterministic function of the
pixel bytes and needs neither Pillow nor the JAX package's native core.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def png_encode_rgba(img: np.ndarray) -> bytes:
    """(H, W, 4) uint8 RGBA -> PNG file bytes."""
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)  # 8-bit RGBA
    rows = np.zeros((h, 1 + 4 * w), dtype=np.uint8)      # filter byte 0
    rows[:, 1:] = img.reshape(h, 4 * w)
    idat = zlib.compress(rows.tobytes(), 6)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def save_png_rgba(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 4) uint8 RGBA array as a PNG file."""
    img = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    if img.ndim != 3 or img.shape[2] != 4:
        raise RuntimeError("Invalid image buffer")
    data = png_encode_rgba(img)
    with open(path, "wb") as f:
        f.write(data)
