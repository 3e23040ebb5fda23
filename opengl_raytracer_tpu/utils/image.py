"""Image output & comparison utilities.

The reference displays by blitting the RGBA32F accumulation FBO to the
8-bit default framebuffer (clamped unorm conversion, main.py:397-399) and
saves a PNG on exit (main.py:432-439).  Here: explicit conversion, and an
8-bit RGB PNG writer and reader on the standard library's ``zlib``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Linear float image -> 8-bit, GL-style clamp + round."""
    return np.round(np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def save_png(path: str, img: np.ndarray) -> None:
    """Save (H, W, 3) float or uint8 image (top row first) as PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    h, w, _ = arr.shape
    # Filter type 0 (None) on every scanline.
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, 3 * w)],
                         axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def load_png(path: str) -> np.ndarray:
    """Load an 8-bit RGB PNG as written by :func:`save_png` (unfiltered
    scanlines) as (H, W, 3) float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"{path!r} is not a PNG file")
    pos, idat, header = len(_PNG_SIG), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"unsupported PNG format in {path!r}: bit depth "
                         f"{depth}, color type {color}, interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path!r} uses PNG scanline filters; only "
                         f"unfiltered images are supported")
    return rows[:, 1:].reshape(h, w, 3).astype(np.float32) / 255.0


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between two float images."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
