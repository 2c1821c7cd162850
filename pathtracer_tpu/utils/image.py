"""Image IO and comparison metrics.

Replaces the reference's Canvas2D ``putImageData`` display path
(``src/program-raymarch.ts:295-318``) with PNG files written from the host.
The reference parses an ``output`` path from the INI but never writes it
(``parse-ini.ts:39``); here the CLI actually honors it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0, ~] -> uint8 with clamping (Uint8ClampedArray)."""
    return np.clip(np.asarray(img) * 255.0, 0.0, 255.0).astype(np.uint8)


def encode_png(image_u8: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W, 3] image (8-bit RGB, no filtering),
    written with the standard library alone."""
    h, w, _ = image_u8.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), image_u8.reshape(h, w * 3)], axis=1
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] float (linear, post-tonemap) image as PNG."""
    arr = img if img.dtype == np.uint8 else to_uint8(img)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(arr)))


def read_png(path: str) -> np.ndarray:
    """Read a PNG into an [H, W, 3] float array in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32)
    return arr / 255.0


def mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared error between two [H, W, 3] float images in [0, 1]."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return float(np.mean((a - b) ** 2))
