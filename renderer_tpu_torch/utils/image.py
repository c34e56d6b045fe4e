"""Image output and comparison (``renderer_tpu.utils.image``): PNG writing
with the standard library only, and PSNR."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """Float [0,1] (H,W,3|4) -> uint8, with rounding."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(np.round(np.asarray(img, np.float32) * 255.0), 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) RGB or (H, W, 4) RGBA image as an 8-bit PNG."""
    px = to_u8(img)
    h, w, c = px.shape
    color_type = {3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB between float images in [0,1] (or matching scale)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
