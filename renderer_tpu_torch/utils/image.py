"""Image output and comparison (``renderer_tpu.utils.image``): PNG writing
and reading with the standard library and numpy only, the sRGB encode,
and PSNR."""

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


def srgb_encode(linear: np.ndarray) -> np.ndarray:
    """Linear -> sRGB transfer function, after a clamp to [0, 1]."""
    linear = np.clip(np.asarray(linear, np.float32), 0.0, 1.0)
    return np.where(linear <= 0.0031308, linear * 12.92,
                    1.055 * np.power(linear, 1.0 / 2.4) - 0.055)


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


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA non-interlaced PNG -> (H, W, 3|4) uint8.

    The scanline filters are undone along anti-diagonals: a byte depends on
    its left, upper and upper-left neighbours only, so the pixels with
    x + y = d all depend on earlier diagonals, and each diagonal is one
    vectorized step (numpy) in any mix of filter types."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in (2, 6) or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are read, got "
                         f"bit depth {depth}, colour type {color_type}, interlace {interlace}")
    c = 3 if color_type == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    filters = raw[:, 0].astype(np.int64)
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown scanline filter {filters.max()}")
    coded = raw[:, 1:].reshape(h, w, c).astype(np.int64)
    out = np.zeros((h + 1, w + 1, c), np.int64)  # a zero row above and column left
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = out[ys + 1, xs]   # left
        b = out[ys, xs + 1]   # up
        ul = out[ys, xs]      # upper left
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = np.select([filters[ys, None] == k for k in (1, 2, 3, 4)],
                         [a, b, (a + b) // 2, paeth], 0)
        out[ys + 1, xs + 1] = (coded[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB between float images in [0,1] (or matching scale)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
