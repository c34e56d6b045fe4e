"""Image input, output and comparison (``renderer_tpu.utils.image``): PNG
writing and reading and a Pillow-exact bilinear resize with the standard
library and numpy only, the sRGB encode, and PSNR."""

from __future__ import annotations

import math
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
    """Read a non-interlaced PNG file (``decode_png``)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# channels per colour type: grey, RGB, palette (indices), grey+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG (a palette image also at 1, 2 or 4
    bits) -> (H, W, C) uint8: C is 1 for grey, 2 for grey+alpha, 3 for RGB
    and 4 for RGBA; a palette image comes back as RGB, or RGBA when it has
    a tRNS chunk.

    The scanline filters are undone along anti-diagonals: a byte depends on
    its left, upper and upper-left neighbours only, so the pixels with
    x + y = d all depend on earlier diagonals, and each diagonal is one
    vectorized step (numpy) in any mix of filter types."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, header, palette, trns = 8, [], None, None, None
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    packed = color_type == 3 and depth in (1, 2, 4)  # palette indices below a byte
    if (depth != 8 and not packed) or color_type not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"only 8-bit (palette: 1-8 bit) non-interlaced PNGs are read, got bit "
                         f"depth {depth}, colour type {color_type}, interlace {interlace}")
    c = _PNG_CHANNELS[color_type]
    # the filters work on bytes: a packed row is its bytes, one channel
    wb = -(-w * depth // 8) if packed else w
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + wb * c)
    filters = raw[:, 0].astype(np.int64)
    if filters.max(initial=0) > 4:
        raise ValueError(f"unknown scanline filter {filters.max()}")
    coded = raw[:, 1:].reshape(h, wb, c).astype(np.int64)
    out = np.zeros((h + 1, wb + 1, c), np.int64)  # a zero row above and column left
    for d in range(h + wb - 1):
        ys = np.arange(max(0, d - wb + 1), min(h, d + 1))
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
    px = out[1:, 1:].astype(np.uint8)
    if packed:  # most significant bits first
        px = np.unpackbits(px, axis=1).reshape(h, -1, depth)[:, :w]
        px = (px.astype(np.uint8) << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            axis=-1, dtype=np.uint8)[..., None]
    if color_type != 3:
        return px
    if palette is None:
        raise ValueError("palette image without a PLTE chunk")
    index = px[..., 0]
    if index.max(initial=0) >= len(palette):
        raise ValueError("palette index out of range")
    if trns is None:
        return palette[index]
    alpha = np.full(len(palette), 255, np.uint8)
    alpha[:len(trns)] = trns[:len(palette)]
    return np.concatenate([palette[index], alpha[index][..., None]], axis=-1)


def as_rgba(img: np.ndarray) -> np.ndarray:
    """(H, W) or (H, W, 1|2|3|4) uint8 -> (H, W, 4) uint8: grey spreads to
    RGB, a missing alpha is 255 (Pillow's ``convert("RGBA")``)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[-1]
    rgb = img[..., :1].repeat(3, axis=-1) if c <= 2 else img[..., :3]
    alpha = img[..., c - 1:] if c in (2, 4) else np.full(img.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


_PRECISION_BITS = 22  # Pillow's fixed-point coefficients (32 - 8 - 2 bits)


def _bilinear_taps(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for its BILINEAR filter, then
    ``normalize_coeffs_8bpc``: per output pixel the first input pixel and
    the fixed-point weights of its taps (zero past the tap count), as
    ((out, K) int64 source indices, (out, K) int64 weights). Double
    arithmetic in Pillow's order, the weight sum accumulated tap by tap."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    ss = 1.0 / filterscale
    weights = np.zeros((out_size, ksize))
    for x in range(ksize):
        arg = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        weights[:, x] = np.where(x < xmax, np.where(arg < 1.0, 1.0 - arg, 0.0), 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):
        ww = ww + weights[:, x]
    weights = np.where(ww[:, None] != 0.0, weights / np.where(ww == 0.0, 1.0, ww)[:, None],
                       weights)
    fixed = weights * (1 << _PRECISION_BITS)
    fixed = np.where(weights < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed)).astype(np.int64)
    index = np.minimum(xmin[:, None] + np.arange(ksize)[None, :], in_size - 1)
    return index, fixed


def _resample_axis0(img: np.ndarray, out_size: int) -> np.ndarray:
    """Pillow's 8-bit resampling pass along axis 0 of (n, m, C) uint8: sums
    start at half a unit and clip to [0, 255] after the shift."""
    index, fixed = _bilinear_taps(img.shape[0], out_size)
    acc = np.full((out_size,) + img.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    src = img.astype(np.int64)
    for x in range(index.shape[1]):
        acc += src[index[:, x]] * fixed[:, x].reshape((-1,) + (1,) * (img.ndim - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """Pillow's ``Image.resize(size, BILINEAR)`` on an (H, W) or (H, W, C)
    uint8 image, bit for bit; ``size`` is (width, height) as in Pillow.

    Pillow resamples horizontally, then vertically, each pass rounding to
    8 bits, with a triangle filter whose support widens with the downscale
    factor. An RGBA (or grey+alpha) image is resampled premultiplied:
    Pillow converts it to ``RGBa`` first and back after, so colours round
    twice, as here."""
    img = np.asarray(img, np.uint8)
    width, height = int(size[0]), int(size[1])
    if img.shape[:2] == (height, width):
        return img.copy()
    flat = img[..., None] if img.ndim == 2 else img
    alpha = flat.shape[-1] in (2, 4)
    if alpha:  # RGBA -> RGBa: c * a / 255, rounded as Pillow's MULDIV255
        a = flat[..., -1:].astype(np.int64)
        t = flat[..., :-1].astype(np.int64) * a + 128
        flat = np.concatenate([((t >> 8) + t) >> 8, a], axis=-1).astype(np.uint8)
    if flat.shape[1] != width:
        flat = _resample_axis0(flat.transpose(1, 0, 2), width).transpose(1, 0, 2)
    if flat.shape[0] != height:
        flat = _resample_axis0(flat, height)
    if alpha:  # RGBa -> RGBA: c * 255 // a, clipped, where 0 < a < 255
        a = flat[..., -1:].astype(np.int64)
        c = flat[..., :-1].astype(np.int64)
        un = np.clip(255 * c // np.maximum(a, 1), 0, 255)
        flat = np.concatenate([np.where((a == 0) | (a == 255), c, un), a],
                              axis=-1).astype(np.uint8)
    return flat[..., 0] if img.ndim == 2 else flat


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """PSNR in dB between float images in [0,1] (or matching scale)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
