"""The 2D overlay (``renderer_tpu.ops.overlay``): a fixed-capacity table of
glyphs and rectangles alpha-blended onto the linear frame, the HUD's
text panel. Glyphs come from a 5x7 bitmap font atlas built once on the
host.

The tables are host numpy: the HUD text is made on the host between
frames. ``compose_overlay`` copies what it needs to the card from pinned
memory without blocking, and blends glyphs in order where they overlap
(the JAX package blends one glyph after another).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_GLYPHS = 1024
MAX_RECTS = 32
CELL_W, CELL_H = 6, 8  # a 5x7 glyph and 1 pixel of spacing

# 5x7 bitmap font, 5-bit rows (MSB = leftmost pixel)
_F = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "0": (0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110),
    "1": (0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "2": (0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0b01000, 0b11111),
    "3": (0b11111, 0b00010, 0b00100, 0b00010, 0b00001, 0b10001, 0b01110),
    "4": (0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010),
    "5": (0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110),
    "6": (0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110),
    "7": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000),
    "8": (0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110),
    "9": (0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100),
    "A": (0b01110, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "B": (0b11110, 0b10001, 0b10001, 0b11110, 0b10001, 0b10001, 0b11110),
    "C": (0b01110, 0b10001, 0b10000, 0b10000, 0b10000, 0b10001, 0b01110),
    "D": (0b11100, 0b10010, 0b10001, 0b10001, 0b10001, 0b10010, 0b11100),
    "E": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b11111),
    "F": (0b11111, 0b10000, 0b10000, 0b11110, 0b10000, 0b10000, 0b10000),
    "G": (0b01110, 0b10001, 0b10000, 0b10111, 0b10001, 0b10001, 0b01111),
    "H": (0b10001, 0b10001, 0b10001, 0b11111, 0b10001, 0b10001, 0b10001),
    "I": (0b01110, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    "J": (0b00111, 0b00010, 0b00010, 0b00010, 0b00010, 0b10010, 0b01100),
    "K": (0b10001, 0b10010, 0b10100, 0b11000, 0b10100, 0b10010, 0b10001),
    "L": (0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b10000, 0b11111),
    "M": (0b10001, 0b11011, 0b10101, 0b10101, 0b10001, 0b10001, 0b10001),
    "N": (0b10001, 0b10001, 0b11001, 0b10101, 0b10011, 0b10001, 0b10001),
    "O": (0b01110, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "P": (0b11110, 0b10001, 0b10001, 0b11110, 0b10000, 0b10000, 0b10000),
    "Q": (0b01110, 0b10001, 0b10001, 0b10001, 0b10101, 0b10010, 0b01101),
    "R": (0b11110, 0b10001, 0b10001, 0b11110, 0b10100, 0b10010, 0b10001),
    "S": (0b01111, 0b10000, 0b10000, 0b01110, 0b00001, 0b00001, 0b11110),
    "T": (0b11111, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0b00100),
    "U": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01110),
    "V": (0b10001, 0b10001, 0b10001, 0b10001, 0b10001, 0b01010, 0b00100),
    "W": (0b10001, 0b10001, 0b10001, 0b10101, 0b10101, 0b10101, 0b01010),
    "X": (0b10001, 0b10001, 0b01010, 0b00100, 0b01010, 0b10001, 0b10001),
    "Y": (0b10001, 0b10001, 0b01010, 0b00100, 0b00100, 0b00100, 0b00100),
    "Z": (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0b11111),
    ".": (0, 0, 0, 0, 0, 0b00110, 0b00110),
    ",": (0, 0, 0, 0, 0b00110, 0b00100, 0b01000),
    ":": (0, 0b00110, 0b00110, 0, 0b00110, 0b00110, 0),
    ";": (0, 0b00110, 0b00110, 0, 0b00110, 0b00100, 0b01000),
    "-": (0, 0, 0, 0b11111, 0, 0, 0),
    "+": (0, 0b00100, 0b00100, 0b11111, 0b00100, 0b00100, 0),
    "/": (0b00001, 0b00001, 0b00010, 0b00100, 0b01000, 0b10000, 0b10000),
    "%": (0b11000, 0b11001, 0b00010, 0b00100, 0b01000, 0b10011, 0b00011),
    "(": (0b00010, 0b00100, 0b01000, 0b01000, 0b01000, 0b00100, 0b00010),
    ")": (0b01000, 0b00100, 0b00010, 0b00010, 0b00010, 0b00100, 0b01000),
    "=": (0, 0, 0b11111, 0, 0b11111, 0, 0),
    "_": (0, 0, 0, 0, 0, 0, 0b11111),
    "!": (0b00100, 0b00100, 0b00100, 0b00100, 0b00100, 0, 0b00100),
    "?": (0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0, 0b00100),
    "<": (0b00010, 0b00100, 0b01000, 0b10000, 0b01000, 0b00100, 0b00010),
    ">": (0b01000, 0b00100, 0b00010, 0b00001, 0b00010, 0b00100, 0b01000),
    "[": (0b01110, 0b01000, 0b01000, 0b01000, 0b01000, 0b01000, 0b01110),
    "]": (0b01110, 0b00010, 0b00010, 0b00010, 0b00010, 0b00010, 0b01110),
    "'": (0b00100, 0b00100, 0b01000, 0, 0, 0, 0),
    '"': (0b01010, 0b01010, 0b10100, 0, 0, 0, 0),
    "#": (0b01010, 0b01010, 0b11111, 0b01010, 0b11111, 0b01010, 0b01010),
    "*": (0, 0b00100, 0b10101, 0b01110, 0b10101, 0b00100, 0),
    "|": (0b00100,) * 7,
}

_CHARS = sorted(_F.keys())
_CHAR_INDEX = {c: i for i, c in enumerate(_CHARS)}


def build_font_atlas() -> np.ndarray:
    """(n_glyphs, CELL_H, CELL_W) f32 coverage atlas."""
    atlas = np.zeros((len(_CHARS), CELL_H, CELL_W), np.float32)
    for i, c in enumerate(_CHARS):
        for r, bits in enumerate(_F[c]):
            for k in range(5):
                if bits & (1 << (4 - k)):
                    atlas[i, r, k] = 1.0
    return atlas


def _glyph_id(ch: str) -> int:
    return _CHAR_INDEX.get(ch.upper(), _CHAR_INDEX["?"])


class Overlay(NamedTuple):
    """Fixed-capacity overlay tables (host numpy)."""

    glyph_pos: np.ndarray    # (G, 2) i32 top-left pixel (x, y)
    glyph_id: np.ndarray     # (G,) i32 font atlas index
    glyph_color: np.ndarray  # (G, 4) f32 rgba (linear)
    glyph_count: int
    rect: np.ndarray         # (R, 4) f32 x0, y0, x1, y1
    rect_color: np.ndarray   # (R, 4) f32 rgba
    rect_count: int

    @staticmethod
    def empty() -> "Overlay":
        return Overlay(
            glyph_pos=np.zeros((MAX_GLYPHS, 2), np.int32),
            glyph_id=np.zeros((MAX_GLYPHS,), np.int32),
            glyph_color=np.zeros((MAX_GLYPHS, 4), np.float32), glyph_count=0,
            rect=np.zeros((MAX_RECTS, 4), np.float32),
            rect_color=np.zeros((MAX_RECTS, 4), np.float32), rect_count=0,
        )


class OverlayBuilder:
    """Host-side accumulator of glyphs and rectangles."""

    def __init__(self):
        self._glyphs: list = []
        self._rects: list = []

    def rect(self, x0, y0, x1, y1, color=(0.0, 0.0, 0.0), alpha=0.6) -> "OverlayBuilder":
        if len(self._rects) >= MAX_RECTS:
            raise ValueError("overlay rect capacity exceeded")
        self._rects.append((float(x0), float(y0), float(x1), float(y1), (*color, float(alpha))))
        return self

    def text(self, x, y, s: str, color=(1.0, 1.0, 1.0), alpha=1.0) -> "OverlayBuilder":
        """Monospace text; a newline advances CELL_H + 2 pixels. Glyphs past
        the capacity are clipped."""
        cx, cy = int(x), int(y)
        for ch in s:
            if ch == "\n":
                cx, cy = int(x), cy + CELL_H + 2
                continue
            if len(self._glyphs) >= MAX_GLYPHS:
                break
            if ch != " ":
                self._glyphs.append((cx, cy, _glyph_id(ch), (*color, float(alpha))))
            cx += CELL_W
        return self

    def build(self) -> Overlay:
        o = Overlay.empty()
        for i, (x, y, c, rgba) in enumerate(self._glyphs):
            o.glyph_pos[i] = (x, y)
            o.glyph_id[i] = c
            o.glyph_color[i] = rgba
        for i, (x0, y0, x1, y1, rgba) in enumerate(self._rects):
            o.rect[i] = (x0, y0, x1, y1)
            o.rect_color[i] = rgba
        return o._replace(glyph_count=len(self._glyphs), rect_count=len(self._rects))


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; to the card from pinned memory without
    blocking."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def glyph_layers(overlay: Overlay, width: int, height: int) -> list:
    """The on-screen glyphs in layers, as lists of glyph indices: a glyph
    goes one layer above the highest earlier glyph its cell overlaps, so
    the glyphs of a layer never overlap and overlapping glyphs keep their
    order. Glyphs not wholly on screen are dropped (they blend nothing)."""
    layers, placed = [], []  # placed: (x, y, layer)
    for i in range(overlay.glyph_count):
        x, y = (int(v) for v in overlay.glyph_pos[i])
        if not (0 <= x <= width - CELL_W and 0 <= y <= height - CELL_H):
            continue
        layer = 1 + max((lv for px, py, lv in placed
                         if abs(px - x) < CELL_W and abs(py - y) < CELL_H), default=-1)
        placed.append((x, y, layer))
        if layer == len(layers):
            layers.append([])
        layers[layer].append(i)
    return layers


def compose_overlay(image: torch.Tensor, overlay: Overlay, font: torch.Tensor) -> torch.Tensor:
    """Alpha-blend the overlay onto a linear (H, W, 3) image: each rect in
    order over the whole plane, then the glyphs, one layer of
    non-overlapping glyph cells per step (``glyph_layers``), each cell
    blended as ``patch * (1 - a) + colour * a``. ``font`` is the atlas on
    the image's device."""
    h, w, _ = image.shape
    dev = image.device
    if overlay.rect_count:
        rect = host_to_device(overlay.rect[: overlay.rect_count], dev)
        rgba = host_to_device(overlay.rect_color[: overlay.rect_count], dev)
        yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
        xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
        for i in range(overlay.rect_count):
            inside = (xx >= rect[i, 0]) & (xx < rect[i, 2]) & (yy >= rect[i, 1]) & (yy < rect[i, 3])
            a = (rgba[i, 3] * inside.to(torch.float32))[..., None]
            image = image * (1 - a) + rgba[i, :3] * a
    layers = glyph_layers(overlay, w, h)
    if not layers:
        return image
    order = np.concatenate([np.asarray(layer, np.int64) for layer in layers])
    cy, cx = np.mgrid[0:CELL_H, 0:CELL_W]
    pix = ((overlay.glyph_pos[order, 1, None, None] + cy) * w
           + overlay.glyph_pos[order, 0, None, None] + cx).reshape(len(order), -1)
    pix_t = host_to_device(pix.astype(np.int64), dev)
    gid = host_to_device(overlay.glyph_id[order].astype(np.int64), dev)
    rgba = host_to_device(overlay.glyph_color[order], dev)
    a = font[gid].reshape(len(order), -1, 1) * rgba[:, None, 3:4]  # (G, cell, 1)
    flat = image.reshape(h * w, 3)
    start = 0
    for layer in layers:
        sl = slice(start, start + len(layer))
        start += len(layer)
        idx = pix_t[sl].reshape(-1)
        patch = flat[idx].reshape(len(layer), -1, 3)
        blended = patch * (1 - a[sl]) + rgba[sl, None, :3] * a[sl]
        flat = flat.index_copy(0, idx, blended.reshape(-1, 3))
    return flat.reshape(h, w, 3)


def hud_overlay(lines: str, width: int) -> Overlay:
    """The HUD panel: a translucent backdrop and the text block at top left."""
    b = OverlayBuilder()
    rows = lines.split("\n")
    panel_w = min(width - 8, 8 + CELL_W * max((len(r) for r in rows), default=0))
    panel_h = 8 + (CELL_H + 2) * len(rows)
    b.rect(4, 4, 4 + panel_w, 4 + panel_h, color=(0.02, 0.02, 0.03), alpha=0.65)
    b.text(8, 8, lines, color=(0.9, 0.95, 1.0))
    return b.build()
