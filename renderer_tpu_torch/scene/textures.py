"""Texture atlas: one packed mip pyramid for every texture layer
(``renderer_tpu.scene.textures``).

Every texture is resampled to a layer size S (a power of two). Mip level l
holds all L layers at size s_l = S >> l, packed level-major:

    texel(l, layer, y, x) = packed[off_l + (layer * s_l + y) * s_l + x]

so a sampler finds any texel by index arithmetic. The JAX package also
builds per-texel quad tables, a TPU gather layout; the port samples tap by
tap from ``packed_u32`` (the same taps and weights) and does not build them.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from renderer_tpu_torch.utils.image import resize_bilinear_u8


class TextureAtlas(NamedTuple):
    """Device-side atlas. ``packed_u32`` holds R | G<<8 | B<<16 | A<<24 per
    texel; torch keeps the bits in an int32 tensor (channels unpack with
    shifts and masks, which read the same bits)."""

    packed_u32: torch.Tensor    # (total_texels,) int32 holding uint32 bits
    level_offset: torch.Tensor  # (n_levels,) i32 texel offsets
    level_size: torch.Tensor    # (n_levels,) i32 s_l
    n_layers: torch.Tensor      # () i32 committed layers

    @property
    def num_levels(self) -> int:
        return self.level_size.shape[0]


def _box_downsample(img: np.ndarray) -> np.ndarray:
    """(h, w, 4) u8 -> (h/2, w/2, 4) u8 box filter in float."""
    h, w, c = img.shape
    f = img.astype(np.float32).reshape(h // 2, 2, w // 2, 2, c).mean(axis=(1, 3))
    return np.clip(np.round(f), 0, 255).astype(np.uint8)


def build_mips(img: np.ndarray, min_size: int = 4) -> list:
    """Mip chain from (S, S, 4) u8 down to min_size (4x4: the JAX package's
    chain length, so level counts and offsets agree)."""
    mips = [img]
    while mips[-1].shape[0] > min_size:
        mips.append(_box_downsample(mips[-1]))
    return mips


class TextureAtlasBuilder:
    """Host-side accumulator; inputs become (size, size) RGBA u8 layers."""

    def __init__(self, size: int = 256, max_layers: int = 64):
        if size & (size - 1):
            raise ValueError("atlas layer size must be a power of two")
        self.size = size
        self.max_layers = max_layers
        self.layers: list[np.ndarray] = []

    def add(self, img: np.ndarray) -> int:
        """Add an (h, w, 3|4) uint8/float image; returns its layer index."""
        if len(self.layers) >= self.max_layers:
            raise ValueError("texture atlas full")
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1
            )
        if img.shape[:2] != (self.size, self.size):  # Pillow's BILINEAR, bit for bit
            img = resize_bilinear_u8(img, (self.size, self.size))
        self.layers.append(img)
        return len(self.layers) - 1

    def build(self, preallocate: int = None) -> SimpleNamespace:
        """Host tables of the atlas (numpy). ``preallocate=N`` reserves N
        white layer slots, as the JAX builder does for texture streaming."""
        layers = list(self.layers) or [np.full((self.size, self.size, 4), 255, np.uint8)]
        n_real = len(self.layers)
        if preallocate is not None:
            while len(layers) < preallocate:
                layers.append(np.full((self.size, self.size, 4), 255, np.uint8))
        n = len(layers)
        chains = [build_mips(img) for img in layers]
        packed_parts, offsets, sizes = [], [], []
        off = 0
        for l in range(len(chains[0])):
            s = self.size >> l
            offsets.append(off)
            sizes.append(s)
            packed_parts.append(np.stack([c[l] for c in chains]).reshape(-1, 4))
            off += n * s * s
        packed = np.concatenate(packed_parts, axis=0).astype(np.uint32)
        p32 = packed[:, 0] | (packed[:, 1] << 8) | (packed[:, 2] << 16) | (packed[:, 3] << 24)
        return SimpleNamespace(
            packed_u32=p32,
            level_offset=np.asarray(offsets, np.int32),
            level_size=np.asarray(sizes, np.int32),
            n_layers=np.int32(n_real),
        )
