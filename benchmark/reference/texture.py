"""Frozen copy of the port's ``renderer_tpu_torch/ops/texture.py`` (the benchmark's plain
reference; it imports nothing of the port, and the port may change
without it). What follows is the original's docstring.

Texture sampling from the packed mip atlas, channel-first
(``renderer_tpu.ops.texture``).

Each bilinear tap reads one packed RGBA word; channels unpack with shifts
and masks. Wrap mode: repeat. This is the JAX package's per-tap path
(``_bilinear``), which gives the same taps and weights as its quad-table
path.
"""

from __future__ import annotations

import torch



def _level_geom(atlas: TextureAtlas, level: torch.Tensor):
    """(size, offset) of a per-pixel level array in closed form: the
    builder packs level l at size S >> l with all layer slots, level-major,
    so offset(l) = n_slots * 4 * (S^2 - s_l^2) / 3."""
    s0 = atlas.level_size[0].long()
    size = s0 >> level
    if atlas.num_levels == 1:
        return size, torch.zeros_like(level)
    n_slots = atlas.level_offset[1].long() // (s0 * s0)
    return size, n_slots * (((s0 * s0 - size * size) * 4) // 3)


def _fetch_rgba(atlas: TextureAtlas, size, off, layer, x, y) -> torch.Tensor:
    """Integer texel fetch -> (4, ...) f32 in [0, 1]; x, y pre-wrapped."""
    word = atlas.packed_u32[off + (layer * size + y) * size + x]
    return torch.stack(
        [(word & 0xFF).float(), ((word >> 8) & 0xFF).float(),
         ((word >> 16) & 0xFF).float(), ((word >> 24) & 0xFF).float()],
        dim=0,
    ) * (1.0 / 255.0)


def _bilinear(atlas: TextureAtlas, level, layer, u, v) -> torch.Tensor:
    """level/layer/u/v: (...,) tensors; u, v in [0, 1). Returns (4, ...)."""
    size, off = _level_geom(atlas, level)
    fs = size.float()
    tx = u * fs - 0.5
    ty = v * fs - 0.5
    x0f = torch.floor(tx)
    y0f = torch.floor(ty)
    fx = tx - x0f
    fy = ty - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    m = size - 1  # power-of-two repeat wrap
    t00 = _fetch_rgba(atlas, size, off, layer, x0 & m, y0 & m)
    t10 = _fetch_rgba(atlas, size, off, layer, (x0 + 1) & m, y0 & m)
    t01 = _fetch_rgba(atlas, size, off, layer, x0 & m, (y0 + 1) & m)
    t11 = _fetch_rgba(atlas, size, off, layer, (x0 + 1) & m, (y0 + 1) & m)
    return (
        t00 * ((1 - fx) * (1 - fy))[None]
        + t10 * (fx * (1 - fy))[None]
        + t01 * ((1 - fx) * fy)[None]
        + t11 * (fx * fy)[None]
    )


def sample_atlas_cf(atlas: TextureAtlas, layer, u, v, lod=None,
                    trilinear: bool = True) -> torch.Tensor:
    """Channel-first RGBA sample -> (4, ...). layer < 0 returns white.
    lod None samples mip 0; trilinear=False takes the nearest-below mip."""
    n_levels = atlas.num_levels
    layer = layer.long()
    safe_layer = torch.clamp(layer, min=0)
    uf = u - torch.floor(u)
    vf = v - torch.floor(v)
    if lod is None:
        out = _bilinear(atlas, torch.zeros_like(safe_layer), safe_layer, uf, vf)
    else:
        lod = torch.clamp(lod, 0.0, n_levels - 1.0)
        l0 = torch.floor(lod).long()
        out = _bilinear(atlas, l0, safe_layer, uf, vf)
        if trilinear:
            l1 = torch.clamp(l0 + 1, max=n_levels - 1)
            f = (lod - l0.float())[None]
            out = out * (1 - f) + _bilinear(atlas, l1, safe_layer, uf, vf) * f
    return torch.where((layer >= 0)[None], out, 1.0)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """glTF base-color textures are sRGB-encoded."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
