"""Exact ray-traced shadows by brute force (``renderer_tpu.ops.rt``): the
plain configuration's ``rt`` switch.

For a ray of direction d from a receiver o, Möller–Trumbore with s = o - v0
gives u = f s.(d x e2), v = f s.(e1 x d) and t = f s.(e1 x e2), f =
1 / e1.(d x e2). For a directional light d is the same for every ray, so
the three vectors of each triangle and their dots with v0 are set up once
and every (receiver, triangle) pair costs three dot products. The pairs
are walked in steps of a (receiver chunk, 128-triangle block), so a
512x512 frame's temporaries stay small. The camera's culled soup is the
caster set (off-camera geometry does not occlude, as in the JAX package);
``ops/rt_grid.py`` is the light-space grid that the tile configuration
traces instead.

On the card every block of the soup is walked, so nothing is read on the
host (the JAX package bounds its loop by the soup's count). On the CPU,
where a host read costs no wait, blocks without a live triangle are
skipped; they hit nothing, so the planes are the same either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from renderer_tpu_torch.mathx.camera import _cross3

BLOCK = 128  # triangles per step, as in the JAX package
STEP_PAIRS = 1 << 23  # (receiver, triangle) pairs per step
EPS = 1e-3  # receiver offset along its normal, and the least hit distance


class RtBrute(NamedTuple):
    """What shading needs to trace one frame's shadows by brute force."""

    tri_world: torch.Tensor  # (T, 3, 3) world-space corners of the camera's soup
    tri_valid: torch.Tensor  # (T,)
    light_casts: tuple       # (shadow_slot, directional) per shaded light, -1 none
    n_slots: int             # shadow slots
    rt_scale: int            # trace every rt_scale-th receiver in x and y


def triangles_world(soup_clip: torch.Tensor, viewproj_inv: torch.Tensor) -> torch.Tensor:
    """Clip corners (T, 3, 4) -> world corners (T, 3, 3) through the
    inverse viewproj (the soup stores no world positions)."""
    m = viewproj_inv
    c = [soup_clip[..., k] for k in range(4)]
    w = [m[i, 0] * c[0] + m[i, 1] * c[1] + m[i, 2] * c[2] + m[i, 3] * c[3] for i in range(4)]
    ww = torch.where(w[3].abs() > 1e-12, w[3], 1e-12)
    return torch.stack([w[0] / ww, w[1] / ww, w[2] / ww], dim=-1)


def _dot(a, b):
    """(..., 3) . (..., 3), summed ((x0 + x1) + x2)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_shadow_directional(world: torch.Tensor, normal: torch.Tensor, direction: torch.Tensor,
                           tri: torch.Tensor, tri_valid: torch.Tensor) -> torch.Tensor:
    """(1, H, W) lit factor (1 lit, 0 shadowed: hard shadows) of receivers
    ``world`` (3, H, W) with geometric normals ``normal`` (3, H, W) under a
    directional light shining along ``direction`` (3,), against the
    triangles ``tri`` (T, 3, 3) where ``tri_valid``. Rays leave each
    receiver, offset by EPS along its normal, towards the light."""
    t_cap = tri.shape[0]
    pad = (-t_cap) % BLOCK
    if pad:
        tri = torch.cat([tri, tri.new_zeros((pad, 3, 3))])
        tri_valid = torch.cat([tri_valid, tri_valid.new_zeros((pad,))])
    d = -direction / torch.clamp(torch.sqrt(_dot(direction, direction)), min=1e-8)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    dd = d.expand(e2.shape)
    c_u = _cross3(dd, e2)  # d x e2
    c_v = _cross3(e1, dd)  # e1 x d
    c_t = _cross3(e1, e2)
    a = _dot(e1, c_u)
    f = torch.where(a.abs() > 1e-12, 1.0 / torch.where(a.abs() > 1e-12, a, 1.0), 0.0)
    live = tri_valid & (a.abs() > 1e-12)
    # per triangle: the 3 vectors (9 columns), their dots with v0, f, live
    cvec = torch.stack([c_u, c_v, c_t], dim=1)  # (T, 3 quantities, 3)
    consts = torch.stack([_dot(v0, c_u), _dot(v0, c_v), _dot(v0, c_t)], dim=1)  # (T, 3)

    h, w = world.shape[1:]
    p = h * w
    origin = (world + normal * EPS).reshape(3, p)
    starts = range(0, t_cap + pad, BLOCK)
    if tri.device.type == "cpu":  # skip blocks without a live triangle (a free host read)
        starts = [b for b, any_live in zip(starts, live.reshape(-1, BLOCK).any(dim=1).tolist())
                  if any_live]
    chunk = max(1, STEP_PAIRS // BLOCK)
    lit = []
    for p0 in range(0, p, chunk):
        o = origin[:, p0:p0 + chunk, None, None]  # (3, P, 1, 1)
        occluded = torch.zeros(o.shape[1], dtype=torch.bool, device=world.device)
        for b0 in starts:
            sl = slice(b0, b0 + BLOCK)
            cv = cvec[sl]  # (B, 3, 3)
            # every s-dot of the chunk at once: o . c - v0 . c, (P, B, 3)
            s = o[0] * cv[..., 0] + o[1] * cv[..., 1] + o[2] * cv[..., 2] - consts[sl]
            fb = f[sl]
            u, v, t = s[..., 0] * fb, s[..., 1] * fb, s[..., 2] * fb
            hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS) & live[sl]
            occluded = occluded | hit.any(dim=1)
        lit.append(occluded)
    lit = torch.cat(lit) if lit else torch.zeros(0, dtype=torch.bool, device=world.device)
    return torch.where(lit.reshape(1, h, w), 0.0, 1.0)


def rt_shadow_planes(world: torch.Tensor, normal: torch.Tensor, lights, tri: torch.Tensor,
                     tri_valid: torch.Tensor, slots: tuple, rt_scale: int = 2) -> list:
    """Per shadow slot, the (H, W) lit plane of its light, traced at every
    rt_scale-th receiver in x and y and repeated back up.

    ``slots``: per slot (light index, directional) or None (the static
    light-cast pattern, ``rt_grid.slot_lights``). A slot without a
    directional light (none, or a point light, which the brute force does
    not trace, as in the JAX package) is a plane of ones and costs no
    device work."""
    s = rt_scale
    w_ds, n_ds = world[:, ::s, ::s], normal[:, ::s, ::s]
    h, w = world.shape[1:]
    ones = torch.ones((), dtype=torch.float32, device=world.device).expand(h, w)
    planes = []
    for slot in slots:
        if slot is None or not slot[1]:
            planes.append(ones)
            continue
        occ = ray_shadow_directional(w_ds, n_ds, lights.position[slot[0]], tri, tri_valid)[0]
        if s > 1:
            occ = occ.repeat_interleave(s, 0).repeat_interleave(s, 1)
        planes.append(occ[:h, :w])
    return planes
