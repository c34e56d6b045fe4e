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

Like the JAX package, the walk covers the soup's first ceil(count / 128)
blocks. On the card a CUDA kernel
(``csrc/rt_brute.cu``) reads the count on the device, so a frame never
waits for the card; on the CPU the plain version reads it on the host (a
free read there) and also skips blocks without a live triangle, which hit
nothing, so the planes are the same either way.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from renderer_tpu_torch.mathx.camera import _cross3
from renderer_tpu_torch.ops.cuda_build import check_inputs, library
from renderer_tpu_torch.ops.raster_scan import live_blocks

BLOCK = 128  # triangles per step, as in the JAX package
STEP_PAIRS = 1 << 23  # (receiver, triangle) pairs per step of the plain version
EPS = 1e-3  # receiver offset along its normal, and the least hit distance

LIBRARY = library("rt_brute.cu")
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
RT_BRUTE = LIBRARY.kernel("rtt_rt_brute", [_PTR] * 6 + [_I32] * 3 + [_PTR])


class RtBrute(NamedTuple):
    """What shading needs to trace one frame's shadows by brute force."""

    tri_world: torch.Tensor  # (T, 3, 3) world-space corners of the camera's soup
    tri_valid: torch.Tensor  # (T,)
    light_casts: tuple       # (shadow_slot, directional) per shaded light, -1 none
    n_slots: int             # shadow slots
    rt_scale: int            # trace every rt_scale-th receiver in x and y
    count: torch.Tensor = None  # the soup's count (0-dim int32), None: every block


class BruteInputs(NamedTuple):
    """What the walk reads: the receivers' offset origins and the
    per-triangle setup, padded to whole blocks."""

    origin: torch.Tensor  # (3, P) f32 receivers, offset by EPS along their normals
    cvec: torch.Tensor    # (T, 3 quantities, 3) f32: d x e2, e1 x d, e1 x e2
    consts: torch.Tensor  # (T, 3) f32: their dots with v0
    f: torch.Tensor       # (T,) f32: 1 / e1.(d x e2), 0 where degenerate
    live: torch.Tensor    # (T,) bool: valid and not degenerate


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


def brute_inputs(world: torch.Tensor, normal: torch.Tensor, direction: torch.Tensor,
                 tri: torch.Tensor, tri_valid: torch.Tensor) -> BruteInputs:
    """The walk's inputs for receivers ``world`` (3, H, W) with normals
    ``normal`` under a directional light shining along ``direction`` (3,),
    against triangles ``tri`` (T, 3, 3) where ``tri_valid``."""
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
    cvec = torch.stack([c_u, c_v, c_t], dim=1)  # (T, 3 quantities, 3)
    consts = torch.stack([_dot(v0, c_u), _dot(v0, c_v), _dot(v0, c_t)], dim=1)  # (T, 3)
    origin = (world + normal * EPS).reshape(3, -1)
    return BruteInputs(origin.contiguous(), cvec.contiguous(), consts, f.contiguous(), live)


def rt_brute_plain(inp: BruteInputs, count) -> torch.Tensor:
    """The walk in PyTorch, on any device: (P,) lit factor (1 lit, 0
    occluded). Reads the count (a 0-dim tensor, an int, or None for every
    block) and the live blocks on the host."""
    origin, cvec, consts, f, live = inp
    t_cap, p = cvec.shape[0], origin.shape[1]
    n_live = live_blocks(count, t_cap, BLOCK)
    starts = [b for b, any_live in zip(range(0, n_live * BLOCK, BLOCK),
                                       live[:n_live * BLOCK].reshape(-1, BLOCK).any(dim=1).tolist())
              if any_live]
    chunk = max(1, STEP_PAIRS // BLOCK)
    lit = []
    for p0 in range(0, p, chunk):
        o = origin[:, p0:p0 + chunk, None, None]  # (3, P, 1, 1)
        occluded = torch.zeros(o.shape[1], dtype=torch.bool, device=origin.device)
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
    lit = torch.cat(lit) if lit else torch.zeros(0, dtype=torch.bool, device=origin.device)
    return torch.where(lit, 0.0, 1.0)


def kernel_design() -> dict:
    """The kernel's sizes, read from its library (built on first use): a
    CTA's tile of receivers, receivers per lane, warps per CTA, triangles
    per block."""
    out = (ctypes.c_int * 5)()
    LIBRARY.load().rtt_rt_brute_design(out)
    tx, ty, per_lane, warps, block = out
    return dict(tile=(tx, ty), receivers_per_lane=per_lane, warps=warps, block=block)


def rt_brute_kernel(inp: BruteInputs, count, width: int) -> torch.Tensor:
    """Same arguments and result as ``rt_brute_plain``; CUDA tensors only.
    The count (a 0-dim int32 tensor on the card, or None) is read by the
    kernel on the device. ``width``: the receivers per row of their image
    (the kernel walks tiles of it). ``RT_BRUTE.launches`` counts the
    launches."""
    origin, cvec, consts, f, live = inp
    t_cap, p = cvec.shape[0], origin.shape[1]
    index = check_inputs(
        "brute-force rt",
        (origin, torch.float32, (3, p)),
        (cvec, torch.float32, (t_cap, 3, 3)),
        (consts, torch.float32, (t_cap, 3)),
        (f, torch.float32, (t_cap,)),
        (live, torch.bool, (t_cap,)),
        *(() if count is None else ((count, torch.int32, ()),)),
    )
    if live.data_ptr() % 16:
        raise ValueError("brute-force rt kernel input: the live mask must be 16-byte aligned")
    if width < 1 or p % width:
        raise ValueError(f"brute-force rt kernel input: {p} receivers are not rows of {width}")
    lit = torch.empty((p,), dtype=torch.float32, device=origin.device)
    RT_BRUTE.launch(index, origin.data_ptr(), cvec.data_ptr(), consts.data_ptr(), f.data_ptr(),
                    live.data_ptr(), None if count is None else count.data_ptr(), t_cap, p,
                    width, lit.data_ptr())
    return lit


def ray_shadow_directional(world: torch.Tensor, normal: torch.Tensor, direction: torch.Tensor,
                           tri: torch.Tensor, tri_valid: torch.Tensor, count=None) -> torch.Tensor:
    """(1, H, W) lit factor (1 lit, 0 shadowed: hard shadows) of receivers
    ``world`` (3, H, W) with geometric normals ``normal`` (3, H, W) under a
    directional light shining along ``direction`` (3,), against the
    triangles ``tri`` (T, 3, 3) where ``tri_valid``, walking the blocks
    below ceil(count / 128) (every block when ``count`` is None). Rays
    leave each receiver, offset by EPS along its normal, towards the
    light. The kernel on the card, the plain version on the CPU."""
    h, w = world.shape[1:]
    inp = brute_inputs(world, normal, direction, tri, tri_valid)
    if world.is_cuda:
        lit = rt_brute_kernel(inp, count, w)
    elif world.device.type == "cpu":
        lit = rt_brute_plain(inp, count)
    else:
        raise ValueError(f"no brute-force rt kernel for device {world.device}")
    return lit.reshape(1, h, w)


def rt_shadow_planes(world: torch.Tensor, normal: torch.Tensor, lights, tri: torch.Tensor,
                     tri_valid: torch.Tensor, slots: tuple, rt_scale: int = 2,
                     count=None) -> list:
    """Per shadow slot, the (H, W) lit plane of its light, traced at every
    rt_scale-th receiver in x and y and repeated back up.

    ``slots``: per slot (light index, directional) or None (the static
    light-cast pattern, ``rt_grid.slot_lights``). A slot without a
    directional light (none, or a point light, which the brute force does
    not trace, as in the JAX package) is a plane of ones and costs no
    device work. ``count``: the soup's count, which bounds every walk
    (None: every block)."""
    s = rt_scale
    w_ds, n_ds = world[:, ::s, ::s], normal[:, ::s, ::s]
    h, w = world.shape[1:]
    ones = torch.ones((), dtype=torch.float32, device=world.device).expand(h, w)
    planes = []
    for slot in slots:
        if slot is None or not slot[1]:
            planes.append(ones)
            continue
        occ = ray_shadow_directional(w_ds, n_ds, lights.position[slot[0]], tri, tri_valid,
                                     count)[0]
        if s > 1:
            occ = occ.repeat_interleave(s, 0).repeat_interleave(s, 1)
        planes.append(occ[:h, :w])
    return planes
