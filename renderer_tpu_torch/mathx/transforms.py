"""Quaternions (``renderer_tpu.mathx.transforms``), float32 torch.

Quaternions are ``(w, x, y, z)``. All functions accept leading batch dims.
"""

from __future__ import annotations

import math

import torch

from renderer_tpu_torch.device import resolve_device


def quat_from_axis_angle(axis, angle, device=None) -> torch.Tensor:
    """Unit quaternion rotating ``angle`` radians about ``axis``, on
    ``device`` (the CUDA card when None)."""
    axis = torch.as_tensor(axis, dtype=torch.float32, device=resolve_device(device))
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = float(angle) / 2.0
    w = torch.full(axis.shape[:-1] + (1,), math.cos(half), device=axis.device)
    return torch.cat([w, axis * math.sin(half)], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (b's rotation, then a's)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from a unit quaternion: (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def transform_aabb(m: torch.Tensor, aabb_min: torch.Tensor, aabb_max: torch.Tensor):
    """AABBs through affine maps, centre/extent form with the |linear| part
    (the exact bound): (..., 4, 4), (..., 3), (..., 3) -> (world min,
    world max), each (..., 3). The 3x3 products are column multiply-adds,
    summed left to right."""
    center = (aabb_min + aabb_max) * 0.5
    extent = (aabb_max - aabb_min) * 0.5
    lin = m[..., :3, :3]
    t = m[..., :3, 3]
    new_center = (lin[..., 0] * center[..., None, 0] + lin[..., 1] * center[..., None, 1]
                  + lin[..., 2] * center[..., None, 2] + t)
    a = lin.abs()
    new_extent = (a[..., 0] * extent[..., None, 0] + a[..., 1] * extent[..., None, 1]
                  + a[..., 2] * extent[..., None, 2])
    return new_center - new_extent, new_center + new_extent


def trs_matrix(translation: torch.Tensor, rotation: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """4x4 matrices T @ R @ S from (..., 3) translations, (..., 4)
    quaternions and (...,) uniform scales."""
    rs = quat_to_mat3(rotation) * scale[..., None, None]
    top = torch.cat([rs, translation[..., :, None]], dim=-1)  # (..., 3, 4)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
