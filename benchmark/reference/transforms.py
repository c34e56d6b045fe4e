"""Frozen copy of the port's ``renderer_tpu_torch/mathx/transforms.py`` (the benchmark's plain
reference; it imports nothing of the port, and the port may change
without it). What follows is the original's docstring.

Quaternions (``renderer_tpu.mathx.transforms``), float32 torch.

Quaternions are ``(w, x, y, z)``. All functions accept leading batch dims.
"""

from __future__ import annotations

import torch


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

