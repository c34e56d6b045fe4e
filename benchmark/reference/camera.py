"""Frozen copy of the port's ``renderer_tpu_torch/mathx/camera.py`` (the benchmark's plain
reference; it imports nothing of the port, and the port may change
without it). What follows is the original's docstring.

Camera, projection and frustum math (``renderer_tpu.mathx.camera``).

Depth convention: after the perspective divide z lies in [0, 1], near -> 0,
far -> 1 (Vulkan style). Every matrix is float32 on the camera's device.
The small products are written out term by term (no library matmul), so
the CPU and the card sum in the same order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.transforms import quat_to_mat3


class Camera(NamedTuple):
    """Pinhole camera. ``rotation`` is a (w,x,y,z) unit quaternion taking
    view-space axes into world space (camera forward is -Z)."""

    position: torch.Tensor  # (3,)
    rotation: torch.Tensor  # (4,)
    fov_y: torch.Tensor  # radians, scalar
    aspect: torch.Tensor  # width / height, scalar
    near: torch.Tensor
    far: torch.Tensor


def matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, k) @ (..., k, m) with the sum over k taken left to right."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


def _device_of(*values) -> torch.device:
    """The device of the first tensor among ``values`` (CPU if none)."""
    return next((v.device for v in values if isinstance(v, torch.Tensor)), torch.device("cpu"))


def _rows4(rows) -> torch.Tensor:
    """4x4 matrices from 16 broadcastable entries given row by row."""
    flat = [v for r in rows for v in r]
    shape = torch.broadcast_shapes(*(torch.as_tensor(v).shape for v in flat))
    device = _device_of(*flat)

    def entry(v):  # numbers become fills on the device, not host copies
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32).expand(shape)
        return torch.full(shape, float(v), dtype=torch.float32, device=device)

    return torch.stack([torch.stack([entry(v) for v in r], dim=-1) for r in rows], dim=-2)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def view_matrix(cam: Camera) -> torch.Tensor:
    """World -> view: the inverse of the camera's rigid transform."""
    rt = quat_to_mat3(cam.rotation).T  # world -> view
    t = -matmul4(rt, cam.position[:, None])[:, 0]
    top = torch.cat([rt, t[:, None]], dim=1)
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[:1])])  # [0, 0, 0, 1], on the device
    return torch.cat([top, bottom[None]], dim=0)


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """World -> view matrix looking from eye at target; (..., 3) inputs
    give (..., 4, 4)."""
    eye = torch.as_tensor(eye, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=eye.device)
    up = torch.as_tensor(up, dtype=torch.float32, device=eye.device)
    f = target - eye
    f = f / torch.sqrt(_dot3(f, f))[..., None]
    s = _cross3(f, up)
    s = s / torch.sqrt(_dot3(s, s))[..., None]
    u = _cross3(s, f)
    return _rows4([
        [s[..., 0], s[..., 1], s[..., 2], -_dot3(s, eye)],
        [u[..., 0], u[..., 1], u[..., 2], -_dot3(u, eye)],
        [-f[..., 0], -f[..., 1], -f[..., 2], _dot3(f, eye)],
        [0.0, 0.0, 0.0, 1.0],
    ])


def perspective(fov_y, aspect, near, far) -> torch.Tensor:
    """View -> clip, depth range [0, 1], right-handed view space. Tensor
    arguments may carry a batch shape."""
    if not isinstance(fov_y, torch.Tensor):
        fov_y = torch.full((), float(fov_y), dtype=torch.float32,
                           device=_device_of(aspect, near, far))
    f = 1.0 / torch.tan(fov_y / 2.0)
    return _rows4([
        [f / aspect, 0.0, 0.0, 0.0],
        [0.0, f, 0.0, 0.0],
        [0.0, 0.0, far / (near - far), near * far / (near - far)],
        [0.0, 0.0, -1.0, 0.0],
    ])


def orthographic(half_w, half_h, near, far) -> torch.Tensor:
    """View -> clip orthographic box, depth range [0, 1], centred (the
    directional shadow camera). Tensor arguments may carry a batch shape."""
    return _rows4([
        [1.0 / half_w, 0.0, 0.0, 0.0],
        [0.0, 1.0 / half_h, 0.0, 0.0],
        [0.0, 0.0, -1.0 / (far - near), -near / (far - near)],
        [0.0, 0.0, 0.0, 1.0],
    ])


def camera_matrices(cam: Camera):
    """(view, proj, viewproj) for a Camera."""
    v = view_matrix(cam)
    p = perspective(cam.fov_y, cam.aspect, cam.near, cam.far)
    return v, p, matmul4(p, v)


def frustum_planes(viewproj: torch.Tensor) -> torch.Tensor:
    """(..., 6, 4) normalized planes a*x+b*y+c*z+d >= 0 inside
    (Gribb-Hartmann) of (..., 4, 4) viewprojs. Order: left, right, bottom,
    top, near, far."""
    r = [viewproj[..., i, :] for i in range(4)]
    planes = torch.stack(
        [r[3] + r[0], r[3] - r[0], r[3] + r[1], r[3] - r[1], r[2], r[3] - r[2]], dim=-2
    )
    n = torch.linalg.norm(planes[..., :3], dim=-1, keepdim=True)
    return planes / n

