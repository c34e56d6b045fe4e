"""Camera, projection and frustum math (``renderer_tpu.mathx.camera``).

Depth convention: after the perspective divide z lies in [0, 1], near -> 0,
far -> 1 (Vulkan style). Every matrix is float32 on the camera's device.
The small products are written out term by term (no library matmul), so
the CPU and the card sum in the same order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from renderer_tpu_torch.device import resolve_device
from renderer_tpu_torch.mathx.transforms import quat_to_mat3


class Camera(NamedTuple):
    """Pinhole camera. ``rotation`` is a (w,x,y,z) unit quaternion taking
    view-space axes into world space (camera forward is -Z)."""

    position: torch.Tensor  # (3,)
    rotation: torch.Tensor  # (4,)
    fov_y: torch.Tensor  # radians, scalar
    aspect: torch.Tensor  # width / height, scalar
    near: torch.Tensor
    far: torch.Tensor

    @staticmethod
    def create(position, rotation=None, fov_y=1.1, aspect=1.0, near=0.1,
               far=100.0, device=None) -> "Camera":
        """The camera's tensors on ``device`` (the CUDA card when None), from
        host values (numbers, sequences, numpy arrays or CPU tensors).

        The eleven floats travel as one packed tensor. To the card it goes
        from pinned memory without blocking: a copy from pageable memory
        would wait for all the work queued on the stream. The caching host
        allocator keeps the pinned block until the copy has completed."""
        if rotation is None:
            rotation = (1.0, 0.0, 0.0, 0.0)
        device = resolve_device(device)
        host = torch.from_numpy(np.concatenate([
            np.asarray(v, np.float32).reshape(-1)
            for v in (position, rotation, fov_y, aspect, near, far)
        ]))
        if device.type == "cuda":
            packed = host.pin_memory().to(device, non_blocking=True)
        else:
            packed = host.to(device)
        return Camera(
            position=packed[0:3], rotation=packed[3:7], fov_y=packed[7],
            aspect=packed[8], near=packed[9], far=packed[10],
        )


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


def orbit_camera(angle: float, aspect: float, device=None) -> Camera:
    """The bench orbit: radius 18, height 6, yaw ``angle``, pitch -0.3,
    fov 0.9, near 0.1, far 200 (the float32 host formula of
    ``bench.make_camera``), on ``device`` (the CUDA card when None)."""
    r = 18.0
    pos = np.array([r * math.sin(angle), 6.0, r * math.cos(angle)], np.float32)

    def axis_angle(ax, a):
        s = math.sin(a / 2.0)
        return np.array(
            [math.cos(a / 2.0), ax[0] * s, ax[1] * s, ax[2] * s], np.float32
        )

    w1, x1, y1, z1 = axis_angle((0.0, 1.0, 0.0), angle)
    w2, x2, y2, z2 = axis_angle((1.0, 0.0, 0.0), -0.3)
    rot = np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        np.float32,
    )
    return Camera.create(pos, rot, fov_y=np.float32(0.9),
                         aspect=np.float32(aspect), near=np.float32(0.1),
                         far=np.float32(200.0), device=device)
