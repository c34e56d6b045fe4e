"""Fly-mode camera controller (``renderer_tpu.runtime.camera_controller``):
WASD plus mouse-look with a fly/walk toggle, as a pure function of
(state, one frame's input), on the host; ``to_camera`` makes the port's
``Camera`` on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from renderer_tpu_torch.mathx import Camera, quat_from_axis_angle, quat_mul


@dataclasses.dataclass
class CameraState:
    position: np.ndarray
    yaw: float = 0.0    # radians about +Y
    pitch: float = 0.0  # radians about camera X, clamped
    fly_mode: bool = True  # False = locked to a ground height (walk mode)
    ground_y: float = 0.0


@dataclasses.dataclass
class InputFrame:
    """One frame's inputs (held keys and the mouse delta)."""

    forward: float = 0.0   # +1 = W, -1 = S
    strafe: float = 0.0    # +1 = D, -1 = A
    up: float = 0.0        # +1 = Space, -1 = Ctrl (fly mode only)
    look_dx: float = 0.0   # mouse delta, radians
    look_dy: float = 0.0
    speed: float = 3.0     # units/second
    toggle_fly: bool = False


def step(state: CameraState, inp: InputFrame, dt: float) -> CameraState:
    """Advance the controller one frame; returns a new state."""
    yaw = state.yaw - inp.look_dx
    pitch = float(np.clip(state.pitch - inp.look_dy, -1.55, 1.55))
    fly = state.fly_mode ^ inp.toggle_fly

    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # camera forward (-Z rotated by yaw and pitch), right (+X rotated by yaw)
    forward = np.array([-sy * cp, sp, -cy * cp], np.float32)
    right = np.array([cy, 0.0, -sy], np.float32)
    if not fly:  # walk mode: motion stays in the ground plane
        flat = np.array([-sy, 0.0, -cy], np.float32)
        move = flat * inp.forward + right * inp.strafe
    else:
        move = forward * inp.forward + right * inp.strafe
        move = move + np.array([0.0, 1.0, 0.0], np.float32) * inp.up
    n = np.linalg.norm(move)
    if n > 1.0:
        move = move / n
    position = state.position + move * (inp.speed * dt)
    if not fly:
        position = position.copy()
        position[1] = state.ground_y
    return CameraState(position=position, yaw=yaw, pitch=pitch, fly_mode=fly,
                       ground_y=state.ground_y)


def to_camera(state: CameraState, fov_y=0.9, aspect=1.0, near=0.1, far=100.0,
              device=None) -> Camera:
    """The state as the port's Camera on ``device`` (the CUDA card when
    None); the rotation is yaw about +Y after pitch about +X, made on the
    host."""
    rot = quat_mul(quat_from_axis_angle((0.0, 1.0, 0.0), state.yaw, device="cpu"),
                   quat_from_axis_angle((1.0, 0.0, 0.0), state.pitch, device="cpu"))
    return Camera.create(np.asarray(state.position, np.float32), rot.numpy(), fov_y=fov_y,
                         aspect=aspect, near=near, far=far, device=device)
