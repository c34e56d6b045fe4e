"""The one traffic generator: every cell's frames from its traffic file and
the seed.

A traffic mix is data, ``benchmark/traffic/<traffic>.json``, found by the
workload's ``traffic`` name. A frame k (k < 0 during set-up, 0, 1, ... in
the window) has a camera pose from the file's ``camera`` path and the
scene's tables with the file's ``motions`` applied. The seed sets the scene
(the configuration's builder), the start of the camera path and the phase
of the motions. The tables are made once on the host, copied to the device
in one copy each, and repeat with a period of ``TABLE_FRAMES`` frames.

The file's keys:

- ``camera``: the path, one of
  - ``{"path": "orbit", "radius", "height", "pitch", "step"}``: the camera at
    (radius sin a, height, radius cos a), turned by yaw a about y and then
    by ``pitch`` about x, a = a0 + step k, a0 drawn from the seed in
    [0, 2 pi) (the float32 host formula of ``bench.make_camera``);
  - ``{"path": "keys", "keys": [[x, y, z, yaw, pitch], ...],
    "frames_per_key"}``: a closed walk through the keys, position, yaw and
    pitch interpolated linearly between consecutive keys, starting at a
    frame of the walk drawn from the seed;

  and for both ``fov_y``, ``near``, ``far``.
- ``motions``: a list, each ``{"field": "<table>.<column>", "rows": [i,
  ...], "center", "amplitude", "rate", "phase": [one number per
  component], "normalize": bool}``: rows i of the scene's column (an (N, D)
  float table such as ``instances.translation`` or ``lights.position``)
  set each frame to center + amplitude * sin(rate * m + phase) per
  component, m = k + p with p drawn from the seed in [0, 1000), and scaled
  to unit length when ``normalize``. Motions of one column apply in order.

Nothing else of a frame changes: a new mix that the keys cannot say needs a
new key here, not a new generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SEED_MOD = 1 << 63
TABLE_FRAMES = 512    # the period of the traffic's tables, in frames
COMPARED_FRAMES = 2   # window frames the output check samples besides the last


def seed_of(seed: int) -> int:
    """Any whole number as a non-negative seed of numpy's generator."""
    return int(seed) % SEED_MOD


def _axis_angle(ax, a):
    s = math.sin(a / 2.0)
    return np.array([math.cos(a / 2.0), ax[0] * s, ax[1] * s, ax[2] * s], np.float32)


def camera_pose(pos, yaw: float, pitch: float, fov_y: float, aspect: float, near: float,
                far: float) -> np.ndarray:
    """(11,) float32: position, rotation (w, x, y, z) = yaw about y then
    pitch about x, fov_y, aspect, near, far."""
    w1, x1, y1, z1 = _axis_angle((0.0, 1.0, 0.0), yaw)
    w2, x2, y2, z2 = _axis_angle((1.0, 0.0, 0.0), pitch)
    rot = np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], np.float32)
    tail = np.array([fov_y, aspect, near, far], np.float32)
    return np.concatenate([np.asarray(pos, np.float32), rot, tail]).astype(np.float32)


def get_field(scene, field: str):
    """The scene's ``<table>.<column>`` (such as ``instances.translation``)."""
    table, column = field.split(".")
    return getattr(getattr(scene, table), column)


def replace_field(scene, field: str, value):
    """The scene with ``<table>.<column>`` replaced by ``value``."""
    table, column = field.split(".")
    return scene._replace(**{table: getattr(scene, table)._replace(**{column: value})})


class Traffic:
    """The frames of one traffic mix and seed: ``index(k)`` is the table row
    of frame k, ``pose(k)`` and ``fields(k)`` ({column: (N, D) float32}, the
    moved columns only) its host values; ``device_tables`` puts them on the
    device."""

    def __init__(self, params: dict, seed: int, aspect: float, setup_frames: int,
                 base: dict):
        rng = np.random.default_rng(seed_of(seed) ^ 0x5EED)
        self.camera, self.motions = params["camera"], params.get("motions", [])
        self.aspect = aspect
        self.setup_frames = setup_frames
        self.period = TABLE_FRAMES
        cam = self.camera
        if cam["path"] == "orbit":
            self.start = float(rng.uniform(0.0, 2.0 * math.pi))
        elif cam["path"] == "keys":
            self.start = float(rng.integers(0, len(cam["keys"]) * int(cam["frames_per_key"])))
        else:
            raise ValueError(f"unknown camera path {cam['path']!r}")
        self.phase = float(rng.uniform(0.0, 1000.0))
        self.compare_draw = rng.random(COMPARED_FRAMES)
        self.base = {f: np.asarray(base[f], np.float32) for f in self.moved_fields(params)}

    @staticmethod
    def moved_fields(params: dict) -> list:
        """The scene columns the mix's motions set, in order of first use."""
        return list(dict.fromkeys(m["field"] for m in params.get("motions", [])))

    def index(self, k: int) -> int:
        """The table row of frame k (the tables repeat every ``period``
        frames, counted from the first set-up frame)."""
        return (k + self.setup_frames) % self.period - self.setup_frames

    def pose(self, k: int) -> np.ndarray:
        c, k = self.camera, self.index(k)
        if c["path"] == "orbit":
            a = self.start + float(c["step"]) * k
            pos = (c["radius"] * math.sin(a), c["height"], c["radius"] * math.cos(a))
            yaw, pitch = a, c["pitch"]
        else:
            keys = np.asarray(c["keys"], np.float64)
            t = ((self.start + k) / float(c["frames_per_key"])) % len(keys)
            i = int(math.floor(t))
            u = t - i
            v = keys[i] * (1.0 - u) + keys[(i + 1) % len(keys)] * u
            pos, yaw, pitch = v[0:3], float(v[3]), float(v[4])
        return camera_pose(pos, yaw, pitch, c["fov_y"], self.aspect, c["near"], c["far"])

    def fields(self, k: int) -> dict:
        """{column: (N, D) float32} of frame k, for every column the mix
        moves (empty when nothing moves)."""
        out = {f: v.copy() for f, v in self.base.items()}
        u = self.index(k) + self.phase
        for m in self.motions:
            v = (np.asarray(m["center"], np.float64) + np.asarray(m["amplitude"], np.float64)
                 * np.sin(np.asarray(m["rate"], np.float64) * u
                          + np.asarray(m["phase"], np.float64)))
            if m.get("normalize"):
                v = v / np.linalg.norm(v)
            out[m["field"]][list(m["rows"])] = v.astype(np.float32)
        return out

    def scene_key(self, k: int) -> int:
        """Equal for two frames whose scenes are equal: the table row, or 0
        when nothing in the scene moves."""
        return self.index(k) if self.motions else 0

    def compared(self, guaranteed: int) -> list:
        """Window frames the output check samples besides the last, drawn from
        the seed among the first ``guaranteed`` frames of the window."""
        return sorted({int(u * guaranteed) for u in self.compare_draw})

    def device_tables(self, device) -> dict:
        """Every row of the tables on the device, one copy each: ``pose``
        (P, 11) and per moved column (P, N, D), row r holding frame
        r - setup_frames."""
        ks = range(-self.setup_frames, self.period - self.setup_frames)
        out = {"pose": torch.from_numpy(np.stack([self.pose(k) for k in ks])).to(device)}
        rows = [self.fields(k) for k in ks]
        for f in self.base:
            out[f] = torch.from_numpy(np.stack([r[f] for r in rows])).to(device)
        return out

    def row(self, k: int) -> int:
        """The device tables' row of frame k."""
        return self.index(k) + self.setup_frames
