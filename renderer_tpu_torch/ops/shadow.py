"""Light cameras (``renderer_tpu.ops.shadow``): the cube-face axes, the
per-light view-projection of the ray-traced shadow path, and the caster
LOD pick by distance to a light. The shadow-map atlas and its lookup are
not ported yet."""

from __future__ import annotations

import math

import torch

from renderer_tpu_torch.mathx.camera import look_at, matmul4, orthographic, perspective

# cube faces in axis order +x, -x, +y, -y, +z, -z; a receiver belongs to the
# face of the major axis of its light -> receiver direction
CUBE_FACE_DIRS = (
    (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
    (0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
)
CUBE_FACE_UPS = (
    (0.0, 1.0, 0.0), (0.0, 1.0, 0.0),
    (0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
    (0.0, 1.0, 0.0), (0.0, 1.0, 0.0),
)


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def directional_light_matrices(lights, scene_min, scene_max) -> torch.Tensor:
    """(L, 4, 4) light view-projection per light (identity for lights
    without a shadow slot).

    Directional lights: an orthographic box fitted around the scene AABB,
    looking along the light direction from outside the scene. Point
    lights: a perspective camera at the light aimed at the scene centre,
    fov fitted to the scene's bounding sphere (the single-face variant).
    All lights are computed at once, as the JAX package's vmap does."""
    center = (scene_min + scene_max) * 0.5
    radius = _norm3(scene_max - scene_min) * 0.5 + 1e-3
    position = lights.position
    directional = lights.directional[:, None]
    d_dir = position / torch.clamp(_norm3(position), min=1e-8)[:, None]
    eye_dir = center - d_dir * (radius * 2.0)
    to_c = center - position
    dist = torch.maximum(_norm3(to_c), radius * 0.1 + 1e-3)
    eye = torch.where(directional, eye_dir, position)
    look_dir = torch.where(directional, d_dir, to_c / dist[:, None])
    axes = torch.eye(3, dtype=torch.float32, device=position.device)
    up = torch.where((look_dir[:, 1].abs() > 0.95)[:, None], axes[0], axes[1])
    view = look_at(eye, eye + look_dir, up)
    proj_dir = orthographic(radius, radius, radius * 0.5, radius * 3.5)
    fov = torch.clamp(2.0 * torch.atan(radius / dist), 0.2, 2.8)
    proj_pt = perspective(fov, 1.0, torch.maximum(dist - radius, radius * 0.02), dist + radius)
    proj = torch.where(directional[:, :, None], proj_dir, proj_pt)
    mats = matmul4(proj, view)
    want = (lights.alive & (lights.shadow_slot >= 0))[:, None, None]
    return torch.where(want, mats, torch.eye(4, dtype=torch.float32, device=mats.device))


def lod_by_distance(scene, model: torch.Tensor, point: torch.Tensor, bias: float = 0.0):
    """(N,) int64 per-instance LOD picked by distance from ``point`` (a light
    position), with the camera pick's coverage formula and the light as the
    eye. ``model`` is (N, 16) rows or (N, 4, 4)."""
    m = model.reshape(-1, 16)
    lib = scene.meshes
    mesh_id = scene.instances.mesh_id.long()
    mn = lib.mesh_aabb_min[mesh_id]
    mx = lib.mesh_aabb_max[mesh_id]
    c_loc = (mn + mx) * 0.5
    cw = torch.stack([
        m[:, 4 * i] * c_loc[:, 0] + m[:, 4 * i + 1] * c_loc[:, 1] + m[:, 4 * i + 2] * c_loc[:, 2]
        + m[:, 4 * i + 3]
        for i in range(3)
    ], dim=-1)
    s = _norm3(torch.stack([m[:, 0], m[:, 4], m[:, 8]], dim=-1))  # uniform scale
    radius = _norm3(mx - mn) * 0.5 * s
    dist = _norm3(cw - point[None])
    ratio = radius / torch.clamp(dist, min=1e-6)
    lod = torch.floor(torch.log2(torch.clamp(0.25 / torch.clamp(ratio, min=1e-6), min=1.0)) + bias)
    return torch.clamp(lod, 0, lib.lod_tri_count.shape[1] - 1).long()


def cube_face_matrices(near, far) -> torch.Tensor:
    """(6, 4, 4) fov-90 view-projections of the cube faces around the origin
    (a light-centred frame)."""
    proj = perspective(math.pi / 2, 1.0, near, far)
    e = torch.eye(3, dtype=torch.float32, device=proj.device)
    # CUBE_FACE_DIRS and CUBE_FACE_UPS, built on the device (a host tensor
    # copied over would wait for the queued work)
    dirs = torch.stack([e[0], -e[0], e[1], -e[1], e[2], -e[2]])
    ups = torch.stack([e[1], e[1], e[2], -e[2], e[1], e[1]])
    return matmul4(proj, look_at(torch.zeros_like(e[0]), dirs, ups))
