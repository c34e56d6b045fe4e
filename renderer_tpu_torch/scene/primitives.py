"""Procedural meshes and textures in numpy (``renderer_tpu.scene.primitives``).

The outputs equal the JAX package's array for array: the bench scene and the
test scenes are built from these.
"""

from __future__ import annotations

import numpy as np

from renderer_tpu_torch.scene.builder import HostMesh


def box(size=1.0) -> HostMesh:
    """Unit cube with per-face normals/uvs (24 verts, 12 tris)."""
    s = float(size) / 2.0
    # +X -X +Y -Y +Z -Z as (u, v, n) with u x v == n: CCW from outside
    face_axes = [
        (np.array([0, 0, -1]), np.array([0, 1, 0]), np.array([1, 0, 0])),
        (np.array([0, 0, 1]), np.array([0, 1, 0]), np.array([-1, 0, 0])),
        (np.array([0, 0, 1]), np.array([1, 0, 0]), np.array([0, 1, 0])),
        (np.array([0, 0, -1]), np.array([1, 0, 0]), np.array([0, -1, 0])),
        (np.array([1, 0, 0]), np.array([0, 1, 0]), np.array([0, 0, 1])),
        (np.array([-1, 0, 0]), np.array([0, 1, 0]), np.array([0, 0, -1])),
    ]
    positions, normals, uvs, tangents, indices = [], [], [], [], []
    for u, v, n in face_axes:
        base = len(positions)
        for iu, iv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            positions.append((u * iu + v * iv + n) * s)
            normals.append(n.astype(np.float32))
            uvs.append([(iu + 1) / 2, (1 - iv) / 2])
            tangents.append(list(u) + [1.0])
        indices += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return HostMesh(
        positions=np.array(positions, np.float32),
        normals=np.array(normals, np.float32),
        uvs=np.array(uvs, np.float32),
        tangents=np.array(tangents, np.float32),
        indices=np.array(indices, np.int32),
    )


def subdivided_box(size=1.0, segments=8, height=1.0) -> HostMesh:
    """Box with an (s + 1) x (s + 1) vertex grid per face (12 s^2
    triangles), ``height`` scaling Y: dense geometry for the city scene's
    buildings."""
    s = float(size) / 2.0
    n_seg = int(segments)
    face_axes = [
        (np.array([0, 0, -1.0]), np.array([0, 1.0, 0]), np.array([1.0, 0, 0])),
        (np.array([0, 0, 1.0]), np.array([0, 1.0, 0]), np.array([-1.0, 0, 0])),
        (np.array([0, 0, 1.0]), np.array([1.0, 0, 0]), np.array([0, 1.0, 0])),
        (np.array([0, 0, -1.0]), np.array([1.0, 0, 0]), np.array([0, -1.0, 0])),
        (np.array([1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, 1.0])),
        (np.array([-1.0, 0, 0]), np.array([0, 1.0, 0]), np.array([0, 0, -1.0])),
    ]
    scale = np.array([1.0, float(height), 1.0], np.float32)
    positions, normals, uvs, tangents, indices = [], [], [], [], []
    for u, v, n in face_axes:
        base = len(positions)
        for j in range(n_seg + 1):
            for i in range(n_seg + 1):
                fu = 2.0 * i / n_seg - 1.0
                fv = 2.0 * j / n_seg - 1.0
                positions.append((u * fu + v * fv + n) * s * scale)
                normals.append(n.astype(np.float32))
                uvs.append([i / n_seg, 1.0 - j / n_seg])
                tangents.append(list(u) + [1.0])
        for j in range(n_seg):
            for i in range(n_seg):
                a = base + j * (n_seg + 1) + i
                b = a + 1
                c = a + (n_seg + 1)
                d = c + 1
                indices += [[a, b, d], [a, d, c]]
    return HostMesh(
        positions=np.array(positions, np.float32),
        normals=np.array(normals, np.float32),
        uvs=np.array(uvs, np.float32),
        tangents=np.array(tangents, np.float32),
        indices=np.array(indices, np.int32),
    )


def plane(size=1.0, segments=1) -> HostMesh:
    """XZ plane centered at the origin, +Y normal."""
    n = segments + 1
    xs = np.linspace(-size / 2, size / 2, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    positions = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    normals = np.tile(np.array([0, 1, 0], np.float32), (len(positions), 1))
    u, v = np.meshgrid(
        np.linspace(0, 1, n, dtype=np.float32), np.linspace(0, 1, n, dtype=np.float32),
        indexing="ij",
    )
    uvs = np.stack([u, v], axis=-1).reshape(-1, 2)
    tangents = np.tile(np.array([1, 0, 0, 1], np.float32), (len(positions), 1))
    idx = []
    for i in range(segments):
        for j in range(segments):
            a = i * n + j
            b = a + 1
            c = a + n
            d = c + 1
            idx += [[a, b, d], [a, d, c]]  # CCW seen from +Y
    return HostMesh(
        positions=positions, normals=normals, uvs=uvs, tangents=tangents,
        indices=np.array(idx, np.int32),
    )


def uv_sphere(radius=0.5, rings=16, sectors=32) -> HostMesh:
    phi = np.linspace(0, np.pi, rings + 1, dtype=np.float32)
    theta = np.linspace(0, 2 * np.pi, sectors + 1, dtype=np.float32)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(P) * np.cos(T)
    y = np.cos(P)
    z = np.sin(P) * np.sin(T)
    normals = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    positions = normals * radius
    u = (T / (2 * np.pi)).reshape(-1)
    v = (P / np.pi).reshape(-1)
    uvs = np.stack([u, v], axis=-1).astype(np.float32)
    tx, tz = -np.sin(T), np.cos(T)  # tangent along +theta
    tangents = np.stack(
        [tx, np.zeros_like(tx), tz, np.ones_like(tx)], axis=-1
    ).reshape(-1, 4).astype(np.float32)
    idx = []
    cols = sectors + 1
    for i in range(rings):
        for j in range(sectors):
            a = i * cols + j
            b = a + 1
            c = a + cols
            d = c + 1
            if i > 0:
                idx.append([a, b, c])
            if i < rings - 1:
                idx.append([b, d, c])
    return HostMesh(
        positions=positions, normals=normals, uvs=uvs, tangents=tangents,
        indices=np.array(idx, np.int32),
    )


def torus(major=0.7, minor=0.25, rings=24, sides=16) -> HostMesh:
    u = np.linspace(0, 2 * np.pi, rings + 1, dtype=np.float32)
    v = np.linspace(0, 2 * np.pi, sides + 1, dtype=np.float32)
    U, V = np.meshgrid(u, v, indexing="ij")
    cx, cz = np.cos(U) * major, np.sin(U) * major
    x = (major + minor * np.cos(V)) * np.cos(U)
    z = (major + minor * np.cos(V)) * np.sin(U)
    y = minor * np.sin(V)
    positions = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    center = np.stack([cx, np.zeros_like(cx), cz], axis=-1).reshape(-1, 3)
    normals = positions - center
    normals /= np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    uvs = np.stack([U / (2 * np.pi), V / (2 * np.pi)], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = []
    cols = sides + 1
    for i in range(rings):
        for j in range(sides):
            a = i * cols + j
            b = a + 1
            c = a + cols
            d = c + 1
            idx += [[a, b, c], [b, d, c]]
    return HostMesh(
        positions=positions, normals=normals.astype(np.float32), uvs=uvs,
        indices=np.array(idx, np.int32),
    )


def checkerboard_texture(size=256, squares=8, c0=(200, 200, 200), c1=(40, 40, 60)):
    """(size, size, 4) uint8 checkerboard."""
    ij = np.arange(size) * squares // size
    mask = (ij[:, None] + ij[None, :]) % 2
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.where(mask[..., None] == 0, np.uint8(c0), np.uint8(c1))
    img[..., 3] = 255
    return img


def bump_normal_texture(size=256, bumps=8, strength=0.8, kind="bumps"):
    """(size, size, 4) uint8 tangent-space normal map (+Z up, 0.5-biased).
    kind="bumps": sinusoidal bump grid; "grooves": axis-aligned ridges."""
    t = np.linspace(0.0, 2.0 * np.pi * bumps, size, endpoint=False, dtype=np.float32)
    if kind == "bumps":
        gx = np.cos(t)[None, :] * np.sin(t)[:, None]
        gy = np.sin(t)[None, :] * np.cos(t)[:, None]
    elif kind == "grooves":
        gx = np.cos(t)[None, :] * np.ones((size, 1), np.float32)
        gy = 0.3 * np.cos(t * 0.5)[:, None] * np.ones((1, size), np.float32)
    else:
        raise ValueError(kind)
    n = np.stack(
        [-gx * strength, -gy * strength, np.ones((size, size), np.float32)],
        axis=-1,
    )
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.clip(np.round((n * 0.5 + 0.5) * 255.0), 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img
