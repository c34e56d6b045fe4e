"""Procedural scene families (``renderer_tpu.models.scenes``). Same
arguments and the same tables as the JAX builders, plus the device (the
CUDA card when None)."""

from __future__ import annotations

import numpy as np
import torch

from renderer_tpu_torch.device import resolve_device
from renderer_tpu_torch.scene import HostMesh, Lights, Scene, SceneBuilder, SceneLimits, primitives


def box_scene(limits: SceneLimits = None, device=None) -> Scene:
    """One box, one material, a point and a directional light."""
    b = SceneBuilder(limits or SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material(base_color=(0.8, 0.25, 0.2, 1.0), roughness=0.7)
    b.add_instance(box, m)
    b.add_light(position=(2.0, 3.0, 4.0), intensity=20.0)
    b.add_light(position=(-0.5, -1.0, -0.3), directional=True, intensity=0.4, shadow_slot=0)
    return b.build(device=device)


def textured_scene(limits: SceneLimits = None, atlas_size: int = 256,
                   device=None) -> Scene:
    """Textured PBR spheres, a box and a checkered floor."""
    b = SceneBuilder(limits or SceneLimits(), atlas_size=atlas_size)
    plane = b.add_mesh(primitives.plane(size=16.0))
    sph = b.add_mesh(primitives.uv_sphere(rings=24, sectors=48))
    box = b.add_mesh(primitives.box())
    checker = b.add_texture(primitives.checkerboard_texture(atlas_size, squares=16))
    warm = b.add_texture(
        primitives.checkerboard_texture(atlas_size, squares=6, c0=(230, 120, 60), c1=(250, 235, 220))
    )
    floor = b.add_material(roughness=0.6, base_color_tex=checker)
    shiny = b.add_material(roughness=0.25, metallic=0.1, base_color_tex=warm)
    metal = b.add_material(base_color=(0.95, 0.64, 0.54, 1), roughness=0.3, metallic=1.0)
    b.add_instance(plane, floor, translation=(0, -0.6, 0))
    b.add_instance(sph, shiny, translation=(-0.9, 0, 0), scale=1.1)
    b.add_instance(sph, metal, translation=(0.9, 0, 0), scale=1.1)
    b.add_instance(box, shiny, translation=(0, -0.1, -1.6))
    b.add_light(position=(3.0, 5.0, 4.0), intensity=30.0)
    b.add_light(position=(-0.5, -1.0, -0.3), directional=True, intensity=0.35, shadow_slot=0)
    return b.build(device=device)


def make_skinned_arm(segments: int = 16, joints: int = 4, length: float = 2.0,
                     radius: float = 0.15):
    """A skinned tube along +Y with a joint chain and smooth two-joint
    weights. Returns (HostMesh, joints (V, 4), weights (V, 4), parents,
    inverse_bind, joint heights)."""
    sides = 12
    ys = np.linspace(0.0, length, segments + 1, dtype=np.float32)
    theta = np.linspace(0, 2 * np.pi, sides + 1, dtype=np.float32)[:-1]
    positions, normals, uvs = [], [], []
    for y in ys:
        for t in theta:
            positions.append([radius * np.cos(t), y, radius * np.sin(t)])
            normals.append([np.cos(t), 0.0, np.sin(t)])
            uvs.append([t / (2 * np.pi), y / length])
    positions = np.asarray(positions, np.float32)
    idx = []
    for i in range(segments):
        for j in range(sides):
            a = i * sides + j
            b = i * sides + (j + 1) % sides
            idx += [[a, b, a + sides], [b, b + sides, a + sides]]
    mesh = HostMesh(positions=positions, normals=np.asarray(normals, np.float32),
                    uvs=np.asarray(uvs, np.float32), indices=np.asarray(idx, np.int32))
    joint_y = np.linspace(0.0, length, joints, dtype=np.float32)
    parents = np.arange(-1, joints - 1, dtype=np.int32)
    inverse_bind = np.tile(np.eye(4, dtype=np.float32), (joints, 1, 1))
    for j in range(joints):
        inverse_bind[j, 1, 3] = -joint_y[j]
    jids = np.zeros((len(positions), 4), np.int32)
    wts = np.zeros((len(positions), 4), np.float32)
    seg = (joints - 1) * positions[:, 1] / length
    j0 = np.clip(np.floor(seg).astype(np.int32), 0, joints - 2)
    f = seg - j0
    jids[:, 0], jids[:, 1] = j0, j0 + 1
    wts[:, 0], wts[:, 1] = 1.0 - f, f
    return mesh, jids, wts, parents, inverse_bind, joint_y


def skinned_scene(limits: SceneLimits = None, device=None) -> Scene:
    """An animated skinned arm swaying on a floor: one LINEAR clip of 9 keys
    over 1 s, each joint turning about Z with its own phase."""
    b = SceneBuilder(limits or SceneLimits.tiny())
    mesh, jids, wts, parents, inv_bind, joint_y = make_skinned_arm()
    joints = len(parents)
    times = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    key_t = np.zeros((9, joints, 3), np.float32)
    key_r = np.zeros((9, joints, 4), np.float32)
    key_r[..., 0] = 1.0
    for k, t in enumerate(times):
        for j in range(joints):
            key_t[k, j, 1] = joint_y[j] - (joint_y[j - 1] if j > 0 else 0.0)
            if j > 0:
                angle = 0.6 * np.sin(2 * np.pi * t + j)
                key_r[k, j] = [np.cos(angle / 2), 0.0, 0.0, np.sin(angle / 2)]
    mid = b.add_skinned_mesh(mesh, jids, wts, parents, inv_bind, times, key_t, key_r)
    plane = b.add_mesh(primitives.plane(size=8.0))
    b.add_instance(plane, b.add_material(base_color=(0.6, 0.6, 0.62, 1), roughness=0.9))
    b.add_instance(mid, b.add_material(base_color=(0.9, 0.7, 0.5, 1.0), roughness=0.6))
    b.add_light(position=(2.0, 4.0, 3.0), intensity=25.0)
    b.add_light(position=(-0.4, -1.0, -0.2), directional=True, intensity=0.5, shadow_slot=0)
    return b.build(device=device)


def sponza_like_scene(
    n_instances: int = 10000,
    seed: int = 0,
    limits: SceneLimits = None,
    with_lods: bool = True,
    area: float = 120.0,
    n_textures: int = 2,
    tex_size: int = 256,
    texture_slots: int = 0,
    device=None,
) -> Scene:
    """The bench scene: a ground plane plus ``n_instances`` boxes, spheres
    and tori (with LOD chains) scattered over ``area``, 2*n_textures atlas
    layers (base colours and normal maps) and two lights. Host data comes
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n_mats = max(32, n_textures)
    limits = limits or SceneLimits(
        max_instances=max(16384, 1 << int(np.ceil(np.log2(n_instances + 16)))),
        max_vertices=1 << 16,
        max_triangles=1 << 16,
        max_materials=max(64, n_mats + 1),
        max_lights=4,
        max_textures=max(64, 2 * n_textures),
    )
    b = SceneBuilder(limits, atlas_size=tex_size)
    plane = b.add_mesh(primitives.plane(size=area * 1.2))
    texs = [
        b.add_texture(primitives.checkerboard_texture(256, squares=8)),
        b.add_texture(
            primitives.checkerboard_texture(256, squares=16, c0=(220, 160, 90), c1=(120, 80, 50))
        ),
    ]
    nmaps = [
        b.add_texture(primitives.bump_normal_texture(256, bumps=6, strength=0.8)),
        b.add_texture(
            primitives.bump_normal_texture(256, bumps=12, strength=0.6, kind="grooves")
        ),
    ]
    for i in range(2, n_textures):
        texs.append(b.add_texture(primitives.checkerboard_texture(
            256, squares=int(rng.integers(4, 24)),
            c0=tuple(int(c) for c in rng.integers(40, 255, 3)),
            c1=tuple(int(c) for c in rng.integers(40, 255, 3)),
        )))
        nmaps.append(b.add_texture(primitives.bump_normal_texture(
            256, bumps=int(rng.integers(3, 16)),
            strength=float(rng.uniform(0.3, 0.9)),
            kind="grooves" if i % 2 else "bumps",
        )))

    meshes = [
        b.add_mesh(primitives.box()),
        b.add_mesh(primitives.uv_sphere(rings=16, sectors=24), auto_lods=with_lods),
        b.add_mesh(primitives.torus(rings=16, sides=10), auto_lods=with_lods),
    ]
    n_t = len(texs)
    mats = [
        b.add_material(
            base_color=tuple(rng.uniform(0.2, 0.95, 3)) + (1.0,),
            roughness=float(rng.uniform(0.2, 0.9)),
            metallic=float(rng.choice([0.0, 0.0, 1.0])),
            base_color_tex=texs[i % n_t] if (n_t > 2 or i % 3 == 0) else -1,
            normal_tex=nmaps[i % n_t],
        )
        for i in range(n_mats)
    ]
    floor = b.add_material(
        base_color=(0.45, 0.45, 0.48, 1.0), roughness=0.9, normal_tex=nmaps[1]
    )
    b.add_instance(plane, floor, translation=(0, -1.0, 0))

    pos = rng.uniform(-area / 2, area / 2, size=(n_instances, 2))
    height = rng.uniform(-0.5, 2.0, size=n_instances)
    scale = rng.uniform(0.3, 1.2, size=n_instances)
    angles = rng.uniform(0, 2 * np.pi, size=n_instances)
    for i in range(n_instances):
        c, s = np.cos(angles[i] / 2), np.sin(angles[i] / 2)
        b.add_instance(
            meshes[i % len(meshes)],
            mats[i % len(mats)],
            translation=(pos[i, 0], height[i], pos[i, 1]),
            rotation=(c, 0.0, s, 0.0),
            scale=float(scale[i]),
        )
    b.add_light(position=(0.4, -1.0, 0.2), directional=True, intensity=2.5, shadow_slot=0)
    b.add_light(position=(0.0, 20.0, 0.0), intensity=300.0)
    return b.build(texture_slots=texture_slots, device=device)


def shadow_envelope_lights(n: int = 16, device=None) -> Lights:
    """The light table of the reference's shadow envelope, as
    ``scripts/prof_shadow_amort.py`` sets it on the bench scene: ``n``
    directional lights, light i in shadow slot i, all alive, colour 1 and
    intensity 1.2. Directions come from ``np.random.default_rng(3)`` with y
    forced downward; light 0 points along (-0.5, -1, -0.3). It replaces a
    scene's whole table, so the scene needs ``max_lights == n``."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0] = np.asarray((-0.5, -1.0, -0.3), np.float32) / np.linalg.norm((-0.5, -1.0, -0.3))
    dev = resolve_device(device)
    return Lights(
        position=torch.from_numpy(d).to(dev),
        color=torch.ones((n, 3), dtype=torch.float32, device=dev),
        intensity=torch.full((n,), 1.2, dtype=torch.float32, device=dev),
        directional=torch.ones((n,), dtype=torch.bool, device=dev),
        shadow_slot=torch.arange(n, dtype=torch.int32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        count=torch.tensor(n, dtype=torch.int32, device=dev),
    )


def city_scene(grid: int = 20, seed: int = 0, segments: int = 12,
               limits: SceneLimits = None, device=None) -> Scene:
    """City blocks, the occlusion-culling design point: a ground plane and a
    grid x grid field of dense buildings of one height, so that from the
    street the front rows hide the blocks behind them. Host data comes from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    limits = limits or SceneLimits(
        max_instances=4096, max_vertices=1 << 16, max_triangles=1 << 16,
        max_materials=32, max_lights=4,
    )
    b = SceneBuilder(limits)
    ground = b.add_mesh(primitives.plane(size=grid * 8.0 * 1.2))
    height = 3.0
    building = b.add_mesh(primitives.subdivided_box(segments=segments, height=height))
    mats = [
        b.add_material(
            base_color=tuple(rng.uniform(0.35, 0.8, 3)) + (1.0,),
            roughness=float(rng.uniform(0.5, 0.95)),
        )
        for _ in range(12)
    ]
    b.add_instance(ground, b.add_material(base_color=(0.3, 0.3, 0.32, 1.0), roughness=0.95),
                   translation=(0, 0, 0))
    pitch = 8.0
    half = grid * pitch / 2.0
    for gx in range(grid):
        for gz in range(grid):
            x = -half + pitch * (gx + 0.5) + rng.uniform(-0.5, 0.5)
            z = -half + pitch * (gz + 0.5) + rng.uniform(-0.5, 0.5)
            s = rng.uniform(2.6, 3.0)
            rng.integers(0, 3)  # drawn and unused: keeps the layout of the random stream
            b.add_instance(
                building,
                mats[int(rng.integers(0, len(mats)))],
                translation=(x, 0.5 * height * s, z),  # the mesh spans +-height/2
                scale=float(s),
            )
    b.add_light(position=(0.3, -1.0, 0.15), directional=True, intensity=2.5, shadow_slot=0)
    b.add_light(position=(0.0, 60.0, 0.0), intensity=2500.0)
    return b.build(device=device)


def colonnade_spec():
    """The committed asset's spec: an atrium colonnade. Returns (meshes,
    instances, materials) in ``scene.gltf.write_glb``'s format (instances
    = [(mesh_idx, mat_idx, translation, rotation wxyz, scale)]), the source
    of both ``assets/colonnade.glb`` and its procedural twin
    ``colonnade_scene``. Each mesh has one material (mat_idx == mesh_idx):
    ``write_glb`` assigns materials per mesh."""
    meshes = [
        primitives.plane(size=30.0),                 # 0 floor
        primitives.box(),                            # 1 column shaft
        primitives.torus(rings=20, sides=12),        # 2 capital ring
        primitives.uv_sphere(rings=18, sectors=30),  # 3 ornament
        primitives.box(),                            # 4 architrave beam
    ]
    materials = [
        dict(base_color=(0.55, 0.53, 0.5, 1.0), roughness=0.9),   # stone floor
        dict(base_color=(0.82, 0.79, 0.72, 1.0), roughness=0.6),  # marble
        dict(base_color=(0.72, 0.45, 0.2, 1.0), roughness=0.35, metallic=1.0),  # bronze
        dict(base_color=(0.6, 0.15, 0.12, 1.0), roughness=0.4),   # red ornament
        dict(base_color=(0.75, 0.72, 0.66, 1.0), roughness=0.7),  # beam
    ]
    instances = [(0, 0, (0.0, -1.0, 0.0), (1.0, 0.0, 0.0, 0.0), 1.0)]
    n_cols = 14
    for side in (-1.0, 1.0):
        for k in range(n_cols):
            x = -13.0 + 2.0 * k
            z = side * 4.0
            # shaft: six touching drums; a torus capital; a sphere on every other
            for seg in range(6):
                instances.append((1, 1, (x, -0.775 + 0.45 * seg, z), (1.0, 0.0, 0.0, 0.0), 0.45))
            instances.append((2, 2, (x, 1.8, z), (1.0, 0.0, 0.0, 0.0), 0.5))
            if k % 2 == 0:
                instances.append((3, 3, (x, 2.35, z), (1.0, 0.0, 0.0, 0.0), 0.35))
        for k in range(n_cols - 1):  # architrave beams along each colonnade
            instances.append((4, 4, (-12.0 + 2.0 * k, 2.15, side * 4.0),
                              (1.0, 0.0, 0.0, 0.0), 0.9))
    for k in range(5):  # central ornaments
        instances.append((3, 3, (-8.0 + 4.0 * k, 0.1, 0.0),
                          (0.92387953, 0.0, 0.38268343, 0.0), 0.8))
    return meshes, instances, materials


def _colonnade_lights(b: SceneBuilder) -> None:
    """The colonnade's lights (a GLB carries none)."""
    b.add_light(position=(6.0, 12.0, 8.0), intensity=220.0)
    b.add_light(position=(-0.4, -1.0, -0.25), directional=True, intensity=2.0, shadow_slot=0)


def colonnade_scene(limits: SceneLimits = None, device=None) -> Scene:
    """The procedural twin of ``assets/colonnade.glb`` (``colonnade_spec``)."""
    meshes, instances, materials = colonnade_spec()
    b = SceneBuilder(limits or SceneLimits())
    mesh_ids = [b.add_mesh(m) for m in meshes]
    mat_ids = [b.add_material(base_color=m["base_color"], roughness=m.get("roughness", 0.8),
                              metallic=m.get("metallic", 0.0)) for m in materials]
    for mesh_idx, mat_idx, t, q, s in instances:
        b.add_instance(mesh_ids[mesh_idx], mat_ids[mat_idx], translation=t, rotation=q, scale=s)
    _colonnade_lights(b)
    return b.build(device=device)
