"""Fixed-capacity structure-of-arrays scene (``renderer_tpu.scene.types``).

Every table is allocated at a fixed capacity with a used count or an alive
mask, as in the JAX package, and lives as torch tensors on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from renderer_tpu_torch.device import resolve_device
from renderer_tpu_torch.scene.textures import TextureAtlas


class SceneLimits(NamedTuple):
    """Design envelope (the JAX package's defaults)."""

    max_vertices: int = 1 << 20
    max_triangles: int = 1 << 18
    max_meshes: int = 256
    max_instances: int = 16384
    max_materials: int = 256
    max_lights: int = 16
    max_textures: int = 64
    max_skins: int = 4
    max_joints: int = 32  # joints per skin
    max_keyframes: int = 64  # keys per clip
    max_clips: int = 4  # clips per skin

    @staticmethod
    def tiny() -> "SceneLimits":
        """Small limits for unit tests."""
        return SceneLimits(
            max_vertices=4096, max_triangles=4096, max_meshes=16,
            max_instances=64, max_materials=16, max_lights=4, max_textures=4,
            max_skins=2, max_joints=8, max_keyframes=16, max_clips=2,
        )


# tri_rec columns: [pos c0..c2 (9) | nrm (9) | uv (6) | tan xyzw (12)]
TR_POS = 0
TR_NRM = 9
TR_UV = 18
TR_TAN = 24
TR_COLS = 36
TRI_REC_MAX_BYTES = 1 << 28  # tri_rec exists while T * 512 B fits this

# Every (mesh, LOD) index range is padded to a CLUSTER multiple; cluster c
# covers library triangles [32c, 32c+32). cluster_data rows hold the
# object-space bounding sphere + normal cone (CL_*), and CL_COUNT the real
# (non-padding) prefix length.
CLUSTER = 32
CL_CENTER = 0
CL_RADIUS = 3
CL_AXIS = 4
CL_COS = 7
CL_SIN = 8
CL_COUNT = 9
CL_COLS = 12


class MeshLibrary(NamedTuple):
    """Consolidated mesh megabuffers + per-mesh directory. Indices are
    library-global. ``lod_index_offset[m, l]`` / ``lod_tri_count[m, l]``
    give up to MAX_LODS triangle ranges per mesh."""

    MAX_LODS = 6

    positions: torch.Tensor     # (V, 3) f32
    normals: torch.Tensor       # (V, 3) f32
    tangents: torch.Tensor      # (V, 4) f32
    uvs: torch.Tensor           # (V, 2) f32
    indices: torch.Tensor       # (T, 3) i32
    vertex_count: torch.Tensor  # () i32
    tri_count: torch.Tensor     # () i32
    mesh_count: torch.Tensor    # () i32
    mesh_vertex_offset: torch.Tensor  # (M,) i32
    mesh_vertex_count: torch.Tensor   # (M,) i32
    lod_index_offset: torch.Tensor    # (M, MAX_LODS) i32
    lod_tri_count: torch.Tensor       # (M, MAX_LODS) i32
    mesh_aabb_min: torch.Tensor       # (M, 3) f32
    mesh_aabb_max: torch.Tensor       # (M, 3) f32
    tri_rec: torch.Tensor = None      # (T, TR_COLS) f32 per-triangle corners
    cluster_data: torch.Tensor = None  # (T // CLUSTER, CL_COLS) f32


class Instances(NamedTuple):
    translation: torch.Tensor  # (N, 3) f32
    rotation: torch.Tensor     # (N, 4) f32 quat (w,x,y,z)
    scale: torch.Tensor        # (N,) f32 uniform scale
    mesh_id: torch.Tensor      # (N,) i32
    material_id: torch.Tensor  # (N,) i32
    alive: torch.Tensor        # (N,) bool
    count: torch.Tensor        # () i32


class Materials(NamedTuple):
    """glTF metallic-roughness material table."""

    base_color_factor: torch.Tensor  # (K, 4) f32
    metallic: torch.Tensor           # (K,) f32
    roughness: torch.Tensor          # (K,) f32
    emissive: torch.Tensor           # (K, 3) f32
    base_color_tex: torch.Tensor     # (K,) i32 atlas layer or -1
    normal_tex: torch.Tensor         # (K,) i32 atlas layer or -1
    count: torch.Tensor              # () i32


class Lights(NamedTuple):
    position: torch.Tensor     # (L, 3) f32 (direction for directional)
    color: torch.Tensor        # (L, 3) f32
    intensity: torch.Tensor    # (L,) f32
    directional: torch.Tensor  # (L,) bool
    shadow_slot: torch.Tensor  # (L,) i32
    alive: torch.Tensor        # (L,) bool
    count: torch.Tensor        # () i32


# clip interpolation modes (glTF animation.sampler.interpolation)
INTERP_LINEAR = 0
INTERP_STEP = 1
INTERP_CUBICSPLINE = 2


class Skins(NamedTuple):
    """Linear-blend skinning and keyframe clips. Vertex skin attributes run
    parallel to the vertex pool (zero weights: a rigid vertex). Each skin
    has a joint hierarchy (parents before children), inverse bind matrices
    and up to max_clips TRS clips, one of them active. The ``*_in`` /
    ``*_out`` tangent tables matter only for CUBICSPLINE clips."""

    joints: torch.Tensor        # (V, 4) i32 skin-local joint ids
    weights: torch.Tensor       # (V, 4) f32
    vertex_skin: torch.Tensor   # (V,) i32 owning skin, -1 = rigid
    parents: torch.Tensor       # (S, J) i32, -1 = root
    inverse_bind: torch.Tensor  # (S, J, 4, 4) f32
    joint_count: torch.Tensor   # (S,) i32
    key_times: torch.Tensor     # (S, C, K) f32, padded with the last time
    key_t: torch.Tensor         # (S, C, K, J, 3)
    key_t_in: torch.Tensor      # (S, C, K, J, 3)
    key_t_out: torch.Tensor     # (S, C, K, J, 3)
    key_r: torch.Tensor         # (S, C, K, J, 4) quat (w,x,y,z)
    key_r_in: torch.Tensor      # (S, C, K, J, 4)
    key_r_out: torch.Tensor     # (S, C, K, J, 4)
    key_s: torch.Tensor         # (S, C, K, J)
    key_s_in: torch.Tensor      # (S, C, K, J)
    key_s_out: torch.Tensor     # (S, C, K, J)
    key_count: torch.Tensor     # (S, C) i32
    duration: torch.Tensor      # (S, C) f32
    interp: torch.Tensor        # (S, C) i32 INTERP_*
    clip_count: torch.Tensor    # (S,) i32
    active_clip: torch.Tensor   # (S,) i32
    mesh_skin: torch.Tensor     # (M,) i32 skin per mesh, -1 = rigid
    count: torch.Tensor         # () i32


def empty_skin_tables(limits: SceneLimits) -> dict:
    """The empty Skins tables as numpy arrays (the JAX ``Skins.empty``)."""
    v, s, c, j, k, m = (limits.max_vertices, limits.max_skins, limits.max_clips,
                        limits.max_joints, limits.max_keyframes, limits.max_meshes)
    f32, i32 = np.float32, np.int32
    return dict(
        joints=np.zeros((v, 4), i32), weights=np.zeros((v, 4), f32),
        vertex_skin=np.full((v,), -1, i32), parents=np.full((s, j), -1, i32),
        inverse_bind=np.tile(np.eye(4, dtype=f32), (s, j, 1, 1)),
        joint_count=np.zeros((s,), i32), key_times=np.zeros((s, c, k), f32),
        key_t=np.zeros((s, c, k, j, 3), f32), key_t_in=np.zeros((s, c, k, j, 3), f32),
        key_t_out=np.zeros((s, c, k, j, 3), f32),
        key_r=np.tile(np.array([1, 0, 0, 0], f32), (s, c, k, j, 1)),
        key_r_in=np.zeros((s, c, k, j, 4), f32), key_r_out=np.zeros((s, c, k, j, 4), f32),
        key_s=np.ones((s, c, k, j), f32), key_s_in=np.zeros((s, c, k, j), f32),
        key_s_out=np.zeros((s, c, k, j), f32), key_count=np.zeros((s, c), i32),
        duration=np.ones((s, c), f32), interp=np.zeros((s, c), i32),
        clip_count=np.zeros((s,), i32), active_clip=np.zeros((s,), i32),
        mesh_skin=np.full((m,), -1, i32), count=i32(0),
    )


class Scene(NamedTuple):
    meshes: MeshLibrary
    instances: Instances
    materials: Materials
    lights: Lights
    atlas: TextureAtlas
    skins: Skins


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:  # packed RGBA texels: keep the bits in int32
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def scene_from_numpy(tree, device=None) -> Scene:
    """A scene whose leaves are numpy arrays -> the port's Scene on
    ``device`` (the CUDA card when None). ``tree`` may be the JAX package's
    Scene pulled to the host with ``renderer_tpu.scene.types.as_numpy_scene``
    (its texture quad tables are dropped), or the tables ``SceneBuilder``
    fills."""
    device = resolve_device(device)

    def table(cls, part):
        return cls(**{
            f: (None if getattr(part, f) is None
                else _tensor(getattr(part, f), device))
            for f in cls._fields
        })

    return Scene(
        meshes=table(MeshLibrary, tree.meshes),
        instances=table(Instances, tree.instances),
        materials=table(Materials, tree.materials),
        lights=table(Lights, tree.lights),
        atlas=table(TextureAtlas, tree.atlas),
        skins=table(Skins, tree.skins),
    )
