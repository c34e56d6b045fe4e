"""Host-side scene builder (``renderer_tpu.scene.builder``): accumulates
meshes, materials, instances and lights in numpy, then freezes them into the
fixed-capacity Scene on a device.

The library's triangle order is the JAX builder's exactly (LOD ranges
padded to CLUSTER multiples, each range sorted by ``sort_tris_for_clusters``):
triangle ids, and with them depth-test tie-breaks, depend on it.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np

from renderer_tpu_torch.scene.textures import TextureAtlasBuilder
from renderer_tpu_torch.scene.types import (
    CL_COLS, CLUSTER, INTERP_CUBICSPLINE, INTERP_LINEAR, INTERP_STEP, TR_COLS,
    TRI_REC_MAX_BYTES, MeshLibrary, Scene, SceneLimits, empty_skin_tables, scene_from_numpy,
)


@dataclasses.dataclass
class HostMesh:
    """One mesh's attribute arrays on the host (numpy)."""

    positions: np.ndarray  # (V, 3) f32
    indices: np.ndarray    # (T, 3) i32, mesh-local
    normals: Optional[np.ndarray] = None   # (V, 3)
    uvs: Optional[np.ndarray] = None       # (V, 2)
    tangents: Optional[np.ndarray] = None  # (V, 4)
    lods: Optional[list] = None            # (Ti, 3) index arrays, LOD1+

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32)
        self.indices = np.ascontiguousarray(np.asarray(self.indices, np.int32)).reshape(-1, 3)
        v = len(self.positions)
        if self.normals is None:
            self.normals = compute_vertex_normals(self.positions, self.indices)
        if self.uvs is None:
            self.uvs = np.zeros((v, 2), np.float32)
        if self.tangents is None:
            self.tangents = np.zeros((v, 4), np.float32)
            self.tangents[:, 0] = 1.0
            self.tangents[:, 3] = 1.0


def sort_tris_for_clusters(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reorder one LOD range's triangles by the Morton code of their
    octahedral-mapped face normal, so CLUSTER-sized groups share tight
    normal cones."""
    v = positions[indices]
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    ln = np.linalg.norm(fn, axis=-1, keepdims=True)
    n = fn / np.maximum(ln, 1e-12)
    denom = np.abs(n).sum(axis=-1, keepdims=True)
    p = n[:, :2] / np.maximum(denom, 1e-12)
    neg = n[:, 2] < 0
    fold = (1.0 - np.abs(p[:, ::-1])) * np.where(p >= 0, 1.0, -1.0)
    p = np.where(neg[:, None], fold, p)
    q = np.clip(((p * 0.5 + 0.5) * 1023).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    key = spread(q[:, 0]) | (spread(q[:, 1]) << 1)
    return indices[np.argsort(key, kind="stable")]


def compute_cluster_data(positions, indices, real) -> np.ndarray:
    """Per-cluster bounding sphere + normal cone (object space), CL_* rows.
    indices: (T, 3), T a CLUSTER multiple; real: (T,) excludes padding.
    Degenerate or wide cones store sin > 1 (never backface-culled)."""
    ncl = len(indices) // CLUSTER
    v = positions[indices].reshape(ncl, CLUSTER, 3, 3)
    rm = real.reshape(ncl, CLUSTER)
    fn = np.cross(v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0])
    ln = np.linalg.norm(fn, axis=-1)
    ok_n = rm & (ln > 1e-12)
    n_unit = fn / np.maximum(ln, 1e-12)[..., None]

    out = np.zeros((ncl, CL_COLS), np.float32)
    verts = v.reshape(ncl, CLUSTER * 3, 3)
    wv = np.repeat(rm, 3, axis=1)[..., None]
    center = (verts * wv).sum(axis=1) / np.maximum(wv.sum(axis=1), 1)
    radius = np.sqrt(
        np.max(
            np.where(wv[..., 0], ((verts - center[:, None]) ** 2).sum(-1), 0.0),
            axis=1,
        )
    )
    axis = (n_unit * ok_n[..., None]).sum(axis=1)
    alen = np.linalg.norm(axis, axis=-1)
    axis = axis / np.maximum(alen, 1e-12)[:, None]
    cosang = np.where(ok_n, (n_unit * axis[:, None]).sum(-1), 1.0).min(axis=1)
    degenerate = (rm & ~ok_n).any(axis=1) | (alen < 1e-6) | (cosang < 0.1)
    cosang = np.clip(cosang, -1.0, 1.0)
    sinang = np.sqrt(np.maximum(1.0 - cosang * cosang, 0.0))
    sinang = np.where(degenerate, 2.0, sinang)
    out[:, 0:3] = center
    out[:, 3] = radius
    out[:, 4:7] = axis
    out[:, 7] = np.where(degenerate, -1.0, cosang)
    out[:, 8] = sinang
    out[:, 9] = rm.sum(axis=1)
    return out


def compute_vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals."""
    p = positions
    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    fn = np.cross(p[i1] - p[i0], p[i2] - p[i0])
    n = np.zeros_like(p)
    for k in range(3):
        np.add.at(n, indices[:, k], fn)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(lens, 1e-20)).astype(np.float32)


class SceneBuilder:
    def __init__(self, limits: SceneLimits = SceneLimits(), atlas_size: int = 256):
        self.limits = limits
        self.atlas = TextureAtlasBuilder(size=atlas_size, max_layers=limits.max_textures)
        self._meshes: list[HostMesh] = []
        self._materials: list[dict] = []
        self._instances: list[dict] = []
        self._lights: list[dict] = []
        self._skins: list[dict] = []

    def add_texture(self, img) -> int:
        """Add a texture image; returns its atlas layer id."""
        return self.atlas.add(img)

    def add_mesh(self, mesh: HostMesh, auto_lods: bool = False) -> int:
        """auto_lods builds a simplified LOD chain (scene/simplify.py)."""
        if len(self._meshes) >= self.limits.max_meshes:
            raise ValueError("mesh library full")
        if auto_lods and mesh.lods is None and len(mesh.indices) > 64:
            from renderer_tpu_torch.scene.simplify import build_lod_chain

            mesh.lods = build_lod_chain(mesh.positions, mesh.indices)
        self._meshes.append(mesh)
        return len(self._meshes) - 1

    def add_skinned_mesh(self, mesh: HostMesh, joints, weights, parents, inverse_bind,
                         key_times, key_t, key_r, key_s=None, interpolation: str = "LINEAR",
                         key_t_tangents=None, key_r_tangents=None, key_s_tangents=None) -> int:
        """A mesh with linear-blend skinning and its first clip: joints (V, 4)
        and weights (V, 4) per vertex, parents (J,) (-1 a root, each parent
        before its child), inverse_bind (J, 4, 4); the clip as in
        ``add_skin_clip``. Returns the mesh id."""
        lim = self.limits
        if len(self._skins) >= lim.max_skins:
            raise ValueError("skin table full")
        if len(parents) > lim.max_joints:
            raise ValueError(f"too many joints ({len(parents)} > {lim.max_joints})")
        if len(key_times) > lim.max_keyframes:
            raise ValueError(f"too many keyframes ({len(key_times)} > {lim.max_keyframes})")
        if any(p >= j for j, p in enumerate(np.asarray(parents))):
            raise ValueError("parents must be topologically ordered (parent < child)")
        mesh_id = self.add_mesh(mesh)
        self._skins.append(dict(
            mesh_id=mesh_id, joints=np.asarray(joints, np.int32),
            weights=np.asarray(weights, np.float32), parents=np.asarray(parents, np.int32),
            inverse_bind=np.asarray(inverse_bind, np.float32), clips=[],
        ))
        self.add_skin_clip(mesh_id, key_times, key_t, key_r, key_s, interpolation=interpolation,
                           key_t_tangents=key_t_tangents, key_r_tangents=key_r_tangents,
                           key_s_tangents=key_s_tangents)
        return mesh_id

    def add_skin_clip(self, mesh_id: int, key_times, key_t, key_r, key_s=None,
                      interpolation: str = "LINEAR", key_t_tangents=None, key_r_tangents=None,
                      key_s_tangents=None) -> int:
        """Add a clip to a skinned mesh: key_times (K,), key_t (K, J, 3),
        key_r (K, J, 4) quaternions, key_s (K, J) (ones when None);
        interpolation LINEAR, STEP or CUBICSPLINE, the last with (in, out)
        tangent pairs shaped like the keys. Returns the clip index
        (``ops.skin.set_active_clip`` selects it)."""
        skin = next((d for d in self._skins if d["mesh_id"] == mesh_id), None)
        if skin is None:
            raise ValueError(f"mesh {mesh_id} is not skinned")
        if len(skin["clips"]) >= self.limits.max_clips:
            raise ValueError("clip table full")
        k, j = len(key_times), len(skin["parents"])
        if k > self.limits.max_keyframes:
            raise ValueError(f"too many keyframes ({k} > {self.limits.max_keyframes})")
        mode = {"LINEAR": INTERP_LINEAR, "STEP": INTERP_STEP,
                "CUBICSPLINE": INTERP_CUBICSPLINE}[interpolation]
        zero3, zero4 = np.zeros((k, j, 3), np.float32), np.zeros((k, j, 4), np.float32)
        zero1 = np.zeros((k, j), np.float32)
        t_in, t_out = key_t_tangents or (zero3, zero3)
        r_in, r_out = key_r_tangents or (zero4, zero4)
        s_in, s_out = key_s_tangents or (zero1, zero1)
        f32 = np.float32
        skin["clips"].append(dict(
            key_times=np.asarray(key_times, f32), key_t=np.asarray(key_t, f32),
            key_r=np.asarray(key_r, f32),
            key_s=np.ones((k, j), f32) if key_s is None else np.asarray(key_s, f32),
            key_t_in=np.asarray(t_in, f32), key_t_out=np.asarray(t_out, f32),
            key_r_in=np.asarray(r_in, f32), key_r_out=np.asarray(r_out, f32),
            key_s_in=np.asarray(s_in, f32), key_s_out=np.asarray(s_out, f32), interp=mode,
        ))
        return len(skin["clips"]) - 1

    def _skin_tables(self, mesh_vertex_offset) -> dict:
        sk = empty_skin_tables(self.limits)
        for si, d in enumerate(self._skins):
            voff = int(mesh_vertex_offset[d["mesh_id"]])
            v, j = len(d["joints"]), len(d["parents"])
            sk["joints"][voff : voff + v] = d["joints"]
            sk["weights"][voff : voff + v] = d["weights"]
            sk["vertex_skin"][voff : voff + v] = si
            sk["parents"][si, :j] = d["parents"]
            sk["inverse_bind"][si, :j] = d["inverse_bind"]
            sk["joint_count"][si] = j
            for ci, clip in enumerate(d["clips"]):
                k = len(clip["key_times"])
                sk["key_times"][si, ci, :k] = clip["key_times"]
                sk["key_times"][si, ci, k:] = clip["key_times"][-1]  # clamp pad
                for name in ("key_t", "key_r", "key_s", "key_t_in", "key_t_out",
                             "key_r_in", "key_r_out", "key_s_in", "key_s_out"):
                    sk[name][si, ci, :k, :j] = clip[name]
                    sk[name][si, ci, k:, :j] = clip[name][-1]
                sk["key_count"][si, ci] = k
                sk["duration"][si, ci] = clip["key_times"][-1]
                sk["interp"][si, ci] = clip["interp"]
            sk["clip_count"][si] = len(d["clips"])
            sk["mesh_skin"][d["mesh_id"]] = si
        sk["count"] = np.int32(len(self._skins))
        return sk

    def add_material(self, base_color=(1.0, 1.0, 1.0, 1.0), metallic=0.0,
                     roughness=0.8, emissive=(0.0, 0.0, 0.0), base_color_tex=-1,
                     normal_tex=-1) -> int:
        if len(self._materials) >= self.limits.max_materials:
            raise ValueError("material table full")
        self._materials.append(dict(
            base_color_factor=np.asarray(base_color, np.float32),
            metallic=float(metallic), roughness=float(roughness),
            emissive=np.asarray(emissive, np.float32),
            base_color_tex=int(base_color_tex), normal_tex=int(normal_tex),
        ))
        return len(self._materials) - 1

    def add_instance(self, mesh_id: int, material_id: int = 0,
                     translation=(0.0, 0.0, 0.0), rotation=(1.0, 0.0, 0.0, 0.0),
                     scale=1.0) -> int:
        if len(self._instances) >= self.limits.max_instances:
            raise ValueError("instance table full")
        self._instances.append(dict(
            mesh_id=int(mesh_id), material_id=int(material_id),
            translation=np.asarray(translation, np.float32),
            rotation=np.asarray(rotation, np.float32), scale=float(scale),
        ))
        return len(self._instances) - 1

    def add_light(self, position, color=(1.0, 1.0, 1.0), intensity=1.0,
                  directional=False, shadow_slot=-1) -> int:
        if len(self._lights) >= self.limits.max_lights:
            raise ValueError("light table full")
        self._lights.append(dict(
            position=np.asarray(position, np.float32),
            color=np.asarray(color, np.float32), intensity=float(intensity),
            directional=bool(directional), shadow_slot=int(shadow_slot),
        ))
        return len(self._lights) - 1

    def _mesh_tables(self) -> dict:
        lim = self.limits
        V, T, M, L = lim.max_vertices, lim.max_triangles, lim.max_meshes, MeshLibrary.MAX_LODS
        f32, i32 = np.float32, np.int32
        with_rec = T * 512 <= TRI_REC_MAX_BYTES
        lib = dict(
            positions=np.zeros((V, 3), f32), normals=np.zeros((V, 3), f32),
            tangents=np.zeros((V, 4), f32), uvs=np.zeros((V, 2), f32),
            indices=np.zeros((T, 3), i32),
            vertex_count=i32(0), tri_count=i32(0), mesh_count=i32(0),
            mesh_vertex_offset=np.zeros((M,), i32),
            mesh_vertex_count=np.zeros((M,), i32),
            lod_index_offset=np.zeros((M, L), i32),
            lod_tri_count=np.zeros((M, L), i32),
            mesh_aabb_min=np.zeros((M, 3), f32), mesh_aabb_max=np.zeros((M, 3), f32),
            tri_rec=np.zeros((T, TR_COLS), f32) if with_rec else None,
            cluster_data=np.zeros((T // CLUSTER, CL_COLS), f32) if with_rec else None,
        )

        def ceil_cl(t):
            return -(-t // CLUSTER) * CLUSTER

        voff = toff = 0
        real_tri = np.zeros(T, bool)  # excludes cluster padding
        for m, mesh in enumerate(self._meshes):
            v = len(mesh.positions)
            lods = [mesh.indices] + list(mesh.lods or [])
            if len(lods) > L:
                raise ValueError(f"too many LODs ({len(lods)} > {L})")
            total_t = sum(ceil_cl(len(ix)) for ix in lods)
            if voff + v > V or toff + total_t > T:
                raise ValueError("mesh library capacity exceeded")
            lib["positions"][voff : voff + v] = mesh.positions
            lib["normals"][voff : voff + v] = mesh.normals
            lib["uvs"][voff : voff + v] = mesh.uvs
            lib["tangents"][voff : voff + v] = mesh.tangents
            lib["mesh_vertex_offset"][m] = voff
            lib["mesh_vertex_count"][m] = v
            lib["mesh_aabb_min"][m] = mesh.positions.min(axis=0)
            lib["mesh_aabb_max"][m] = mesh.positions.max(axis=0)
            for l, ix in enumerate(lods):
                ix = np.ascontiguousarray(np.asarray(ix, np.int32)).reshape(-1, 3)
                t = len(ix)
                if t > CLUSTER:
                    ix = sort_tris_for_clusters(mesh.positions, ix)
                lib["indices"][toff : toff + t] = ix + voff
                lib["lod_index_offset"][m, l] = toff
                lib["lod_tri_count"][m, l] = t
                real_tri[toff : toff + t] = True
                toff += ceil_cl(t)
            for l in range(len(lods), L):  # missing LODs repeat the last one
                lib["lod_index_offset"][m, l] = lib["lod_index_offset"][m, len(lods) - 1]
                lib["lod_tri_count"][m, l] = lib["lod_tri_count"][m, len(lods) - 1]
            voff += v
        lib["vertex_count"] = i32(voff)
        lib["tri_count"] = i32(toff)
        lib["mesh_count"] = i32(len(self._meshes))
        if with_rec and toff > 0:
            idx = lib["indices"][:toff]
            rec = np.concatenate(
                [
                    lib["positions"][idx].reshape(toff, 9),
                    lib["normals"][idx].reshape(toff, 9),
                    lib["uvs"][idx].reshape(toff, 6),
                    lib["tangents"][idx].reshape(toff, 12),
                ],
                axis=1,
            )
            rec[~real_tri[:toff]] = 0.0  # cluster padding: fully degenerate
            lib["tri_rec"][:toff] = rec
            lib["cluster_data"][: toff // CLUSTER] = compute_cluster_data(
                lib["positions"], idx, real_tri[:toff]
            )
        return lib

    def build(self, texture_slots: int = None, device=None) -> Scene:
        """Consolidate into the fixed-capacity Scene on ``device`` (the
        CUDA card when None).
        texture_slots preallocates atlas layers, as in the JAX builder."""
        lim = self.limits
        N, K, L = lim.max_instances, lim.max_materials, lim.max_lights
        f32, i32 = np.float32, np.int32
        inst = dict(
            translation=np.zeros((N, 3), f32),
            rotation=np.tile(np.array([1.0, 0, 0, 0], f32), (N, 1)),
            scale=np.ones((N,), f32), mesh_id=np.zeros((N,), i32),
            material_id=np.zeros((N,), i32), alive=np.zeros((N,), bool),
        )
        mats = dict(
            base_color_factor=np.ones((K, 4), f32), metallic=np.zeros((K,), f32),
            roughness=np.full((K,), 0.8, f32), emissive=np.zeros((K, 3), f32),
            base_color_tex=np.full((K,), -1, i32), normal_tex=np.full((K,), -1, i32),
        )
        lts = dict(
            position=np.zeros((L, 3), f32), color=np.ones((L, 3), f32),
            intensity=np.ones((L,), f32), directional=np.zeros((L,), bool),
            shadow_slot=np.full((L,), -1, i32), alive=np.zeros((L,), bool),
        )
        for table, rows in ((inst, self._instances), (mats, self._materials),
                            (lts, self._lights)):
            for i, row in enumerate(rows):
                for k, val in row.items():
                    table[k][i] = val
                if "alive" in table:
                    table["alive"][i] = True
            table["count"] = i32(len(rows))
        lib = self._mesh_tables()
        tree = SimpleNamespace(
            meshes=SimpleNamespace(**lib),
            instances=SimpleNamespace(**inst),
            materials=SimpleNamespace(**mats),
            lights=SimpleNamespace(**lts),
            atlas=self.atlas.build(preallocate=texture_slots),
            skins=SimpleNamespace(**self._skin_tables(lib["mesh_vertex_offset"])),
        )
        return scene_from_numpy(tree, device)

