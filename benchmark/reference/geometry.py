"""Frozen copy of the port's ``renderer_tpu_torch/ops/geometry.py`` (the benchmark's plain
reference; it imports nothing of the port, and the port may change
without it). What follows is the original's docstring.

Geometry stage (``renderer_tpu.ops.geometry``): instance matrices,
coarse cull and LOD pick, draw-stream expansion, per-triangle cull, the
Morton sort and the packed shade records.

Quantities are computed as flat per-instance or per-triangle columns with
the JAX package's expressions, term by term and in its order. The port
leaves out the TPU layout devices of the reference (transposing identity
dots, integer ids packed into float columns): plain gathers and stacks
take their place. Both draw-stream builds are ported: the ``tri_rec``
fast path, with and without cluster culling, and the per-corner two-phase
build that a posed (skinned) scene takes; so is the re-expansion of a
frozen draw list.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.constants import FRONT_DET_SIGN
from benchmark.reference.camera import Camera, _cross3, camera_matrices, frustum_planes
from benchmark.reference.cull import INVALID_KEY, _morton2d, scatter_kept
from benchmark.reference.constants import (
    CL_AXIS, CL_CENTER, CL_COS, CL_COUNT, CL_RADIUS, CL_SIN, CLUSTER, TR_NRM, TR_POS, TR_TAN,
    TR_UV,
)


class TriangleSoup(NamedTuple):
    """Fixed-capacity triangle stream (the raster input). After the cull the
    surviving triangles are the sorted prefix ``[0, count)`` and the shading
    attributes live in the shade records, row for row; the corner
    attributes are None there. A frozen draw list's soup and the debug box
    soup carry them (the JAX package's ``want_soup_attrs``).

    clip:     (T, 3, 4) clip-space corners
    instance: (T,) owning instance id (int64)
    valid:    (T,) bool
    count:    () live slots
    tri_idx:  (T,) library-global triangle index (int64)
    tex_lod:  (T,) per-triangle base texture LOD
    normal:   (T, 3, 3) world-space corner normals, or None
    uv:       (T, 3, 2) corner uvs, or None
    tangent:  (T, 3, 4) world-space corner tangents (xyz) + handedness (w), or None
    """

    clip: torch.Tensor
    instance: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    tri_idx: torch.Tensor
    tex_lod: torch.Tensor
    normal: torch.Tensor = None
    uv: torch.Tensor = None
    tangent: torch.Tensor = None


class DrawList(NamedTuple):
    """Which (instance, library triangle) pairs draw: the cull's result
    without the camera, kept as persistent state. Freeze culling renders
    the kept list under the live camera.

    owner:   (T,) instance id (int64)
    tri_idx: (T,) library-global triangle index (int64)
    valid:   (T,) bool
    count:   () int32
    """

    owner: torch.Tensor
    tri_idx: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def empty(capacity: int, device) -> "DrawList":
        zeros = torch.zeros((capacity,), dtype=torch.int64, device=device)
        return DrawList(owner=zeros, tri_idx=zeros.clone(),
                        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
                        count=torch.zeros((), dtype=torch.int32, device=device))


class Prepared(NamedTuple):
    """The prepare pass's result."""

    model: torch.Tensor      # (N, 16) row-major model matrices
    vp: torch.Tensor         # (4, 4) viewproj
    clip_mats: torch.Tensor  # (N, 16) viewproj @ model
    visible: torch.Tensor    # (N,) bool coarse-cull survivors
    lod: torch.Tensor        # (N,) int64
    vp_inv: torch.Tensor     # (4, 4)
    scene_min: torch.Tensor  # (3,) world AABB of the alive instances
    scene_max: torch.Tensor  # (3,)
    camera_pos: torch.Tensor  # (3,) the eye (cluster culling's cone test)


# Shade-record columns: one 64-float row per surviving triangle holds all a
# pixel needs. 40..48 are the oriented edge coefficients at render
# resolution, from which shading re-derives barycentrics (the raster pass
# stores depth and triangle id only).
SR_NORMAL = 0    # 0..8   corner normals (c0.xyz, c1.xyz, c2.xyz)
SR_UV = 9        # 9..14  corner uvs
SR_TANGENT = 15  # 15..26 corner tangents (xyzw x3)
SR_TEXLOD = 27
SR_INSTANCE = 28
SR_BASE = 29     # 29..32 base color rgba
SR_METALLIC = 33
SR_ROUGH = 34
SR_EMISSIVE = 35  # 35..37
SR_BC_LAYER = 38
SR_NM_LAYER = 39
SR_EDGE = 40     # 40..48 (e0:a,b,c, e1:..., e2:...)
SR_COLS = 64


def mats44(m: torch.Tensor) -> torch.Tensor:
    """(N, 4, 4) view of per-instance matrices; accepts flat (N, 16) rows."""
    return m if m.dim() == 3 else m.reshape(m.shape[0], 4, 4)


def _world_aabb_cols(scene: Scene, m: list):
    """World AABB columns of every instance from its model matrix columns
    ``m[i][j]`` (rows i < 3): (centre (3 x (N,)), half extent, local min
    (3, N), local max (3, N)), with the |linear| bound of an affine map."""
    lib = scene.meshes
    mesh_id = scene.instances.mesh_id.long()
    mn_t = lib.mesh_aabb_min[mesh_id].T
    mx_t = lib.mesh_aabb_max[mesh_id].T
    c_loc = [(mn_t[k] + mx_t[k]) * 0.5 for k in range(3)]
    e_loc = [(mx_t[k] - mn_t[k]) * 0.5 for k in range(3)]
    cw = [
        m[i][0] * c_loc[0] + m[i][1] * c_loc[1] + m[i][2] * c_loc[2] + m[i][3]
        for i in range(3)
    ]
    ew = [
        m[i][0].abs() * e_loc[0] + m[i][1].abs() * e_loc[1] + m[i][2].abs() * e_loc[2]
        for i in range(3)
    ]
    return cw, ew, mn_t, mx_t


def _outside_frustum(viewproj: torch.Tensor, cw: list, ew: list) -> torch.Tensor:
    """(..., N) bool: the AABB lies wholly outside one of the six planes of
    the (..., 4, 4) viewproj. The six planes are tested at once."""
    planes = frustum_planes(viewproj)[..., None]  # (..., 6, 4, 1) against (N,) columns
    a, b, c, d = (planes[..., k, :] for k in range(4))  # (..., 6, 1) each
    dist = a * cw[0] + b * cw[1] + c * cw[2] + d
    rr = a.abs() * ew[0] + b.abs() * ew[1] + c.abs() * ew[2]
    return (dist + rr < 0.0).any(dim=-2)


def coarse_cull(scene: Scene, model: torch.Tensor, viewproj: torch.Tensor) -> torch.Tensor:
    """Instance-level frustum cull of world AABBs -> (..., N) bool visible
    under each (..., 4, 4) viewproj, with the camera cull's arithmetic
    (``prepare_frame_columns``). ``model`` is (N, 16) rows or (N, 4, 4)."""
    cw, ew, _, _ = _world_aabb_cols(scene, _cols_of(model))
    return scene.instances.alive & ~_outside_frustum(viewproj, cw, ew)


def _model_cols(inst) -> list:
    """The model matrix of every instance as columns ``m[i][j]`` (rows i <
    3; the fourth row is (0, 0, 0, 1)): rotation times uniform scale, then
    the translation."""
    tt = inst.translation.T
    qt = inst.rotation.T
    s = inst.scale
    w, x, y, z = qt[0], qt[1], qt[2], qt[3]
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return [[r[i][j] * s for j in range(3)] + [tt[i]] for i in range(3)]


def _model_rows(m: list) -> torch.Tensor:
    """(N, 16) row-major matrices from ``_model_cols``'s columns."""
    zero, one = torch.zeros_like(m[0][0]), torch.ones_like(m[0][0])
    return torch.stack(m[0] + m[1] + m[2] + [zero, zero, zero, one], dim=-1)


def _cols_of(model: torch.Tensor) -> list:
    """The columns ``m[i][j]`` (rows i < 3) of (N, 16) or (N, 4, 4) matrices."""
    flat = mats44(model).reshape(-1, 16)
    return [[flat[:, 4 * i + j] for j in range(4)] for i in range(3)]


def _clip_mat_cols(vp: torch.Tensor, m: list) -> list:
    """The 16 columns of vp @ model, row-major, from the model's columns
    (its fourth row (0, 0, 0, 1)), each sum taken left to right."""
    cols = []
    for i in range(4):
        for j in range(4):
            c = vp[i, 0] * m[0][j] + vp[i, 1] * m[1][j] + vp[i, 2] * m[2][j]
            if j == 3:
                c = c + vp[i, 3]
            cols.append(c)
    return cols


def _lod_cols(scene: Scene, cw: list, mn_t, mx_t, eye: torch.Tensor) -> torch.Tensor:
    """(N,) distance LOD: log2 of a quarter of the distance from ``eye`` to
    the world AABB centre ``cw`` over the bounding radius, floored and
    clamped to the library's levels."""
    s = scene.instances.scale
    dx, dy, dz = cw[0] - eye[0], cw[1] - eye[1], cw[2] - eye[2]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    radius = torch.sqrt(
        (mx_t[0] - mn_t[0]) ** 2 + (mx_t[1] - mn_t[1]) ** 2 + (mx_t[2] - mn_t[2]) ** 2
    ) * (0.5 * s)
    ratio = radius / torch.clamp(dist, min=1e-6)
    lod = torch.floor(torch.log2(torch.clamp(0.25 / torch.clamp(ratio, min=1e-6), min=1.0)))
    return torch.clamp(lod, 0, scene.meshes.lod_tri_count.shape[1] - 1).long()


def prepare_frame_columns(scene: Scene, camera: Camera) -> Prepared:
    """Model and clip matrices, coarse frustum cull of world AABBs, the
    distance LOD pick and the scene bounds, all as (N,) column math."""
    inst = scene.instances
    m = _model_cols(inst)
    _, _, vp = camera_matrices(camera)
    cw, ew, mn_t, mx_t = _world_aabb_cols(scene, m)
    visible = inst.alive & ~_outside_frustum(vp, cw, ew)
    lod = _lod_cols(scene, cw, mn_t, mx_t, camera.position)

    # scene bounds over the alive instances (the light cameras' fit)
    big = 1e9
    scene_min = torch.stack([torch.where(inst.alive, cw[k] - ew[k], big).min() for k in range(3)])
    scene_max = torch.stack([torch.where(inst.alive, cw[k] + ew[k], -big).max() for k in range(3)])

    clip_mats = torch.stack(_clip_mat_cols(vp, m), dim=-1)
    vp_inv = torch.linalg.inv_ex(vp).inverse
    return Prepared(_model_rows(m), vp, clip_mats, visible, lod, vp_inv, scene_min, scene_max,
                    camera.position)


def _slot_map_starts(counts: torch.Tensor, capacity: int):
    """Expansion slot map: slot -> (owner, start of the owner's run) via one
    scatter-max of packed (owner, start) keys and a running max. Returns
    (owner, start, slots, valid, total)."""
    n = counts.shape[0]
    dev = counts.device
    counts = counts.long()
    ends = torch.cumsum(counts, 0)
    total = ends[-1]
    starts = ends - counts
    dest = torch.where((counts > 0) & (starts < capacity), starts, capacity)
    bits_s = max(1, (capacity - 1).bit_length())
    key = (torch.arange(n, device=dev) << bits_s) | starts
    mark = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    mark.scatter_reduce_(0, dest, key, reduce="amax")  # slot `capacity` = dropped
    run = torch.cummax(mark[:capacity], 0).values
    owner = run >> bits_s
    start = run & ((1 << bits_s) - 1)
    slots = torch.arange(capacity, device=dev)
    return owner, start, slots, slots < total, total


def _slot_map_counts(counts: torch.Tensor, base_i: torch.Tensor, capacity: int):
    """The slot map with each slot's source index base_i[owner] + local (0
    past the total). Returns (owner, idx, valid, total)."""
    owner, start, slots, valid, total = _slot_map_starts(counts, capacity)
    return owner, torch.where(valid, base_i.long()[owner] + (slots - start), 0), valid, total


def _lod_tri_counts(scene: Scene, visible: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
    """(N,) triangles each instance expands at its LOD, 0 when not visible."""
    mesh_id = scene.instances.mesh_id.long()
    return torch.where(visible, scene.meshes.lod_tri_count[mesh_id, lod], 0)


def _cluster_slot_map(scene: Scene, visible, lod, expand_capacity: int, model, camera_pos, vp,
                      cull_backface: bool):
    """Two-level expansion with culling at cluster grain. Level 1 maps
    slots to the visible instances' 32-triangle clusters (a list with 2x
    headroom) and culls whole clusters: bounding sphere against the
    frustum, and, with ``cull_backface``, the normal cone against the eye
    for spheres wholly past the near plane. Level 2 expands the surviving
    clusters by their real (unpadded) triangle counts. Returns (owner,
    tri_idx, valid), owner and tri_idx 0 past the total."""
    inst = scene.instances
    lib = scene.meshes
    n = inst.mesh_id.shape[0]
    if expand_capacity % CLUSTER:
        raise ValueError(f"cluster culling needs expand_capacity % {CLUSTER} == 0")
    n_cc = 2 * (expand_capacity // CLUSTER)
    mesh_id = inst.mesh_id.long()
    ci = (_lod_tri_counts(scene, visible, lod) + CLUSTER - 1) // CLUSTER
    base_c = lib.lod_index_offset[mesh_id, lod] // CLUSTER
    owner_c, cl_idx, keep, _ = _slot_map_counts(ci, base_c, n_cc)

    cdt = lib.cluster_data[cl_idx].T  # (CL_COLS, n_cc)
    # the real prefix of each cluster: padding slots are dropped by count
    real_count = cdt[CL_COUNT].long()
    mt = model[owner_c].T  # (16, n_cc)
    sc = inst.scale[owner_c]
    c0, c1, c2 = cdt[CL_CENTER], cdt[CL_CENTER + 1], cdt[CL_CENTER + 2]
    cw = [mt[4 * i] * c0 + mt[4 * i + 1] * c1 + mt[4 * i + 2] * c2 + mt[4 * i + 3]
          for i in range(3)]
    r_w = cdt[CL_RADIUS] * sc
    planes = frustum_planes(vp)
    for p in range(6):
        d = planes[p, 0] * cw[0] + planes[p, 1] * cw[1] + planes[p, 2] * cw[2] + planes[p, 3]
        keep = keep & ~(d < -r_w)
        if p == 4:
            d_near = d
    if cull_backface:
        a0, a1, a2 = cdt[CL_AXIS], cdt[CL_AXIS + 1], cdt[CL_AXIS + 2]
        # the axis through the model's linear part has length `scale`, so the
        # cone test is multiplied through by it:
        #   cos*dot(axis_s, u) + s*sin*|u| + s*r_w < 0   (u = eye - centre)
        aw = [mt[4 * i] * a0 + mt[4 * i + 1] * a1 + mt[4 * i + 2] * a2 for i in range(3)]
        u = [camera_pos[k] - cw[k] for k in range(3)]
        ulen = torch.sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2])
        dot_au = aw[0] * u[0] + aw[1] * u[1] + aw[2] * u[2]
        backfacing = cdt[CL_COS] * dot_au + sc * cdt[CL_SIN] * ulen + sc * r_w < 0
        # a sphere reaching the eye plane may hold w-crossing triangles whose
        # clip-space facing differs from the world-space test
        keep = keep & ~(backfacing & (d_near > r_w))

    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, n_cc)
    c_slot, idx, valid, _ = _slot_map_counts(scatter_kept(dest, real_count, n_cc),
                                             scatter_kept(dest, cl_idx * CLUSTER, n_cc),
                                             expand_capacity)
    owner = torch.where(valid, scatter_kept(dest, owner_c, n_cc)[c_slot], 0)
    return torch.clamp(owner, 0, n - 1), idx, valid


def _clip_cols(rt: torch.Tensor, mt: torch.Tensor) -> list:
    """12 clip columns [c0 xyzw, c1, c2] from transposed tri records
    (36, E) and transposed per-triangle clip matrices (16, E)."""
    cols = []
    for c in range(3):
        x, y, z = rt[TR_POS + 3 * c], rt[TR_POS + 3 * c + 1], rt[TR_POS + 3 * c + 2]
        for j in range(4):
            cols.append(x * mt[4 * j] + y * mt[4 * j + 1] + z * mt[4 * j + 2] + mt[4 * j + 3])
    return cols


def expand_clip_only(scene: Scene, visible: torch.Tensor, lod: torch.Tensor,
                     clip_mats: torch.Tensor, capacity: int):
    """Positions-only draw-stream expansion -> (clip (T, 3, 4), valid (T,),
    count ()): every triangle of the visible instances at their LOD, through
    each instance's clip matrix (``clip_mats`` (N, 16) rows or (N, 4, 4)),
    with no cull, sort or attributes (a light's caster stream). Triangles
    past ``capacity`` are cut off, as in the JAX package."""
    lib = scene.meshes
    base_i = lib.lod_index_offset[scene.instances.mesh_id.long(), lod]
    owner, tri_idx, valid, total = _slot_map_counts(_lod_tri_counts(scene, visible, lod),
                                                    base_i, capacity)
    if lib.tri_rec is None:  # per-corner: the posed vertex pool
        clip = _corner_map(lib.positions[lib.indices[tri_idx].long()],
                           mats44(clip_mats)[owner], True)
    else:
        positions = lib.tri_rec[:, : TR_POS + 9]  # the corner positions only
        cc = _clip_cols(positions[tri_idx].T.contiguous(),
                        mats44(clip_mats).reshape(-1, 16)[owner].T.contiguous())
        clip = torch.stack(cc, dim=1).reshape(capacity, 3, 4)
    return clip, valid, torch.clamp(total, max=capacity).to(torch.int32)


def _cull_and_keys(x: list, y: list, z: list, w: list, valid: torch.Tensor,
                   cull_backface: bool):
    """Per-triangle frustum and backface test and Morton sort key from the
    clip columns of the three corners: (kept mask, key, INVALID_KEY where
    dropped)."""

    def all3(f):
        return f(0) & f(1) & f(2)

    out = all3(lambda c: x[c] < -w[c])
    out |= all3(lambda c: x[c] > w[c])
    out |= all3(lambda c: y[c] < -w[c])
    out |= all3(lambda c: y[c] > w[c])
    out |= all3(lambda c: z[c] < 0)
    out |= all3(lambda c: z[c] > w[c])
    # backface: the determinant of the pixel-homogeneous corners at 2x2
    u0 = [x[c] + w[c] for c in range(3)]
    u1 = [w[c] - y[c] for c in range(3)]
    u2 = w
    det = (
        u0[0] * (u1[1] * u2[2] - u1[2] * u2[1])
        - u0[1] * (u1[0] * u2[2] - u1[2] * u2[0])
        + u0[2] * (u1[0] * u2[1] - u1[1] * u2[0])
    )
    mask = valid & ~out
    mask &= (det * FRONT_DET_SIGN > 0) if cull_backface else (det != 0)
    return mask, _morton_keys(x, y, w, mask)


def _morton_keys(x: list, y: list, w: list, mask: torch.Tensor) -> torch.Tensor:
    """The Morton code of each triangle's screen-bbox centre on a 1024^2
    grid, from its corners' clip columns; INVALID_KEY where ``mask`` is
    False."""

    def all3(f):
        return f(0) & f(1) & f(2)

    safe = [torch.where(wc.abs() > 1e-9, wc, 1e-9) for wc in w]
    all_front = all3(lambda c: w[c] > 1e-9)
    px = [x[c] / safe[c] for c in range(3)]
    py = [y[c] / safe[c] for c in range(3)]
    cx = torch.clamp(
        (torch.minimum(torch.minimum(px[0], px[1]), px[2])
         + torch.maximum(torch.maximum(px[0], px[1]), px[2])) * 0.25 + 0.5, 0.0, 1.0)
    cy = torch.clamp(
        (torch.minimum(torch.minimum(py[0], py[1]), py[2])
         + torch.maximum(torch.maximum(py[0], py[1]), py[2])) * -0.25 + 0.5, 0.0, 1.0)
    gx = torch.where(all_front, (cx * 1023).long(), 0)
    gy = torch.where(all_front, (cy * 1023).long(), 0)
    return torch.where(mask, _morton2d(gx, gy), INVALID_KEY)


def expand_cull_sort_two_phase(scene: Scene, prepared: Prepared, expand_capacity: int,
                               out_capacity: int, width: int, height: int,
                               cull_backface: bool = True) -> TriangleSoup:
    """The per-corner draw-stream build for a scene without ``tri_rec``.
    Phase A expands clip positions only, gathered per corner from the
    vertex pool, at ``expand_capacity`` and culls and sorts them as the
    fast path does; phase B gathers the survivors' corner attributes at
    ``out_capacity``. Returns the soup with its corner attributes and
    ``tex_lod``."""
    lib = scene.meshes
    inst = scene.instances
    tc = _lod_tri_counts(scene, prepared.visible, prepared.lod)
    base_i = lib.lod_index_offset[inst.mesh_id.long(), prepared.lod]
    owner, tri_idx, valid, _ = _slot_map_counts(tc, base_i, expand_capacity)
    clip = _corner_map(lib.positions[lib.indices[tri_idx].long()],
                       mats44(prepared.clip_mats)[owner], True)  # (E, 3, 4)
    x, y, z, w = ([clip[:, c, k] for c in range(3)] for k in range(4))
    mask, key = _cull_and_keys(x, y, z, w, valid, cull_backface)
    count = torch.clamp(mask.sum(), max=out_capacity).to(torch.int32)
    perm = torch.sort(key, stable=True).indices[:out_capacity]

    owner_s, tri_s = owner[perm], tri_idx[perm]
    vidx = lib.indices[tri_s].long()
    lin = mats44(prepared.model)[owner_s]
    tan = lib.tangents[vidx]
    soup = TriangleSoup(
        clip=clip[perm], instance=owner_s,
        valid=torch.arange(out_capacity, device=count.device) < count, count=count,
        tri_idx=tri_s, tex_lod=torch.zeros((out_capacity,), dtype=torch.float32,
                                           device=count.device),
        normal=_corner_map(lib.normals[vidx], lin, False), uv=lib.uvs[vidx],
        tangent=torch.cat([_corner_map(tan[..., :3], lin, False), tan[..., 3:]], dim=-1))
    return finalize_tex_lod(soup, width, height, scene.atlas.level_size[0])


def build_draw_stream(
    scene: Scene,
    prepared: Prepared,
    expand_capacity: int,
    out_capacity: int,
    width: int,
    height: int,
    cull_backface: bool = True,
    cluster_cull: bool = False,
    want_soup_attrs: bool = False,
):
    """Expansion + per-triangle frustum/backface cull + Morton sort +
    shade-record build. Returns (TriangleSoup, (T, SR_COLS) shade records).
    With ``cluster_cull`` the expansion culls whole clusters first
    (``_cluster_slot_map``).

    Survivors sort by the Morton code of their screen-bbox centre, ties by
    expansion slot (a stable sort), so the order is the JAX package's. A
    scene without ``tri_rec`` (posed by skinning) takes the per-corner
    build, ``expand_cull_sort_two_phase``, without cluster culling (its
    cluster bounds are the rest pose's), as in the JAX package. With
    ``want_soup_attrs`` the soup also carries its corner attributes (the
    Lambert shading reads them); the per-corner build always does."""
    lib = scene.meshes
    if lib.tri_rec is None:
        soup = expand_cull_sort_two_phase(scene, prepared, expand_capacity, out_capacity,
                                          width, height, cull_backface=cull_backface)
        return soup, build_shade_records(soup, scene, render_size=(width, height))
    inst = scene.instances
    if cluster_cull:
        owner, tri_idx, valid = _cluster_slot_map(
            scene, prepared.visible, prepared.lod, expand_capacity, prepared.model,
            prepared.camera_pos, prepared.vp, cull_backface)
    else:
        tc = _lod_tri_counts(scene, prepared.visible, prepared.lod)
        base_i = lib.lod_index_offset[inst.mesh_id.long(), prepared.lod]
        owner, tri_idx, valid, _ = _slot_map_counts(tc, base_i, expand_capacity)
    cc = _clip_cols(lib.tri_rec[tri_idx].T.contiguous(),
                    prepared.clip_mats[owner].T.contiguous())
    mask, key = _cull_and_keys([cc[0], cc[4], cc[8]], [cc[1], cc[5], cc[9]],
                               [cc[2], cc[6], cc[10]], [cc[3], cc[7], cc[11]], valid,
                               cull_backface)
    count = torch.clamp(mask.sum(), max=out_capacity).to(torch.int32)
    out_valid = torch.arange(out_capacity, device=count.device) < count
    perm = torch.sort(key, stable=True).indices[:out_capacity]
    owner_s = owner[perm]
    tri_s = tri_idx[perm]

    # --- records for the surviving prefix ----------------------------------
    mats = scene.materials
    mat_rec = torch.cat(
        [
            mats.base_color_factor, mats.metallic[:, None], mats.roughness[:, None],
            mats.emissive, mats.base_color_tex[:, None].float(),
            mats.normal_tex[:, None].float(),
        ],
        dim=1,
    )  # (K, 11): SR_BASE .. SR_NM_LAYER
    per_owner = torch.cat(
        [prepared.clip_mats, prepared.model, mat_rec[inst.material_id.long()]], dim=1
    )  # (N, 43)
    gt2 = per_owner[owner_s].T.contiguous()  # (43, T)
    rts = lib.tri_rec[tri_s].T.contiguous()  # (36, T)
    ccs = _clip_cols(rts, gt2[:16])
    clip_s = torch.stack(ccs, dim=1).reshape(out_capacity, 3, 4)
    mts = gt2[16:32]

    def rot_cols(base, stride):
        return [
            rts[base + stride * c] * mts[4 * j]
            + rts[base + stride * c + 1] * mts[4 * j + 1]
            + rts[base + stride * c + 2] * mts[4 * j + 2]
            for c in range(3)
            for j in range(3)
        ]

    wn_cols = rot_cols(TR_NRM, 3)
    wt_cols = rot_cols(TR_TAN, 4)
    uv_cols = [rts[TR_UV + k] for k in range(6)]
    tan_cols = [
        wt_cols[3 * c + j] if j < 3 else rts[TR_TAN + 4 * c + 3]
        for c in range(3)
        for j in range(4)
    ]

    # per-triangle texture LOD: 0.5*log2(uv texel area / screen pixel area)
    sw = [torch.where(ccs[4 * c + 3].abs() > 1e-9, ccs[4 * c + 3], 1e-9) for c in range(3)]
    ok_w = (ccs[3] > 1e-9) & (ccs[7] > 1e-9) & (ccs[11] > 1e-9)
    spx = [(ccs[4 * c] / sw[c] + 1.0) * (0.5 * width) for c in range(3)]
    spy = [(1.0 - ccs[4 * c + 1] / sw[c]) * (0.5 * height) for c in range(3)]
    a_px = ((spx[1] - spx[0]) * (spy[2] - spy[0]) - (spx[2] - spx[0]) * (spy[1] - spy[0])).abs()
    atlas_size = scene.atlas.level_size[0]
    su = [uv_cols[2 * c] * atlas_size for c in range(3)]
    sv = [uv_cols[2 * c + 1] * atlas_size for c in range(3)]
    a_uv = ((su[1] - su[0]) * (sv[2] - sv[0]) - (su[2] - su[0]) * (sv[1] - sv[0])).abs()
    tex_lod = 0.5 * torch.log2(torch.clamp(a_uv / torch.clamp(a_px, min=1e-12), min=1e-12))
    tex_lod = torch.where(ok_w, torch.clamp(tex_lod, min=0.0), 0.0)

    # edge coefficients: adj(M) rows = cross products of the other two
    # pixel-homogeneous corners (shading divides by their sum, so any common
    # scale, the facing sign included, cancels)
    hw, hh = 0.5 * width, 0.5 * height
    uvec = [
        ((ccs[4 * c] + ccs[4 * c + 3]) * hw, (ccs[4 * c + 3] - ccs[4 * c + 1]) * hh,
         ccs[4 * c + 3])
        for c in range(3)
    ]

    def cross_cols(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]

    edge_cols = cross_cols(uvec[1], uvec[2]) + cross_cols(uvec[2], uvec[0]) + cross_cols(uvec[0], uvec[1])
    cols = (
        wn_cols + uv_cols + tan_cols + [tex_lod, owner_s.float()]
        + [gt2[32 + i] for i in range(11)] + edge_cols
    )
    shade_rec = torch.zeros((out_capacity, SR_COLS), dtype=torch.float32, device=count.device)
    shade_rec[:, : len(cols)] = torch.stack(cols, dim=1)
    soup = TriangleSoup(clip=clip_s, instance=owner_s, valid=out_valid,
                        count=count, tri_idx=tri_s, tex_lod=tex_lod)
    if want_soup_attrs:
        soup = soup._replace(normal=torch.stack(wn_cols, dim=1).reshape(out_capacity, 3, 3),
                             uv=torch.stack(uv_cols, dim=1).reshape(out_capacity, 3, 2),
                             tangent=torch.stack(tan_cols, dim=1).reshape(out_capacity, 3, 4))
    return soup, shade_rec


def _corner_map(v: torch.Tensor, m: torch.Tensor, translate: bool) -> torch.Tensor:
    """(T, K, 3) vectors through per-row (T, 4, 4) matrices:
    out[t, n, i] = sum_j m[t, i, j] v[t, n, j] (+ m[t, i, 3]), i < 4 with
    ``translate`` (clip corners), else i < 3 (normals, tangents)."""
    rows = 4 if translate else 3
    out = (v[..., 0, None] * m[:, None, :rows, 0] + v[..., 1, None] * m[:, None, :rows, 1]
           + v[..., 2, None] * m[:, None, :rows, 2])
    return out + m[:, None, :rows, 3] if translate else out


def _area2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|twice the signed area| of (T, 3) corner coordinates."""
    return ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
            - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])).abs()


def finalize_tex_lod(soup: TriangleSoup, width: int, height: int, atlas_size) -> TriangleSoup:
    """Per-triangle texture LOD 0.5*log2(uv area in texels / screen area in
    pixels), at least 0; 0 for a triangle with a corner at or behind w = 0."""
    clip = soup.clip
    w = clip[..., 3]
    ok = (w > 1e-9).all(dim=-1)
    safe_w = torch.where(w.abs() > 1e-9, w, 1e-9)
    px = (clip[..., 0] / safe_w + 1.0) * (0.5 * width)
    py = (1.0 - clip[..., 1] / safe_w) * (0.5 * height)
    a_uv = _area2(soup.uv[..., 0] * atlas_size, soup.uv[..., 1] * atlas_size)
    ratio = a_uv / torch.clamp(_area2(px, py), min=1e-12)
    lod = 0.5 * torch.log2(torch.clamp(ratio, min=1e-12))
    return soup._replace(tex_lod=torch.where(ok, torch.clamp(lod, min=0.0), 0.0))


def pixel_homogeneous(clip: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Clip (..., 4) -> pixel-homogeneous (..., 3): ((x + w) W/2, (w - y) H/2, w)."""
    x, y, w = clip[..., 0], clip[..., 1], clip[..., 3]
    return torch.stack([(x + w) * (0.5 * width), (w - y) * (0.5 * height), w], dim=-1)


def build_shade_records(soup: TriangleSoup, scene: Scene, render_size=None) -> torch.Tensor:
    """(T, SR_COLS) shade records of a soup that carries its corner
    attributes. With ``render_size`` (width, height) the SR_EDGE columns
    hold the edge coefficients, from which shading derives barycentrics;
    without it (the plain configuration, whose shading reads the raster's
    barycentrics) they are zero like the padding."""
    t_cap = soup.instance.shape[0]
    mat_id = scene.instances.material_id.long()[soup.instance]
    mats = scene.materials
    cols = [
        soup.normal.reshape(t_cap, 9), soup.uv.reshape(t_cap, 6),
        soup.tangent.reshape(t_cap, 12), soup.tex_lod[:, None], soup.instance[:, None].float(),
        mats.base_color_factor[mat_id], mats.metallic[mat_id][:, None],
        mats.roughness[mat_id][:, None], mats.emissive[mat_id],
        mats.base_color_tex[mat_id][:, None].float(), mats.normal_tex[mat_id][:, None].float(),
    ]
    if render_size is not None:
        u = pixel_homogeneous(soup.clip, *render_size)  # (T, 3 corners, 3)
        cols += [_cross3(u[:, 1], u[:, 2]), _cross3(u[:, 2], u[:, 0]), _cross3(u[:, 0], u[:, 1])]
    rec = torch.cat(cols, dim=-1)
    return torch.cat([rec, rec.new_zeros((t_cap, SR_COLS - rec.shape[-1]))], dim=-1)


def clip_rows(m: torch.Tensor, model16: torch.Tensor) -> torch.Tensor:
    """m (4, 4) @ each (N, 16)-row matrix -> (N, 16) rows, the sum over the
    inner index taken left to right."""
    b = model16.reshape(-1, 4, 4)
    out = m[None, :, 0, None] * b[:, None, 0, :]
    for j in range(1, 4):
        out = out + m[None, :, j, None] * b[:, None, j, :]
    return out.reshape(-1, 16)


def pixel_centres(h: int, w: int, y0: int, device):
    """(px, py) (H, W) pixel-centre coordinates of rows [y0, y0 + h)."""
    px = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w) + 0.5
    py = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w) + float(y0) + 0.5
    return px, py


def unproject_depth(depth, viewproj_inv, width: int, height: int, y0: int = 0,
                    full_height: int = None, px=None, py=None) -> torch.Tensor:
    """Depth + inverse viewproj -> channel-first (3, ...) world positions.
    Without ``px``/``py`` the samples are the (H, W) pixel centres (rows
    offset by y0 in a full_height image); with them, explicit absolute
    pixel-centre coordinates of any grid of samples (the checkerboard
    lattice, the sparse fix batch) shaped like ``depth``, and y0 is unused."""
    if full_height is None:
        full_height = depth.shape[0]
    if px is None:
        px, py = pixel_centres(*depth.shape, y0, depth.device)
    x = px / width * 2.0 - 1.0
    y = 1.0 - py / full_height * 2.0
    m = viewproj_inv
    planes = [m[i, 0] * x + m[i, 1] * y + m[i, 2] * depth + m[i, 3] for i in range(4)]
    wch = planes[3]
    inv_w = 1.0 / torch.where(wch.abs() > 1e-12, wch, 1e-12)
    return torch.stack([planes[0] * inv_w, planes[1] * inv_w, planes[2] * inv_w], dim=0)
