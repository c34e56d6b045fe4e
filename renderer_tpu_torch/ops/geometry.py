"""Geometry stage (``renderer_tpu.ops.geometry``): instance matrices,
coarse cull and LOD pick, draw-stream expansion, per-triangle cull, the
Morton sort and the packed shade records.

Quantities are computed as flat per-instance or per-triangle columns with
the JAX package's expressions, term by term and in its order. The port
leaves out the TPU layout devices of the reference (transposing identity
dots, integer ids packed into float columns): plain gathers and stacks
take their place. Only the ``tri_rec`` fast path without cluster culling
is ported (the bench frame's path).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from renderer_tpu_torch.ops.raster_spec import FRONT_DET_SIGN
from renderer_tpu_torch.mathx.camera import Camera, camera_matrices, frustum_planes
from renderer_tpu_torch.ops.cull import INVALID_KEY, _morton2d
from renderer_tpu_torch.scene.types import TR_NRM, TR_POS, TR_TAN, TR_UV, Scene


class TriangleSoup(NamedTuple):
    """Fixed-capacity post-cull triangle stream (the raster input). The
    surviving triangles are the sorted prefix ``[0, count)``; the shading
    attributes live in the shade records, row for row.

    clip:     (T, 3, 4) clip-space corners
    instance: (T,) owning instance id (int64)
    valid:    (T,) bool
    count:    () live slots
    tri_idx:  (T,) library-global triangle index (int64)
    tex_lod:  (T,) per-triangle base texture LOD
    """

    clip: torch.Tensor
    instance: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    tri_idx: torch.Tensor
    tex_lod: torch.Tensor


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
    flat = mats44(model).reshape(-1, 16)
    m = [[flat[:, 4 * i + j] for j in range(4)] for i in range(3)]
    cw, ew, _, _ = _world_aabb_cols(scene, m)
    return scene.instances.alive & ~_outside_frustum(viewproj, cw, ew)


def prepare_frame_columns(scene: Scene, camera: Camera) -> Prepared:
    """Model and clip matrices, coarse frustum cull of world AABBs, the
    distance LOD pick and the scene bounds, all as (N,) column math."""
    inst = scene.instances
    lib = scene.meshes
    tt = inst.translation.T
    qt = inst.rotation.T
    s = inst.scale
    w, x, y, z = qt[0], qt[1], qt[2], qt[3]
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    m = [[r[i][j] * s for j in range(3)] + [tt[i]] for i in range(3)]

    _, _, vp = camera_matrices(camera)
    clip_cols = []
    for i in range(4):
        for j in range(4):
            c = vp[i, 0] * m[0][j] + vp[i, 1] * m[1][j] + vp[i, 2] * m[2][j]
            if j == 3:
                c = c + vp[i, 3]
            clip_cols.append(c)

    cw, ew, mn_t, mx_t = _world_aabb_cols(scene, m)
    visible = inst.alive & ~_outside_frustum(vp, cw, ew)

    cam_p = camera.position
    dx, dy, dz = cw[0] - cam_p[0], cw[1] - cam_p[1], cw[2] - cam_p[2]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    radius = torch.sqrt(
        (mx_t[0] - mn_t[0]) ** 2 + (mx_t[1] - mn_t[1]) ** 2 + (mx_t[2] - mn_t[2]) ** 2
    ) * (0.5 * s)
    ratio = radius / torch.clamp(dist, min=1e-6)
    lod = torch.floor(torch.log2(torch.clamp(0.25 / torch.clamp(ratio, min=1e-6), min=1.0)))
    lod = torch.clamp(lod, 0, lib.lod_tri_count.shape[1] - 1).long()

    # scene bounds over the alive instances (the light cameras' fit)
    big = 1e9
    scene_min = torch.stack([torch.where(inst.alive, cw[k] - ew[k], big).min() for k in range(3)])
    scene_max = torch.stack([torch.where(inst.alive, cw[k] + ew[k], -big).max() for k in range(3)])

    zero, one = torch.zeros_like(s), torch.ones_like(s)
    model = torch.stack(m[0] + m[1] + m[2] + [zero, zero, zero, one], dim=-1)
    clip_mats = torch.stack(clip_cols, dim=-1)
    vp_inv = torch.linalg.inv_ex(vp).inverse
    return Prepared(model, vp, clip_mats, visible, lod, vp_inv, scene_min, scene_max)


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
    if lib.tri_rec is None:
        raise NotImplementedError(
            "scene without a tri_rec table: the per-corner expansion is not ported"
        )
    mesh_id = scene.instances.mesh_id.long()
    tc = torch.where(visible, lib.lod_tri_count[mesh_id, lod], 0)
    base_i = lib.lod_index_offset[mesh_id, lod].long()
    owner, start, slots, valid, total = _slot_map_starts(tc, capacity)
    tri_idx = torch.where(valid, base_i[owner] + (slots - start), 0)
    positions = lib.tri_rec[:, : TR_POS + 9]  # the corner positions only
    cc = _clip_cols(positions[tri_idx].T.contiguous(),
                    mats44(clip_mats).reshape(-1, 16)[owner].T.contiguous())
    clip = torch.stack(cc, dim=1).reshape(capacity, 3, 4)
    return clip, valid, torch.clamp(total, max=capacity).to(torch.int32)


def build_draw_stream(
    scene: Scene,
    prepared: Prepared,
    expand_capacity: int,
    out_capacity: int,
    width: int,
    height: int,
    cull_backface: bool = True,
):
    """Expansion + per-triangle frustum/backface cull + Morton sort +
    shade-record build. Returns (TriangleSoup, (T, SR_COLS) shade records).

    Survivors sort by the Morton code of their screen-bbox centre, ties by
    expansion slot (a stable sort), so the order is the JAX package's."""
    lib = scene.meshes
    if lib.tri_rec is None:
        raise NotImplementedError(
            "scene without a tri_rec table: the per-corner expansion is not ported"
        )
    inst = scene.instances
    mesh_id = inst.mesh_id.long()
    tc = torch.where(prepared.visible, lib.lod_tri_count[mesh_id, prepared.lod], 0)
    base_i = lib.lod_index_offset[mesh_id, prepared.lod].long()
    owner, start, slots, valid, _ = _slot_map_starts(tc, expand_capacity)
    tri_idx = torch.where(valid, base_i[owner] + (slots - start), 0)
    cc = _clip_cols(lib.tri_rec[tri_idx].T.contiguous(),
                    prepared.clip_mats[owner].T.contiguous())
    x = [cc[0], cc[4], cc[8]]
    y = [cc[1], cc[5], cc[9]]
    z = [cc[2], cc[6], cc[10]]
    w = [cc[3], cc[7], cc[11]]

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
    key = torch.where(mask, _morton2d(gx, gy), INVALID_KEY)
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
    return soup, shade_rec


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
