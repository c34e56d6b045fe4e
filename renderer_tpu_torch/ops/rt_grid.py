"""Ray-traced shadows through a light-space triangle grid
(``renderer_tpu.ops.rt_grid``).

For a directional light every shadow ray is parallel, so the query
projects to 2D light space: a receiver at light-space (x, y, depth) is
occluded iff some caster triangle covers (x, y) nearer the light. Casters
are expanded per light (``geometry.expand_clip_only``, so off-camera
geometry occludes), set up as 2D-homogeneous edge functions (perspective
light cameras work too: point lights trace one cube face at a time), and
binned per screen tile against the light-space bbox of the tile's
receivers. The walk itself is ``ops/occlusion_cuda.py``: the CUDA kernel
for CUDA tensors, its plain version for CPU tensors.

The port's screen tiles are 16x64 (the JAX package's 32x128 is a TPU
shape); binning only prunes casters, so the tiling does not change which
receivers are occluded, up to receivers within rounding of a caster's bbox.
Receivers with ld = +inf (background) stay lit; the JAX kernel tests those
inside a walked tile like live ones, so its answer for them depends on its
tiling.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from renderer_tpu_torch.ops.aa import halo_rows
from renderer_tpu_torch.ops.geometry import clip_rows, coarse_cull, expand_clip_only
from renderer_tpu_torch.ops.occlusion_cuda import O_BB, O_OK, occlusion_kernel, occlusion_tiles_plain
from renderer_tpu_torch.ops.raster_cuda import BLOCK, TILE_H, TILE_W, bin_blocks_from_masks
from renderer_tpu_torch.ops.shadow import cube_face_matrices, lod_by_distance

NORMAL_OFFSET = 2e-3  # receiver offset along its normal, times the scene radius
DEPTH_EPS = 1.5e-3    # light-depth bias


class RtGrid(NamedTuple):
    """What shading needs to trace one frame's shadows."""

    light_mats: torch.Tensor    # (L, 4, 4) from directional_light_matrices
    lod: torch.Tensor           # (N,) camera LOD per instance
    model: torch.Tensor         # (N, 16) model matrix rows
    scene_radius: torch.Tensor  # () bias and cube-face range scale
    caster_capacity: int        # per-light caster expansion capacity
    light_casts: tuple          # (shadow_slot, directional) per shaded light, -1 none
    n_slots: int                # shadow slots
    rt_scale: int               # trace a 1/rt_scale receiver grid


def _setup_light_tris(clip: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Light-clip casters (T, 3, 4) -> records (T, REC).

    Edge functions are cross products of the clip-space (x, y, w) columns
    and depth is the rational z_num / w_den, so perspective light cameras
    need no near-plane clipping; for orthographic ones (w == 1) this is the
    plain 2D test. Casters crossing w = 0 get the bbox [-2, 2]^2."""
    t_cap = clip.shape[0]
    ct = clip.reshape(t_cap, 12).T.contiguous()
    x = [ct[4 * c] for c in range(3)]
    y = [ct[4 * c + 1] for c in range(3)]
    z = [ct[4 * c + 2] for c in range(3)]
    w = [ct[4 * c + 3] for c in range(3)]

    def cross_cols(a, b):
        return (y[a] * w[b] - w[a] * y[b], w[a] * x[b] - x[a] * w[b], x[a] * y[b] - y[a] * x[b])

    edges = (cross_cols(1, 2), cross_cols(2, 0), cross_cols(0, 1))
    det = edges[0][0] * x[0] + edges[0][1] * y[0] + edges[0][2] * w[0]
    sgn = torch.sign(det)
    ok = valid & (det != 0)

    all_front = (w[0] > 1e-9) & (w[1] > 1e-9) & (w[2] > 1e-9)
    safe_w = [torch.where(wc.abs() > 1e-9, wc, 1e-9) for wc in w]
    px = [x[c] / safe_w[c] for c in range(3)]
    py = [y[c] / safe_w[c] for c in range(3)]

    def min3(v):
        return torch.minimum(torch.minimum(v[0], v[1]), v[2])

    def max3(v):
        return torch.maximum(torch.maximum(v[0], v[1]), v[2])

    xmin = torch.where(all_front, min3(px), -2.0)
    xmax = torch.where(all_front, max3(px), 2.0)
    ymin = torch.where(all_front, min3(py), -2.0)
    ymax = torch.where(all_front, max3(py), 2.0)
    cols = [c * sgn for e in edges for c in e] + z + w + [xmin, xmax, ymin, ymax, ok.float()]
    return torch.stack(cols, dim=1)


def _pad_to_tiles(a: torch.Tensor, fill: float) -> torch.Tensor:
    """Pad (H, W) up to (TILE_H, TILE_W) multiples."""
    h, w = a.shape
    ph, pw = (-h) % TILE_H, (-w) % TILE_W
    if ph == 0 and pw == 0:
        return a
    return F.pad(a, (0, pw, 0, ph), value=fill)


def tile_receiver_bboxes(lx: torch.Tensor, ly: torch.Tensor, ld: torch.Tensor) -> torch.Tensor:
    """(n_tiles, 4) light-space bbox (xmin, xmax, ymin, ymax) of each
    tile's live receivers (finite ld); empty (+big, -big) without any."""
    h, w = lx.shape
    live = torch.isfinite(ld)
    big = 3e38

    def reduce(v, fill, fn):
        t = torch.where(live, v, fill).reshape(h // TILE_H, TILE_H, w // TILE_W, TILE_W)
        return fn(t, dim=(1, 3)).reshape(-1)

    return torch.stack([reduce(lx, big, torch.amin), reduce(lx, -big, torch.amax),
                        reduce(ly, big, torch.amin), reduce(ly, -big, torch.amax)], dim=1)


def bin_blocks_by_bbox(rec: torch.Tensor, tile_bbox: torch.Tensor):
    """Per tile, the ascending list of caster blocks whose live bbox union
    overlaps the tile's receiver bbox: (block_list (n_tiles, n_blocks) i32,
    block_count (n_tiles,) i32). The lists have no cap."""
    xmin, xmax, ymin, ymax = (rec[:, O_BB + k] for k in range(4))
    ok = rec[:, O_OK] > 0.5
    n_blocks = ok.shape[0] // BLOCK
    inf = float("inf")

    def union(v, fill, fn):
        return fn(torch.where(ok, v, fill).reshape(n_blocks, BLOCK), dim=1).values

    bxmin, bxmax = union(xmin, inf, torch.min), union(xmax, -inf, torch.max)
    bymin, bymax = union(ymin, inf, torch.min), union(ymax, -inf, torch.max)
    bany = ok.reshape(n_blocks, BLOCK).any(dim=1)
    tx0, tx1, ty0, ty1 = (tile_bbox[:, k, None] for k in range(4))
    overlap = (bany[None] & (bxmin[None] <= tx1) & (bxmax[None] >= tx0)
               & (bymin[None] <= ty1) & (bymax[None] >= ty0))
    return bin_blocks_from_masks(overlap)


def occlusion_inputs(clip, valid, lx, ly, ld) -> tuple:
    """Setup + binning: the arguments of the occlusion walk, (records,
    block_list, block_count, tile_bbox, lx, ly, ld), with the receiver
    planes padded to tile multiples (padding has ld = +inf)."""
    if clip.shape[0] % BLOCK:
        raise ValueError(f"occlusion needs T % {BLOCK} == 0 casters, got {clip.shape[0]}")
    lx = _pad_to_tiles(lx, 0.0).contiguous()
    ly = _pad_to_tiles(ly, 0.0).contiguous()
    ld = _pad_to_tiles(ld, math.inf).contiguous()
    rec = _setup_light_tris(clip, valid)
    tile_bbox = tile_receiver_bboxes(lx, ly, ld)
    block_list, block_count = bin_blocks_by_bbox(rec, tile_bbox)
    return rec, block_list, block_count, tile_bbox, lx, ly, ld


def occlusion_grid(clip, valid, lx, ly, ld) -> torch.Tensor:
    """(H, W) f32 occlusion of receivers at light NDC (lx, ly) and light
    depth ld (+inf: background) by the casters ``clip`` (T, 3, 4) in light
    clip space: 1 lit, 0 shadowed. CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    h, w = lx.shape
    args = occlusion_inputs(clip, valid, lx, ly, ld)
    if clip.device.type == "cuda":
        occ = occlusion_kernel(*args)
    elif clip.device.type == "cpu":
        occ = occlusion_tiles_plain(*args)
    else:
        raise ValueError(f"no occlusion walk for device {clip.device}")
    return occ[:h, :w]


def _bilateral_upsample(low, tri_lo, tri_full, s: int, off: int, y0: int = 0,
                        total_lo: int = None, above=None):
    """(h/s + 1, w/s) occlusion with one halo row below -> (H, W) by
    triangle-ID-aware bilinear: corner weights are bilinear x same
    triangle, so shadow never bleeds across surfaces; where no corner shares
    the pixel's triangle the plain bilinear stands.

    A band of a larger grid: the (H, W) grid is rows [y0, y0 + H) of one
    of ``total_lo`` low-resolution rows (y0 % s == 0), ``above`` the
    band's halo row above, (occlusion (1, w/s), triangle ids (1, w/s)).
    Row coordinates are then the whole grid's, so a band computes what the
    whole grid computes on its rows."""
    big_h, big_w = tri_full.shape
    h_lo, w_lo = low.shape[0] - 1, low.shape[1]
    dev = low.device
    fy = (torch.arange(big_h, dtype=torch.float32, device=dev) + float(y0) - off) / s
    i0 = torch.clamp(torch.floor(fy), 0, (total_lo or h_lo) - 1).long()
    wy = torch.clamp(fy - i0.float(), 0.0, 1.0)[:, None]
    if above is not None:  # into the band's rows, the halo row above first
        low, tri_lo = torch.cat([above[0], low], dim=0), torch.cat([above[1], tri_lo], dim=0)
        i0 = i0 - (y0 // s - 1)
    i1 = i0 + 1  # the halo row below when i0 is the last real row
    fx = (torch.arange(big_w, dtype=torch.float32, device=dev) - off) / s
    j0 = torch.clamp(torch.floor(fx), 0, w_lo - 1).long()
    j1 = torch.clamp(j0 + 1, max=w_lo - 1)
    wx = torch.clamp(fx - j0.float(), 0.0, 1.0)[None, :]

    def up(a, iy, jx):
        return a.index_select(1, jx).index_select(0, iy)

    num = torch.zeros(tri_full.shape, dtype=torch.float32, device=dev)
    den = torch.zeros_like(num)
    plain = torch.zeros_like(num)
    for iy, wyc in ((i0, 1.0 - wy), (i1, wy)):
        for jx, wxc in ((j0, 1.0 - wx), (j1, wx)):
            c = up(low, iy, jx)
            wb = wyc * wxc
            wgt = wb * (up(tri_lo, iy, jx) == tri_full).float()
            num = num + wgt * c
            den = den + wgt
            plain = plain + wb * c  # bilinear weights sum to 1
    return torch.where(den > 0, num / torch.clamp(den, min=1e-9), plain)


def slot_lights(static_casts, n_slots: int) -> tuple:
    """Per shadow slot, (light index, directional) of the first live light
    in it, or None: the static light-cast pattern (``(slot, directional)``
    per light, slot -1 for none) read slot by slot."""
    out = []
    for slot in range(n_slots):
        hit = [(li, d) for li, (s, d) in enumerate(static_casts) if s == slot]
        out.append(hit[0] if hit else None)
    return tuple(out)


def _light_ndc(m, pos):
    """Receiver points (3, H, W) -> light NDC x, y and depth under the 4x4
    matrix m, products written out term by term."""
    lclip = [m[i, 0] * pos[0] + m[i, 1] * pos[1] + m[i, 2] * pos[2] + m[i, 3] for i in range(4)]
    lw = torch.where(lclip[3].abs() > 1e-9, lclip[3], 1e-9)
    return lclip[0] / lw, lclip[1] / lw, lclip[2] / lw


def rt_shadow_grid(
    scene,
    world: torch.Tensor,     # (3, H, W) receiver world positions
    normal: torch.Tensor,    # (3, H, W) geometric normals (self-shadow offset)
    covered: torch.Tensor,   # (H, W) bool: pixels that hold geometry
    light_mats: torch.Tensor,  # (L, 4, 4) from directional_light_matrices
    lod: torch.Tensor,       # (N,) camera LOD per instance
    model: torch.Tensor,     # (N, 16) model matrix rows
    scene_radius: torch.Tensor,  # () bias scale
    caster_capacity: int,
    slots: tuple,            # per slot: (light index, directional) or None
    tri: torch.Tensor = None,  # (H, W) triangle ids, needed when rt_scale > 1
    rt_scale: int = 1,
    depth_eps: float = DEPTH_EPS,
    halo=None,  # the shard of a split frame (aa.halo_rows)
) -> list:
    """Per shadow slot, the (H, W) occlusion plane of its light (1 lit, 0
    shadowed); a slot without a light is a plane of ones and costs no
    device work.

    A directional slot culls its casters against the light matrix, takes
    the camera's LOD and traces once. A point slot expands its casters once
    in light-centred world space with the LOD by distance to the light,
    then traces each cube face; every receiver traces only in the face of
    its major axis. rt_scale > 1 traces the [off::s, off::s] subgrid and
    upsamples it by triangle id; under a split frame (``halo``, each
    shard's grid a band of equal rows) the rows at the band's edges come
    from the neighbouring shards, so each band equals the whole grid's."""
    if rt_scale > 1:
        if tri is None:
            raise ValueError("rt_scale > 1 needs the triangle-id plane")
        s, off = rt_scale, rt_scale // 2
        planes_lo = rt_shadow_grid(
            scene, world[:, off::s, off::s], normal[:, off::s, off::s],
            covered[off::s, off::s], light_mats, lod, model, scene_radius,
            caster_capacity, slots, depth_eps=depth_eps,
        )
        tri_lo = tri[off::s, off::s]
        live = [k for k, slot in enumerate(slots) if slot is not None]
        # one halo row below, clamped to the edge on one shard; under a split
        # frame the neighbouring shards' rows below and above (the JAX package
        # passes the row below only, so its bands' first rows differ from the
        # whole grid's)
        rows = halo_rows([tri_lo] + [planes_lo[k] for k in live], halo)
        band = {} if halo is None else dict(y0=halo.axis_index() * tri.shape[0],
                                            total_lo=halo.axis_size() * tri_lo.shape[0])
        tri_ext = torch.cat([tri_lo, rows[0][1]], dim=0)
        ones = torch.ones((), dtype=torch.float32, device=world.device).expand(tri.shape)
        planes = [ones] * len(slots)
        for k, (up, dn) in zip(live, rows[1:]):
            planes[k] = _bilateral_upsample(
                torch.cat([planes_lo[k], dn], dim=0), tri_ext, tri, s, off,
                above=None if halo is None else (up, rows[0][0]), **band)
        return planes

    dev = world.device
    lights = scene.lights
    # world-space normal offset proportional to the scene's size
    offset_world = world + normal * (scene_radius * NORMAL_OFFSET)
    ones = torch.ones((), dtype=torch.float32, device=dev).expand(world.shape[1:])
    planes = []
    for slot in slots:
        if slot is None:
            planes.append(ones)
            continue
        li, directional = slot
        if directional:
            m = light_mats[li]
            lx, ly, lz = _light_ndc(m, offset_world)
            ld = torch.where(covered, lz - depth_eps, math.inf)
            visible = coarse_cull(scene, model, m)
            cclip, cvalid, _ = expand_clip_only(scene, visible, lod, clip_rows(m, model),
                                                caster_capacity)
            planes.append(occlusion_grid(cclip, cvalid, lx, ly, ld))
            continue
        # point light: one expansion in light-centred world space (w stays 1)
        lpos = lights.position[li]
        cm = model.clone()
        cm[:, 3] = model[:, 3] - lpos[0]
        cm[:, 7] = model[:, 7] - lpos[1]
        cm[:, 11] = model[:, 11] - lpos[2]
        lod_l = lod_by_distance(scene, model, lpos)
        cworld, cvalid, _ = expand_clip_only(scene, scene.instances.alive, lod_l, cm,
                                             caster_capacity)
        d_l = offset_world - lpos[:, None, None]
        ax, ay, az = d_l[0].abs(), d_l[1].abs(), d_l[2].abs()
        face = torch.where(
            (ax >= ay) & (ax >= az),
            torch.where(d_l[0] >= 0, 0, 1),
            torch.where(ay >= az, torch.where(d_l[1] >= 0, 2, 3), torch.where(d_l[2] >= 0, 4, 5)),
        )
        faces = cube_face_matrices(scene_radius * 1e-2 + 1e-6, scene_radius * 4.0 + 1e-3)
        occ = ones
        for f in range(6):
            mf = faces[f]
            lx, ly, lz = _light_ndc(mf, d_l)
            sel = covered & (face == f)
            ld = torch.where(sel, lz - depth_eps, math.inf)
            cclip = torch.stack([
                mf[i, 0] * cworld[..., 0] + mf[i, 1] * cworld[..., 1] + mf[i, 2] * cworld[..., 2]
                + mf[i, 3] * cworld[..., 3]
                for i in range(4)
            ], dim=-1)
            occ = torch.where(sel, occlusion_grid(cclip, cvalid, lx, ly, ld), occ)
        planes.append(occ)
    return planes

