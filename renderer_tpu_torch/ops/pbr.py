"""PBR metallic-roughness deferred shading: GGX + Smith + Schlick
(``renderer_tpu.ops.pbr``).

Everything is channel-first: vectors (3, H, W), scalars (H, W). One
shading core works on any 2D grid of samples with explicit pixel centres,
so the same expressions shade the full frame, the packed checkerboard and
quarter lattices and the sparse batches of their fixes: on the card kernel
7 (``shade_samples_kernel``, ``csrc/shade.cu``), one thread a sample that
reads the visibility buffer and the winner's record where they lie, and on
the CPU its plain version ``shade_samples_plain``, which it equals bit for
bit. Ported: barycentrics re-derived from the shade records' edge columns,
base-colour textures, normal maps with the Toksvig roughness term, edge
AA, shadow maps (``ops/shadow.py``), ray-traced shadows through the
light-space grid (``ops/rt_grid.py``) or by brute force (``ops/rt.py``, the
plain configuration's), and the checkerboard and quarter shade rates with
their fixes, with barycentrics from the records or from the raster (the
plain configuration's) at every rate.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from renderer_tpu_torch.ops.aa import _dn, _right, _up, edge_aa, halo_rows
from renderer_tpu_torch.ops.cuda_build import check_inputs, library
from renderer_tpu_torch.ops.raster_spec import NO_TRIANGLE
from renderer_tpu_torch.ops.geometry import (
    SR_BASE, SR_BC_LAYER, SR_COLS, SR_EDGE, SR_EMISSIVE, SR_METALLIC, SR_NM_LAYER,
    SR_NORMAL, SR_ROUGH, SR_TANGENT, SR_TEXLOD, SR_UV, unproject_depth,
)
from renderer_tpu_torch.ops.rt import RtBrute, rt_shadow_planes
from renderer_tpu_torch.ops.rt_grid import RtGrid, rt_shadow_grid, slot_lights
from renderer_tpu_torch.ops.shadow import ShadowMaps, shadow_occlusion
from renderer_tpu_torch.ops.texture import sample_atlas_cf, srgb_to_linear
from renderer_tpu_torch.scene.textures import TextureAtlas
from renderer_tpu_torch.scene.types import Lights

NM_LOD_BIAS = 1.5  # normal maps sample ~one mip softer than colour
FIX_TAU = 0.04  # the fix re-shades suspects whose neighbour spread exceeds this
FIX_K_DIV = 16  # fix capacity: K = P / FIX_K_DIV suspects (P: the lattice's pixels)
QFIX_K_DIV = 8  # quarter fix: K = P / QFIX_K_DIV (P: the frame's pixels; 3/4 are rebuilt)

# Record columns gathered per pixel, grouped as the JAX package groups them:
# the 8 interpolated attributes of each corner, then per-triangle constants.
_CORNER = [
    [SR_NORMAL + 3 * c + k for k in range(3)]
    + [SR_UV + 2 * c, SR_UV + 2 * c + 1]
    + [SR_TANGENT + 4 * c + k for k in range(3)]
    for c in range(3)
]
_CONST = (
    [SR_TEXLOD, SR_METALLIC, SR_ROUGH, SR_BC_LAYER, SR_NM_LAYER, SR_TANGENT + 3]
    + [SR_EDGE + k for k in range(9)]
    + [SR_BASE + k for k in range(3)]
    + [SR_EMISSIVE + k for k in range(3)]
)
_ORDER = _CORNER[0] + _CORNER[1] + _CORNER[2] + _CONST
_C_OFF = 24  # first constant row


def _runs(cols):
    """Consecutive column runs of ``cols`` as (start, stop) slices: the
    gather takes them by slicing (an index list would be a host tensor
    copied to the card, which waits for the queued work)."""
    runs = []
    for c in cols:
        if runs and runs[-1][1] == c:
            runs[-1][1] = c + 1
        else:
            runs.append([c, c + 1])
    return [tuple(r) for r in runs]


_ORDER_RUNS = _runs(_ORDER)
# the traced shadows' rays: each corner's normal, then the edge functions
_RAY_RUNS = _runs(_CORNER[0][:3] + _CORNER[1][:3] + _CORNER[2][:3] + _CONST[6:15])


def _dot_cf(a, b):
    """(3, H, W) x (3, H, W) -> (1, H, W), summed ((x0 + x1) + x2)."""
    return (a[0] * b[0] + a[1] * b[1] + a[2] * b[2])[None]


def _normalize_cf(v, eps=1e-8):
    return v / torch.clamp(torch.sqrt(_dot_cf(v, v)), min=eps)


def _cross_cf(a, b):
    return torch.stack(
        [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]],
        dim=0,
    )


def _ggx_brdf(n, v, l, albedo, metallic, roughness):
    """Cook-Torrance specular + Lambert diffuse, channel-first.
    n/v/l/albedo: (3,H,W); metallic/roughness: (1,H,W)."""
    h = _normalize_cf(v + l)
    ndl = torch.clamp(_dot_cf(n, l), min=0.0)
    ndv = torch.clamp(_dot_cf(n, v), min=1e-4)
    ndh = torch.clamp(_dot_cf(n, h), min=0.0)
    vdh = torch.clamp(_dot_cf(v, h), min=0.0)

    a = torch.clamp(roughness * roughness, min=1e-3)
    a2 = a * a
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * denom * denom, min=1e-9)
    gv = ndl * torch.sqrt(ndv * ndv * (1 - a2) + a2)
    gl = ndv * torch.sqrt(ndl * ndl * (1 - a2) + a2)
    vis = 0.5 / torch.clamp(gv + gl, min=1e-9)
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    f = f0 + (1.0 - f0) * (1.0 - vdh) ** 5
    specular = d * vis * f
    diffuse = albedo * (1.0 - metallic) * (1.0 - f) / math.pi
    return (diffuse + specular) * ndl


class ShadeFrame(NamedTuple):
    """What every call of the shading core within one ``shade_pbr`` reads
    besides its samples."""

    shade_rec: torch.Tensor    # (T, SR_COLS) records (geometry.build_draw_stream)
    atlas: TextureAtlas
    lights: Lights
    camera_pos: torch.Tensor   # (3,)
    viewproj_inv: torch.Tensor  # (4, 4)
    width: int                 # the frame's width and full height, for the unprojection
    full_height: int
    y0: int                    # the buffer's first row in the frame
    bg: torch.Tensor           # (3, 1, 1) background, on the device
    ambient: float
    enable_textures: bool
    enable_normal_maps: bool
    trilinear: bool
    n_lights: int              # light-table slots shaded
    shadow: ShadowMaps = None  # shadow maps (ops/shadow.py)
    traced_casts: tuple = None  # (shadow_slot, directional) per light of the traced planes


class Lattice(NamedTuple):
    """A grid of samples of the visibility buffer: sample (i, j) is pixel
    (step_x j + ((i + y0) & 1 if checker), step_y i), so (1, 1) is the
    full frame, (2, 1, True) the checkerboard's (x + y) even half-lattice
    and (2, 2) the quarter rate's (even x, even y) lattice."""

    step_x: int = 1
    step_y: int = 1
    checker: bool = False


class PixelList(NamedTuple):
    """Samples at listed pixels (xk, yk) of the visibility buffer (int64,
    (K,)), shaded as uncovered where not ``good``: the fixes' batches."""

    xk: torch.Tensor
    yk: torch.Tensor
    good: torch.Tensor


def _sample_geometry(frame: ShadeFrame, depth_in, tri_in, px, py, bary=None, rays=False):
    """The first steps of the shading core on a 2D grid of samples:
    (covered, world (3, h, w), the gathered record columns (45, P), the
    interpolated attributes (8, P), the geometric normal (3, h, w)). With
    ``rays`` only what the traced shadows' rays need: the 18 columns of
    the corners' normals and the edge functions, and the normal alone
    interpolated (3, P); the same values."""
    h_, w_ = depth_in.shape
    p_ = h_ * w_
    n_attr = 3 if rays else 8
    covered = tri_in != NO_TRIANGLE
    safe_id = torch.clamp(tri_in, min=0).reshape(p_).long()
    world = unproject_depth(depth_in, frame.viewproj_inv, frame.width, frame.full_height,
                            full_height=frame.full_height, px=px, py=py)
    # one gather of the needed record columns per sample -> (45, P) or (18, P)
    runs = _RAY_RUNS if rays else _ORDER_RUNS
    cols_t = torch.cat([frame.shade_rec[:, a:b] for a, b in runs], dim=1).T.contiguous()
    cols_t = cols_t[:, safe_id]

    if bary is None:  # the winner's edge functions at the pixel centre
        pxf, pyf = px.reshape(p_), py.reshape(p_)
        e_off = 3 * n_attr + (0 if rays else _CONST.index(SR_EDGE))

        def e(k):
            return cols_t[e_off + k]

        lam0 = e(0) * pxf + e(1) * pyf + e(2)
        lam1 = e(3) * pxf + e(4) * pyf + e(5)
        lam2 = e(6) * pxf + e(7) * pyf + e(8)
        lsum = lam0 + lam1 + lam2
        inv = 1.0 / torch.where(lsum != 0.0, lsum, 1.0)
        b0, b1, b2 = (lam0 * inv)[None], (lam1 * inv)[None], (lam2 * inv)[None]
    else:
        b0, b1, b2 = (bary[k].reshape(1, p_) for k in range(3))

    attrs = (b0 * cols_t[0:n_attr] + b1 * cols_t[n_attr:2 * n_attr]
             + b2 * cols_t[2 * n_attr:3 * n_attr])
    n_geom = _normalize_cf(attrs[0:3].reshape(3, h_, w_))
    return covered, world, cols_t, attrs, n_geom


def shade_samples_plain(frame: ShadeFrame, depth_in, tri_in, px, py, bary=None,
                        planes_fn=None) -> torch.Tensor:
    """The per-sample shading core on a 2D grid of samples -> (3, h, w)
    colour: depth and triangle ids (h, w) at the absolute pixel centres
    (px, py) (h, w), with barycentrics from the records (``bary`` None) or given (3, h, w) (the
    raster's, sampled like the grid). ``planes_fn(world, n_geom, covered,
    tri)`` gives the ray-traced shadows' occlusion planes, one per shadow
    slot. The plain version of kernel 7 (``shade_samples_kernel``), on any
    device."""
    h_, w_ = depth_in.shape
    covered, world, cols_t, attrs, n_geom = _sample_geometry(frame, depth_in, tri_in, px, py,
                                                             bary)

    def col(k):
        return cols_t[_C_OFF + _CONST.index(k)].reshape(h_, w_)

    u = attrs[3].reshape(h_, w_)
    v_ = attrs[4].reshape(h_, w_)
    tangent = attrs[5:8].reshape(3, h_, w_)
    tan_w = col(SR_TANGENT + 3)[None]
    tex_lod = col(SR_TEXLOD)
    base_factor = cols_t[_C_OFF + 15 : _C_OFF + 18].reshape(3, h_, w_)
    metallic = col(SR_METALLIC)[None]
    roughness = col(SR_ROUGH)[None]
    emissive = cols_t[_C_OFF + 18 : _C_OFF + 21].reshape(3, h_, w_)
    bc_layer = col(SR_BC_LAYER).to(torch.int32)
    nm_layer = col(SR_NM_LAYER).to(torch.int32)

    if frame.enable_textures:
        bc = sample_atlas_cf(frame.atlas, bc_layer, u, v_, tex_lod, trilinear=frame.trilinear)
        albedo = base_factor * srgb_to_linear(bc[0:3])
    else:
        albedo = base_factor

    if frame.enable_textures and frame.enable_normal_maps:
        t = _normalize_cf(tangent - n_geom * _dot_cf(tangent, n_geom))
        b = _cross_cf(n_geom, t) * tan_w
        nm = sample_atlas_cf(frame.atlas, nm_layer, u, v_, tex_lod + NM_LOD_BIAS,
                             trilinear=frame.trilinear)
        nx, ny, nz = nm[0] * 2 - 1, nm[1] * 2 - 1, nm[2] * 2 - 1
        n_mapped = _normalize_cf(t * nx[None] + b * ny[None] + n_geom * nz[None])
        has_nm = (nm_layer >= 0)[None]
        n = torch.where(has_nm, n_mapped, n_geom)
        # Toksvig: the filtered normal's length encodes the footprint's
        # normal variance, folded into GGX roughness
        len2 = torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-6)[None]
        ell = torch.sqrt(len2)
        sigma2 = torch.clamp((1.0 - ell) / ell, 0.0, 1.0)
        alpha2 = torch.square(roughness * roughness) + sigma2
        rough_eff = torch.sqrt(torch.sqrt(torch.clamp(alpha2, max=1.0)))
        roughness = torch.where(has_nm, rough_eff, roughness)
    else:
        n = n_geom

    # per shadow slot, the occlusion plane of its light
    planes = None if planes_fn is None else planes_fn(world, n_geom, covered, tri_in)

    v = _normalize_cf(frame.camera_pos[:, None, None] - world)
    lights, shadow = frame.lights, frame.shadow
    color = albedo * frame.ambient + emissive
    for li in range(frame.n_lights):
        pos = lights.position[li][:, None, None]
        directional = lights.directional[li]
        to_light = torch.where(directional, -pos * torch.ones_like(world), pos - world)
        dist2 = _dot_cf(to_light, to_light)
        l = to_light / torch.sqrt(torch.clamp(dist2, min=1e-12))
        atten = torch.where(directional, 1.0, 1.0 / torch.clamp(dist2, min=1e-4))
        radiance = lights.color[li][:, None, None] * (lights.intensity[li] * atten)
        if planes is not None and li < len(frame.traced_casts):
            slot = frame.traced_casts[li][0]
            if 0 <= slot < len(planes):
                radiance = radiance * planes[slot][None]
        if shadow is not None and li < len(shadow.light_casts):
            slot, s_dir = shadow.light_casts[li]
            if 0 <= slot < shadow.atlas.shape[0]:
                ndl_geom = torch.clamp(_dot_cf(n_geom, l), min=0.0)
                radiance = radiance * shadow_occlusion(
                    world, ndl_geom, shadow.light_mats[li], shadow.atlas[slot],
                    normal=n_geom, is_point=not s_dir, light_pos=lights.position[li])
        contrib = _ggx_brdf(n, v, l, albedo, metallic, roughness) * radiance
        color = color + torch.where(lights.alive[li], contrib, 0.0)
    return torch.where(covered[None], color, frame.bg)


# kernel 7: ``_F_*`` are the flags, the pointer and int arguments in the
# order csrc/shade.cu's ``rtt_shade`` reads them
_F_BARY, _F_TEXTURES, _F_NORMAL_MAPS, _F_TRILINEAR = 1, 2, 4, 8
MAX_LIGHTS = 64  # csrc/shade.cu's light-table slots a call may shade
LIBRARY = library("shade.cu")
_PTR = ctypes.c_void_p
SHADE = LIBRARY.kernel("rtt_shade", [_PTR, _PTR, ctypes.c_float])


def kernel_design() -> dict:
    """Kernel 7's sizes, read from its library (built on first use): a
    CTA's tile of lattice samples, its threads, the most light slots."""
    out = (ctypes.c_int * 4)()
    LIBRARY.load().rtt_shade_design(out)
    tx, ty, threads, max_lights = out
    return dict(tile=(tx, ty), threads=threads, max_lights=max_lights)


def shade_samples_kernel(frame: ShadeFrame, vis, samples, bary=None, planes=None) -> torch.Tensor:
    """Kernel 7: ``shade_samples_plain`` of the samples ``samples`` (a
    ``Lattice`` or a ``PixelList``) of the visibility buffer ``vis``, bit for
    bit, in one launch that reads depth, ids and records where they lie;
    CUDA tensors only. ``bary``: the buffer's barycentrics (3, H, W) to
    interpolate with (None: from the records); ``planes``: the ray-traced
    shadows' occlusion planes, per shadow slot one (h, w) plane of the
    samples. Returns (3, h, w) for a lattice, (3, K) for a list; reads no
    device value on the host. ``SHADE.launches`` counts the launches."""
    depth, tri = vis.depth, vis.tri_id
    vh, vw = depth.shape
    if isinstance(samples, Lattice):
        gh, gw = vh // samples.step_y, vw // samples.step_x
        shape, lists = (gh, gw), None
    else:
        shape, lists = tuple(samples.xk.shape), samples
    n = math.prod(shape)
    atlas, shadow = frame.atlas, frame.shadow
    # the small tables as the kernel reads them (no-ops where they are
    # contiguous); the inverse view-projection, column-major as
    # torch.linalg.inv_ex makes it, through its strides
    cam, level_size, level_offset, bg = (t.contiguous() for t in (
        frame.camera_pos, atlas.level_size, atlas.level_offset, frame.bg))
    vp_inv = frame.viewproj_inv
    if sorted(vp_inv.stride()) != [1, 4]:
        vp_inv = vp_inv.contiguous()
    vp_dense = vp_inv.T if vp_inv.stride(0) == 1 else vp_inv  # row-major either way
    lights = type(frame.lights)(*(t.contiguous() for t in frame.lights))
    light_mats = None if shadow is None else shadow.light_mats.contiguous()
    n_l = lights.alive.shape[0]
    specs = [
        (depth, torch.float32, (vh, vw)), (tri, torch.int32, (vh, vw)),
        (frame.shade_rec, torch.float32, (frame.shade_rec.shape[0], SR_COLS)),
        (atlas.packed_u32, torch.int32, None),
        (level_size, torch.int32, None), (level_offset, torch.int32, None),
        (cam, torch.float32, (3,)), (vp_dense, torch.float32, (4, 4)),
        (lights.position, torch.float32, (n_l, 3)), (lights.color, torch.float32, (n_l, 3)),
        (lights.intensity, torch.float32, (n_l,)), (lights.directional, torch.bool, (n_l,)),
        (lights.alive, torch.bool, (n_l,)), (bg, torch.float32, (3, 1, 1)),
    ]
    if bary is not None:
        specs.append((bary, torch.float32, (3, vh, vw)))
    if lists is not None:
        specs += [(lists.xk, torch.int64, shape), (lists.yk, torch.int64, shape),
                  (lists.good, torch.bool, shape)]
    if shadow is not None:
        specs += [(shadow.atlas, torch.float32, None),
                  (light_mats, torch.float32, (n_l, 6, 4, 4))]
    if planes is not None:
        planes = torch.stack(planes)
        specs.append((planes, torch.float32, (planes.shape[0],) + shape))
    index = check_inputs("shading", *specs)
    if frame.shade_rec.data_ptr() % 16:
        raise ValueError("shading kernel input: the shade records must be 16-byte aligned")
    if frame.n_lights > MAX_LIGHTS:
        raise ValueError(f"shading kernel input: {frame.n_lights} light slots, at most "
                         f"{MAX_LIGHTS}")
    # per shaded light: its shadow slot (-1 none), point or not, its traced plane (-1 none)
    casts = []
    for li in range(frame.n_lights):
        slot, point = -1, 0
        if shadow is not None and li < len(shadow.light_casts):
            s, s_dir = shadow.light_casts[li]
            if 0 <= s < shadow.atlas.shape[0]:
                slot, point = s, int(not s_dir)
        plane = -1
        if planes is not None and li < len(frame.traced_casts):
            s = frame.traced_casts[li][0]
            if 0 <= s < planes.shape[0]:
                plane = s
        casts += [slot, point, plane]
    flags = ((_F_BARY if bary is not None else 0)
             | (_F_TEXTURES if frame.enable_textures else 0)
             | (_F_NORMAL_MAPS if frame.enable_normal_maps else 0)
             | (_F_TRILINEAR if frame.trilinear else 0))
    out = torch.empty((3,) + shape, dtype=torch.float32, device=depth.device)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    ptrs = [depth, tri, bary, frame.shade_rec, atlas.packed_u32, level_size, level_offset, cam,
            vp_inv, lights.position, lights.color, lights.intensity, lights.directional,
            lights.alive, bg, None if lists is None else lists.xk,
            None if lists is None else lists.yk, None if lists is None else lists.good,
            None if shadow is None else shadow.atlas, light_mats, planes, out]
    ints = [*vp_inv.stride(), vh, vw, n, shape[0] if lists is None else 1,
            shape[-1] if lists is None else n,
            samples.step_x if lists is None else 0, samples.step_y if lists is None else 0,
            int(samples.checker) if lists is None else 0, frame.y0, frame.width,
            frame.full_height, atlas.num_levels, 0 if shadow is None else shadow.atlas.shape[-1],
            flags, frame.n_lights, *casts]
    SHADE.launch(index, (ctypes.c_uint64 * len(ptrs))(*map(ptr, ptrs)),
                 (ctypes.c_int * len(ints))(*ints), float(frame.ambient))
    return out


def sample_pixels(frame: ShadeFrame, vis, samples):
    """The pixels (x, y) of the visibility buffer that kernel 7's samples
    (a ``Lattice`` or a ``PixelList``) shade, and their triangle ids (a
    list's not-good samples NO_TRIANGLE): (h, w) for a lattice, (1, K) for
    a list."""
    dev = vis.depth.device
    if isinstance(samples, Lattice):
        vh, vw = vis.depth.shape
        gh, gw = vh // samples.step_y, vw // samples.step_x
        y = (samples.step_y * torch.arange(gh, device=dev))[:, None].expand(gh, gw)
        x = samples.step_x * torch.arange(gw, device=dev)[None, :].expand(gh, gw)
        if samples.checker:
            x = x + ((y + frame.y0) & 1)
        return x, y, vis.tri_id[y, x]
    x, y = samples.xk[None], samples.yk[None]
    return x, y, torch.where(samples.good[None], vis.tri_id[y, x], NO_TRIANGLE)


def _sample_grid(frame: ShadeFrame, vis, samples, bary):
    """``shade_samples_plain``'s grid arguments for kernel 7's samples:
    their depth, ids, pixel centres and barycentrics gathered from the
    visibility buffer."""
    x, y, tri = sample_pixels(frame, vis, samples)
    return (vis.depth[y, x], tri, x.to(torch.float32) + 0.5,
            (y + frame.y0).to(torch.float32) + 0.5, None if bary is None else bary[:, y, x])


def shade_samples_plain_at(frame: ShadeFrame, vis, samples, bary=None,
                           planes_fn=None) -> torch.Tensor:
    """``shade_samples_plain`` with kernel 7's arguments (``planes_fn`` in
    place of the planes): what ``shade_pbr`` shades on the CPU, and kernel
    7's oracle on the card. (3, h, w) for a lattice, (3, K) for a list."""
    out = shade_samples_plain(frame, *_sample_grid(frame, vis, samples, bary), planes_fn)
    return out if isinstance(samples, Lattice) else out[:, 0]


def sample_rays(frame: ShadeFrame, vis, samples, bary=None) -> tuple:
    """What the traced shadows' planes of kernel 7's samples are computed
    from, as ``shade_samples_plain`` passes it to ``planes_fn``: (world,
    geometric normal, covered, ids), from the unprojection and the
    normals' interpolation alone."""
    depth, tri, px, py, bary_s = _sample_grid(frame, vis, samples, bary)
    covered, world, _, _, n_geom = _sample_geometry(frame, depth, tri, px, py, bary_s,
                                                    rays=True)
    return world, n_geom, covered, tri


def shade_pbr(
    vis,
    shade_rec: torch.Tensor,  # (T, SR_COLS) records (geometry.build_draw_stream)
    scene,
    camera_pos: torch.Tensor,
    viewproj_inv: torch.Tensor,
    background=(0.05, 0.05, 0.08),
    ambient: float = 0.03,
    y0: int = 0,
    full_height: int = None,
    enable_textures: bool = True,
    enable_normal_maps: bool = True,
    trilinear: bool = True,
    light_slots: int = None,  # shade only the first k light-table slots
    aa: bool = False,  # edge AA (ops/aa.py)
    rt_grid: RtGrid = None,  # ray-traced shadows (ops/rt_grid.py)
    rt: RtBrute = None,  # exact ray-traced shadows by brute force (ops/rt.py)
    shadow: ShadowMaps = None,  # shadow maps (ops/shadow.py)
    # shade the (x + y) even half-lattice packed to (H, W/2) and rebuild the
    # rest from same-triangle neighbours (_checkerboard_expand)
    checkerboard: bool = False,
    # shade the (even x, even y) lattice packed to (H/2, W/2) and rebuild
    # the three other classes from their shaded neighbours (_quarter_expand)
    quarter: bool = False,
    # with checkerboard or quarter: exactly re-shade the worst rebuilt
    # pixels (_checkerboard_fix, _quarter_fix); skipped under rt_grid and
    # rt, as in the JAX package
    shade_fix: bool = True,
    # False: interpolate with the visibility buffer's barycentrics (the
    # plain configuration's scan raster, the reference view) instead of
    # re-deriving them from the records' edge columns
    bary_from_records: bool = True,
    # the shard of a split frame (parallel.sharding.Shard): the buffer holds
    # rows [y0, y0 + H) of a full_height frame, and the rebuilds, edge AA and
    # the rt upsample read the neighbouring shards' rows at its edges
    halo=None,
) -> torch.Tensor:
    """Shade a visibility buffer -> (H, W, 3) linear HDR colour. Every call
    of the shading core (the frame, a lattice, a fix's batch) is kernel 7
    (``shade_samples_kernel``) on the card and ``shade_samples_plain`` on
    the CPU."""
    if checkerboard and quarter:
        raise ValueError("checkerboard and quarter are exclusive")
    fh_, fw_ = vis.depth.shape
    dev = vis.depth.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no shading kernel for device {dev}")
    traced = rt_grid if rt_grid is not None else rt  # the ray-traced shadows, if any
    bary_in = None if bary_from_records else vis.bary
    full_height = full_height if full_height is not None else fh_
    # the background as a (3, 1, 1) fill on the device, not a host copy
    bg = torch.stack([torch.full((1, 1), float(c), dtype=torch.float32, device=dev)
                      for c in background])
    n_lights = scene.lights.alive.shape[0]
    if light_slots is not None:
        n_lights = min(light_slots, n_lights)
    frame = ShadeFrame(shade_rec, scene.atlas, scene.lights, camera_pos, viewproj_inv, fw_,
                       full_height, y0, bg, ambient, enable_textures, enable_normal_maps,
                       trilinear, n_lights, shadow,
                       None if traced is None else traced.light_casts)

    planes_fn = None  # the traced shadows' planes of a grid of samples
    if rt_grid is not None:
        def planes_fn(world, n_geom, covered, tri):
            return rt_shadow_grid(
                scene, world, n_geom, covered, rt_grid.light_mats, rt_grid.lod, rt_grid.model,
                rt_grid.scene_radius, rt_grid.caster_capacity,
                slot_lights(rt_grid.light_casts, rt_grid.n_slots), tri=tri,
                rt_scale=rt_grid.rt_scale, halo=halo,
            )
    elif rt is not None:
        def planes_fn(world, n_geom, covered, tri):
            return rt_shadow_planes(world, n_geom, scene.lights, rt.tri_world, rt.tri_valid,
                                    slot_lights(rt.light_casts, rt.n_slots), rt.rt_scale,
                                    rt.count)

    def run(samples):
        """The samples shaded: kernel 7 on the card, its plain version on
        the CPU."""
        if dev.type == "cpu":
            return shade_samples_plain_at(frame, vis, samples, bary_in, planes_fn)
        planes = None if planes_fn is None else planes_fn(*sample_rays(frame, vis, samples,
                                                                       bary_in))
        return shade_samples_kernel(frame, vis, samples, bary_in, planes)

    def shade_pixels(xk, yk, good):
        """A fix's K pixels (xk, yk) shaded, (3, K), as uncovered where not
        ``good``."""
        return run(PixelList(xk, yk, good))

    if quarter:
        # the shaded (even x, even y) lattice packed to (H/2, W/2)
        tri_s = vis.tri_id[0::2, 0::2]
        shaded = run(Lattice(2, 2))
        color, scores = _quarter_expand(shaded, vis.tri_id, tri_s, tri_s != NO_TRIANGLE, bg,
                                        halo)
        if shade_fix and traced is None:
            color = _quarter_fix(color, scores, vis, shade_pixels, halo)
    elif checkerboard:
        # the shaded half-lattice ((x + y) even) packed to (H, W/2):
        # x = 2j + ((y + y0) & 1), shaded at its true pixel centres
        rowpar = ((torch.arange(fh_, device=dev) + y0) & 1)[:, None]
        tri_s = torch.where(rowpar == 0, vis.tri_id[:, 0::2], vis.tri_id[:, 1::2])
        shaded = run(Lattice(2, 1, True))
        recon, score, _ = _checkerboard_expand(shaded, vis.tri_id, tri_s,
                                               tri_s != NO_TRIANGLE, rowpar, bg, halo)
        color = _cb_interleave(shaded, recon, rowpar)
        if shade_fix and traced is None:
            color = _checkerboard_fix(color, score, y0, shade_pixels, halo)
    else:
        color = run(Lattice())
    if aa:
        color = edge_aa(color, vis.tri_id, halo)
    return color.permute(1, 2, 0)


def fix_capacity(p2: int) -> int:
    """Suspects the fix re-shades for a P-pixel lattice: P / FIX_K_DIV, at
    least 2048, a multiple of 8, at most the lattice."""
    return min(p2 - p2 % 8, max(2048, -(-p2 // FIX_K_DIV) // 8 * 8))


def _top_suspects(scores, k: int, halo=None, axis: int = 0):
    """The k best of ``scores`` by value, in ascending flat order: (flat
    index, above FIX_TAU). Under a split frame (``halo``) ``scores`` holds
    this shard's rows (dim ``axis``) of the frame's and the k are picked
    over the whole frame, as on one shard; returned are those in this
    shard's rows, at their flat index in ``scores``, the others marked not
    good (at index 0)."""
    rows = scores.shape[axis]
    if halo is not None:
        scores = halo.all_gather(scores.transpose(0, axis)).transpose(0, axis)
    # exact top-k: the JAX package's approx_max_k is exact on the CPU too;
    # only the TPU's is approximate (recall 0.95)
    vals, idx = torch.topk(scores.reshape(-1), k)
    # ascending pixel order (the JAX package sorts for its scatter's speed)
    idx, perm = torch.sort(idx)
    good = vals[perm] > FIX_TAU
    if halo is None:
        return idx, good
    # flat index -> (outer, row, inner) of the whole frame's scores, then this shard's rows
    inner = math.prod(scores.shape[axis + 1:])
    outer, rest = idx // (scores.shape[axis] * inner), idx % (scores.shape[axis] * inner)
    row = rest // inner - halo.axis_index() * rows
    mine = (row >= 0) & (row < rows)
    local = (outer * rows + row) * inner + rest % inner
    return torch.where(mine, local, 0), good & mine


def _checkerboard_fix(color, score, y0: int, shade_pixels, halo=None):
    """Exactly re-shade the worst reconstructed pixels.

    Up to K = fix_capacity(P) suspects by neighbour-spread score, those
    above FIX_TAU, are shaded through the frame's own shading core
    (``shade_pixels(xk, yk, good)`` -> (3, K)) at their pixel centres, so
    each equals the full-rate frame's pixel, and scattered into the
    interleaved frame (3, H, W). The suspects not above FIX_TAU are shaded
    as uncovered and land in a trash column; nothing here reads a device
    value on the host. Under a split frame (``halo``) P and the suspects
    are the whole frame's (``_top_suspects``; the JAX package picks K per
    shard)."""
    h_, w_ = score.shape
    p2 = h_ * w_
    k = fix_capacity(p2 * (1 if halo is None else halo.axis_size()))
    idx, good = _top_suspects(score, k, halo)
    yk, jk = idx // w_, idx % w_
    xk = 2 * jk + (1 - ((yk + y0) & 1))  # the complement: x = 2j + 1 - parity
    return _reshade(color, shade_pixels(xk, yk, good), xk, yk, good)


def _reshade(color, color_k, xk, yk, good):
    """The K re-shaded pixels ``color_k`` (3, K) at (xk, yk) written into
    the (3, H, W) frame where ``good`` (the others into a trash column)."""
    fw_ = color.shape[-1]
    p_full = color.shape[1] * fw_
    out = torch.cat([color.reshape(3, p_full), color.new_zeros((3, 1))], dim=1)
    out.index_copy_(1, torch.where(good, yk * fw_ + xk, p_full), color_k)
    return out[:, :p_full].reshape(color.shape)


def _rebuild(planes, tri_u, shifts, bg):
    """One class of rebuilt pixels (triangle ids ``tri_u``) from its shaded
    neighbours: each of ``shifts`` takes plane k of the shaded lattice's
    ``planes`` (ids, coverage, colour (3, h, w)) to a neighbour's,
    ``sh(k, plane)``. Returns (colour (3, h, w), suspect score (h, w)).

    The neighbours on the pixel's triangle are averaged, or with four of
    them the per-channel trimmed mean (drop min and max: exact for linear
    colour, and a one-neighbour specular spike stays out); so edges never
    bleed across surfaces. Without one, the covered neighbours' mean, then
    the background; uncovered pixels take the background. The score is the
    same-triangle neighbours' colour spread summed over the channels (1e9
    for a covered pixel with none, -1 for an uncovered one)."""
    shaded = planes[2]
    cov_u = tri_u != NO_TRIANGLE
    num = torch.zeros_like(shaded)
    den = torch.zeros(tri_u.shape, dtype=torch.float32, device=shaded.device)
    numc = torch.zeros_like(shaded)
    denc = torch.zeros_like(den)
    nb_min = torch.full_like(shaded, math.inf)
    nb_max = torch.full_like(shaded, -math.inf)
    for sh in shifts:
        nb_t, nb_cov, nb_c = (sh(k, a) for k, a in enumerate(planes))
        w_same = ((nb_t == tri_u) & nb_cov).to(torch.float32)
        num = num + nb_c * w_same[None]
        den = den + w_same
        numc = numc + nb_c * nb_cov.to(torch.float32)[None]
        denc = denc + nb_cov.to(torch.float32)
        same = (w_same != 0.0)[None]
        nb_min = torch.where(same, torch.minimum(nb_min, nb_c), nb_min)
        nb_max = torch.where(same, torch.maximum(nb_max, nb_c), nb_max)
    trimmed = (num - nb_min - nb_max) * 0.5
    mean = num / torch.clamp(den, min=1.0)[None]
    recon = torch.where(
        (den > 0)[None],
        torch.where((den == 4.0)[None], trimmed, mean),
        torch.where((denc > 0)[None], numc / torch.clamp(denc, min=1.0)[None], bg),
    )
    recon = torch.where(cov_u[None], recon, bg)
    spread = torch.where((den > 0)[None], nb_max - nb_min, 0.0)
    spread = spread[0] + spread[1] + spread[2]
    return recon, torch.where(cov_u, torch.where(den == 0.0, 1e9, spread), -1.0)


def _checkerboard_expand(shaded, tri_full, tri_s, cov_s, rowpar, bg, halo=None):
    """(3, H, W/2) shaded half-lattice -> the complement lattice rebuilt,
    (3, H, W/2), its suspect score (H, W/2) and its triangle ids.

    Each missing pixel ((x + y) odd) is rebuilt from its four cardinal
    neighbours, all shaded (``_rebuild``); the upper and lower ones at the
    first and last row are the halo rows (``aa.halo_rows``)."""
    par0 = rowpar == 0
    tri_u = torch.where(par0, tri_full[:, 1::2], tri_full[:, 0::2])
    planes = (tri_s, cov_s, shaded)
    rows = halo_rows(planes, halo)

    def up(k, a):
        return _up(a, rows[k][0])

    def dn(k, a):
        return _dn(a, rows[k][1])

    def left(k, a):  # (y, x-1): packed j on parity-0 rows, j-1 on parity-1
        return torch.where(par0, a, torch.cat([a[..., :, :1], a[..., :, :-1]], dim=-1))

    def right(k, a):
        return torch.where(par0, _right(a), a)

    recon, score = _rebuild(planes, tri_u, (up, dn, left, right), bg)
    return recon, score, tri_u


def _cb_interleave(shaded, recon, rowpar):
    """(3, H, W/2) shaded + rebuilt half-lattices -> (3, H, W)."""
    par0 = rowpar == 0
    even = torch.where(par0, shaded, recon)
    odd = torch.where(par0, recon, shaded)
    return torch.stack([even, odd], dim=-1).reshape(shaded.shape[0], shaded.shape[1], -1)


def _interleave_last(a, b):
    """(..., W/2) a at even columns, b at odd -> (..., W)."""
    return torch.stack([a, b], dim=-1).reshape(a.shape[:-1] + (2 * a.shape[-1],))


def _interleave_rows(a, b):
    """(..., H/2, W) a at even rows, b at odd -> (..., H, W)."""
    return torch.stack([a, b], dim=-2).reshape(a.shape[:-2] + (2 * a.shape[-2], a.shape[-1]))


def _quarter_expand(shaded, tri_full, tri_s, cov_s, bg, halo=None):
    """(3, H/2, W/2) shaded (even x, even y) lattice -> ((3, H, W) frame,
    (3, H/2, W/2) suspect scores, one plane per rebuilt class).

    H (odd x, even y) is rebuilt from its left and right shaded
    neighbours, V (even x, odd y) from its upper and lower ones, D (odd x,
    odd y) from its four diagonal ones (``_rebuild``); the last column
    clamps to the edge, and the row below the last is the halo row below
    (``aa.halo_rows``: the clamp, or the shard below's first row)."""
    tri_h, tri_v, tri_d = tri_full[0::2, 1::2], tri_full[1::2, 0::2], tri_full[1::2, 1::2]
    planes = (tri_s, cov_s, shaded)
    below = [dn for _, dn in halo_rows(planes, halo)]

    def right(k, a):
        return _right(a)

    def down(k, a):
        return _dn(a, below[k])

    def down_right(k, a):  # the row below shifted too
        return torch.cat([_right(a)[..., 1:, :], _right(below[k])], dim=-2)

    def ident(k, a):
        return a

    recons, scores = zip(*(_rebuild(planes, tri_u, nbs, bg) for tri_u, nbs in (
        (tri_h, (ident, right)), (tri_v, (ident, down)),
        (tri_d, (ident, right, down, down_right)))))
    frame = _interleave_rows(_interleave_last(shaded, recons[0]),
                             _interleave_last(recons[1], recons[2]))
    return frame, torch.stack(scores)


def quarter_fix_capacity(p_full: int) -> int:
    """Suspects the quarter fix re-shades for a P-pixel frame: P /
    QFIX_K_DIV, at least 2048, a multiple of 8, at most the 3P/4 rebuilt."""
    p_u = 3 * (p_full // 4)
    return min(p_u - p_u % 8, max(2048, -(-p_full // QFIX_K_DIV) // 8 * 8))


def _quarter_fix(color, scores, vis, shade_pixels, halo=None):
    """Exactly re-shade the worst quarter-rebuilt pixels: up to K =
    quarter_fix_capacity(P) suspects over all three classes at once by
    score, those above FIX_TAU, through the frame's own shading core
    ``shade_pixels``, scattered into the (3, H, W) frame (the others into a
    trash column). ``halo`` as in ``_checkerboard_fix``."""
    _, h2, w2 = scores.shape
    p_u = h2 * w2
    fh_, fw_ = vis.depth.shape
    p_full = fh_ * fw_
    k = quarter_fix_capacity(p_full * (1 if halo is None else halo.axis_size()))
    idx, good = _top_suspects(scores, k, halo, axis=1)
    cls, rem = idx // p_u, idx % p_u
    # class -> pixel: H (0) = (2j + 1, 2i), V (1) = (2j, 2i + 1), D (2) = (2j + 1, 2i + 1)
    xx = 2 * (rem % w2) + (cls != 1).long()
    yy = 2 * (rem // w2) + (cls != 0).long()
    return _reshade(color, shade_pixels(xx, yy, good), xx, yy, good)
