"""Frozen copy of the port's ``renderer_tpu_torch/ops/shadow.py`` (the benchmark's plain
reference; it imports nothing of the port, and the port may change
without it). What follows is the original's docstring.

Shadow mapping (``renderer_tpu.ops.shadow``): light cameras, the cached
shadow-map atlas rendered through the tile rasterizer in depth-only mode,
and the 2x2 PCF lookup, plus the per-light view-projection and caster LOD
pick of the ray-traced shadow path.

The atlas is (n_slots, S, S) depth, one slot per shadow-casting light.
Casters are culled and expanded per light against the light's own frustum,
so off-camera geometry still casts into view. A directional slot renders
whole or as one of K horizontal bands; a point slot renders six cube faces
into a 2x3 grid of (S/2, S/4) faces. Every view is a two-sided depth-only
raster: ``raster_cuda.rasterize_cuda`` (the CUDA kernel on the card), or
with ``tile_raster=False`` the plain configuration's scan rasterizer
(``raster_scan.rasterize_scan``, its walk bounded by the view's caster
count on the device), as the JAX package's atlas takes its XLA raster
without Pallas.

The Renderer's light-cast pattern is static (``runtime.frame.light_casts``
over the whole light table: ``Renderer.atlas_casts``), so which slot holds
which kind of light is known on the host: a slot without a light is a fill
of 1.0 and costs no work. Whether a slot renders
this frame (the cache's choice) is a device tensor and is never read on
the host. Eagerly an unselected slot culls against an empty set, so its
raster walks no triangle (the scan raster's count is 0: no block), and the
result keeps the previous depth through ``torch.where``; in a captured
frame program its chain is the body of a conditional node
(``ops/control.cond``, the JAX package's ``lax.cond``) and does not run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.camera import look_at, matmul4, orthographic, perspective

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
SIG_C = 3  # independent signature components per unit (shadow_signature)
_SALTS = (2.0, 23.0, 61.0)


class ShadowMaps(NamedTuple):
    """What shading needs to look shadows up in the atlas."""

    atlas: torch.Tensor       # (n_slots, S, S) depth
    light_mats: torch.Tensor  # (L, 6, 4, 4) from light_matrices_cube
    light_casts: tuple        # (shadow_slot, directional) per shaded light, -1 none


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _cube_axes(device):
    """CUBE_FACE_DIRS and CUBE_FACE_UPS as (6, 3) tensors built on the
    device (a host tensor copied over would wait for the queued work)."""
    e = torch.eye(3, dtype=torch.float32, device=device)
    return (torch.stack([e[0], -e[0], e[1], -e[1], e[2], -e[2]]),
            torch.stack([e[1], e[1], e[2], -e[2], e[1], e[1]]))


def _scene_sphere(scene_min, scene_max):
    """(centre, radius) of the scene AABB's bounding sphere."""
    return (scene_min + scene_max) * 0.5, _norm3(scene_max - scene_min) * 0.5 + 1e-3


def light_matrices_cube(lights, scene_min, scene_max) -> torch.Tensor:
    """(L, 6, 4, 4) face view-projections per light (identity for lights
    without a shadow slot).

    Directional lights: the fitted orthographic matrix on all six faces
    (lookups use face 0). Point lights: six fov-90 perspective cameras at
    the light, packed into one atlas slot as a 2x3 face grid."""
    center, radius = _scene_sphere(scene_min, scene_max)
    position = lights.position
    dev = position.device
    d_dir = position / torch.clamp(_norm3(position), min=1e-8)[:, None]
    eye_dir = center - d_dir * (radius * 2.0)
    dist = torch.maximum(_norm3(center - position), radius * 0.05 + 1e-3)
    axes = torch.eye(3, dtype=torch.float32, device=dev)
    up_d = torch.where((d_dir[:, 1].abs() > 0.95)[:, None], axes[0], axes[1])
    m_dir = matmul4(orthographic(radius, radius, radius * 0.5, radius * 3.5),
                    look_at(eye_dir, eye_dir + d_dir, up_d))  # (L, 4, 4)
    near = torch.clamp(radius * 1e-2, min=1e-4)
    proj_pt = perspective(math.pi / 2, 1.0, near, dist + radius)  # (L, 4, 4)
    dirs, ups = _cube_axes(dev)
    eye = position[:, None, :]
    m_pt = matmul4(proj_pt[:, None], look_at(eye, eye + dirs, ups))  # (L, 6, 4, 4)
    mats = torch.where(lights.directional[:, None, None, None], m_dir[:, None], m_pt)
    want = (lights.alive & (lights.shadow_slot >= 0))[:, None, None, None]
    return torch.where(want, mats, torch.eye(4, dtype=torch.float32, device=dev))


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


def shadow_lod_bias(slot_size: int) -> float:
    """Resolution-aware caster LOD bias for a slot_size^2 atlas slot: 0 at
    the reference's 4096^2 slots, one level coarser per halving."""
    return max(0.0, math.log2(4096.0 / slot_size))


def band_matrix(m: torch.Tensor, band, k: int) -> torch.Tensor:
    """Remap NDC y of view-projection ``m`` so horizontal band ``band`` (of
    k equal bands, top to bottom) fills the viewport: row r of a (S/k, S)
    render under the result has the pixel centres of row band*(S/k) + r of
    the (S, S) render under ``m``. ``band`` may be a device tensor of any
    shape (...,), giving (..., 4, 4)."""
    band = band.to(torch.float32) if isinstance(band, torch.Tensor) else float(band)
    cshift = (1.0 - k) + 2.0 * band
    row1 = k * m[1] + (cshift[..., None] if isinstance(cshift, torch.Tensor) else cshift) * m[3]
    rows = [m[0], row1, m[2], m[3]]
    return torch.stack([r.expand(row1.shape) for r in rows], dim=-2)


# -- lookup ----------------------------------------------------------------------

def _pcf(slot_depth, tx, ty, ref_d, inside, x_lo, x_hi, y_lo, y_hi):
    """2x2 PCF of ``ref_d <= depth`` at texel coordinates (tx, ty), the taps
    clamped to [x_lo, x_hi] x [y_lo, y_hi] (the slot, or a cube face's
    rectangle). A base below a lower bound folds both taps of that axis
    onto the edge texel. 1.0 outside."""
    s = slot_depth.shape[1]
    x0f, y0f = torch.floor(tx), torch.floor(ty)
    fx, fy = tx - x0f, ty - y0f
    x0, y0 = x0f.long(), y0f.long()  # garbage outside (inf, NaN): clamped, then masked
    xc, yc = torch.clamp(x0, min=x_lo, max=x_hi), torch.clamp(y0, min=y_lo, max=y_hi)
    x1 = torch.where(x0 >= x_lo, torch.clamp(xc + 1, max=x_hi), xc)
    y1 = torch.where(y0 >= y_lo, torch.clamp(yc + 1, max=y_hi), yc)
    flat = slot_depth.reshape(-1)

    def lit(y, x):
        return (ref_d <= flat[y * s + x]).to(torch.float32)

    out = (lit(yc, xc) * (1 - fx) * (1 - fy) + lit(yc, x1) * fx * (1 - fy)
           + lit(y1, xc) * (1 - fx) * fy + lit(y1, x1) * fx * fy)
    return torch.where(inside, out, 1.0)


def _project(m16, w2):
    """Points (3, ...) under a 4x4 matrix given as its 16 entries row by row
    (``m16`` (16, ...): each entry a scalar or one per point) -> (u, v,
    depth, inside the unit cube)."""
    clip = [m16[4 * i] * w2[0] + m16[4 * i + 1] * w2[1] + m16[4 * i + 2] * w2[2] + m16[4 * i + 3]
            for i in range(4)]
    w = torch.where(clip[3].abs() > 1e-9, clip[3], 1e-9)
    u = (clip[0] / w + 1.0) * 0.5
    v = (1.0 - clip[1] / w) * 0.5
    d = clip[2] / w
    inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (d >= 0) & (d <= 1)
    return u, v, d, inside


def shadow_occlusion(world, ndl, light_mat, slot_depth, normal=None, is_point: bool = False,
                     light_pos=None, bias: float = 1e-3, slope_bias: float = 3e-3,
                     normal_offset_texels: float = 1.5) -> torch.Tensor:
    """(1, ...) shadow factor in [0, 1] of receivers ``world`` (3, ...) (an
    image or any grid of samples), with 2x2 PCF.

    A directional light samples the whole slot through face matrix 0. A
    point light picks the cube face per receiver (major axis of light ->
    receiver) and samples inside that face's rectangle of the 2x3 grid,
    taps clamped to the face. Receivers move along the geometric normal by
    ~1.5 texels (normal offset), plus a slope-scaled depth bias from
    ``ndl`` (1, ...), the clamped n.l. ``is_point`` is the static kind."""
    s = slot_depth.shape[0]
    fw, fh = s // 2, s // 4
    if light_mat.dim() == 2:
        light_mat = light_mat.expand(6, 4, 4)
    slope = torch.sqrt(torch.clamp(1.0 - ndl[0] ** 2, min=0.0)) / torch.clamp(ndl[0], min=1e-2)
    bias_term = bias + slope_bias * torch.clamp(slope, max=4.0)
    tail = (1,) * (world.dim() - 1)
    if not is_point:
        if normal is not None:
            row_norm = _norm3(light_mat[0, 0, :3]) + 1e-12
            texel_dir = 2.0 / (row_norm * s)
            w2 = world + normal * (texel_dir * normal_offset_texels)
        else:
            w2 = world
        u, v, d, inside = _project(light_mat[0].reshape(16), w2)
        return _pcf(slot_depth, u * s - 0.5, v * s - 0.5, d - bias_term, inside,
                    0, s - 1, 0, s - 1)[None]
    lp = light_pos.reshape((3,) + tail)
    if normal is not None:
        dvec = world - lp
        dist = torch.sqrt(dvec[0] * dvec[0] + dvec[1] * dvec[1] + dvec[2] * dvec[2])[None]
        w2 = world + normal * (2.0 * dist / fh * normal_offset_texels)
    else:
        w2 = world
    d_l = w2 - lp
    ax, ay, az = d_l[0].abs(), d_l[1].abs(), d_l[2].abs()
    face = torch.where(
        (ax >= ay) & (ax >= az),
        torch.where(d_l[0] >= 0, 0, 1),
        torch.where(ay >= az, torch.where(d_l[1] >= 0, 2, 3), torch.where(d_l[2] >= 0, 4, 5)),
    )
    # the receiver's face matrix, entry by entry
    u, v, d, inside = _project(light_mat.reshape(6, 16)[face].movedim(-1, 0), w2)
    col, row = face % 2, face // 2
    x_lo, y_lo = col * fw, row * fh
    return _pcf(slot_depth, x_lo + u * fw - 0.5, y_lo + v * fh - 0.5, d - bias_term, inside,
                x_lo, x_lo + fw - 1, y_lo, y_lo + fh - 1)[None]
