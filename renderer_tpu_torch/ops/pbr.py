"""PBR metallic-roughness deferred shading: GGX + Smith + Schlick
(``renderer_tpu.ops.pbr``).

Everything is channel-first: vectors (3, H, W), scalars (H, W). Ported:
the full-rate path with barycentrics re-derived from the shade records'
edge columns, base-colour textures, normal maps with the Toksvig roughness
term, edge AA, and ray-traced shadows through the light-space grid
(``ops/rt_grid.py``). Shadow maps, the brute-force ray caster and the
checkerboard and quarter shade rates are later work.
"""

from __future__ import annotations

import math

import torch

from renderer_tpu_torch.ops.aa import edge_aa
from renderer_tpu_torch.ops.raster_spec import NO_TRIANGLE
from renderer_tpu_torch.ops.geometry import (
    SR_BASE, SR_BC_LAYER, SR_EDGE, SR_EMISSIVE, SR_METALLIC, SR_NM_LAYER,
    SR_NORMAL, SR_ROUGH, SR_TANGENT, SR_TEXLOD, SR_UV, unproject_depth,
)
from renderer_tpu_torch.ops.rt_grid import RtGrid, rt_shadow_grid, slot_lights
from renderer_tpu_torch.ops.texture import sample_atlas_cf, srgb_to_linear

NM_LOD_BIAS = 1.5  # normal maps sample ~one mip softer than colour

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
) -> torch.Tensor:
    """Shade a visibility buffer -> (H, W, 3) linear HDR colour."""
    h_, w_ = vis.depth.shape
    p_ = h_ * w_
    dev = vis.depth.device
    tri_in = vis.tri_id
    covered = tri_in != NO_TRIANGLE
    safe_id = torch.clamp(tri_in, min=0).reshape(p_).long()
    world = unproject_depth(
        vis.depth, viewproj_inv, w_, h_, y0=y0,
        full_height=full_height if full_height is not None else h_,
    )
    # one gather of the 45 needed record columns per pixel -> (45, P)
    cols_t = shade_rec[:, _ORDER].T.contiguous()[:, safe_id]

    def col(k):
        return cols_t[_C_OFF + _CONST.index(k)].reshape(h_, w_)

    # barycentrics: the winner's edge functions at the pixel centre
    pxf = (torch.arange(w_, dtype=torch.float32, device=dev)[None, :].expand(h_, w_)
           + 0.5).reshape(p_)
    pyf = (torch.arange(h_, dtype=torch.float32, device=dev)[:, None].expand(h_, w_)
           + float(y0) + 0.5).reshape(p_)

    def e(k):
        return cols_t[_C_OFF + 6 + k]

    lam0 = e(0) * pxf + e(1) * pyf + e(2)
    lam1 = e(3) * pxf + e(4) * pyf + e(5)
    lam2 = e(6) * pxf + e(7) * pyf + e(8)
    lsum = lam0 + lam1 + lam2
    inv = 1.0 / torch.where(lsum != 0.0, lsum, 1.0)
    b0, b1, b2 = (lam0 * inv)[None], (lam1 * inv)[None], (lam2 * inv)[None]

    attrs = b0 * cols_t[0:8] + b1 * cols_t[8:16] + b2 * cols_t[16:24]
    n_geom = _normalize_cf(attrs[0:3].reshape(3, h_, w_))
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

    if enable_textures:
        bc = sample_atlas_cf(scene.atlas, bc_layer, u, v_, tex_lod, trilinear=trilinear)
        albedo = base_factor * srgb_to_linear(bc[0:3])
    else:
        albedo = base_factor

    if enable_textures and enable_normal_maps:
        t = _normalize_cf(tangent - n_geom * _dot_cf(tangent, n_geom))
        b = _cross_cf(n_geom, t) * tan_w
        nm = sample_atlas_cf(scene.atlas, nm_layer, u, v_, tex_lod + NM_LOD_BIAS,
                             trilinear=trilinear)
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

    planes = None  # per shadow slot, the occlusion plane of its light
    if rt_grid is not None:
        planes = rt_shadow_grid(
            scene, world, n_geom, covered, rt_grid.light_mats, rt_grid.lod, rt_grid.model,
            rt_grid.scene_radius, rt_grid.caster_capacity,
            slot_lights(rt_grid.light_casts, rt_grid.n_slots), tri=tri_in,
            rt_scale=rt_grid.rt_scale,
        )

    v = _normalize_cf(camera_pos[:, None, None] - world)
    lights = scene.lights
    color = albedo * ambient + emissive
    n_slots = lights.alive.shape[0]
    if light_slots is not None:
        n_slots = min(light_slots, n_slots)
    for li in range(n_slots):
        pos = lights.position[li][:, None, None]
        directional = lights.directional[li]
        to_light = torch.where(directional, -pos * torch.ones_like(world), pos - world)
        dist2 = _dot_cf(to_light, to_light)
        l = to_light / torch.sqrt(torch.clamp(dist2, min=1e-12))
        atten = torch.where(directional, 1.0, 1.0 / torch.clamp(dist2, min=1e-4))
        radiance = lights.color[li][:, None, None] * (lights.intensity[li] * atten)
        if planes is not None and li < len(rt_grid.light_casts):
            slot = rt_grid.light_casts[li][0]
            if 0 <= slot < len(planes):
                radiance = radiance * planes[slot][None]
        contrib = _ggx_brdf(n, v, l, albedo, metallic, roughness) * radiance
        color = color + torch.where(lights.alive[li], contrib, 0.0)

    bg = torch.tensor(background, dtype=torch.float32, device=dev)[:, None, None]
    color = torch.where(covered[None], color, bg)
    if aa:
        color = edge_aa(color, vis.tri_id)
    return color.permute(1, 2, 0)
