"""Shadow mapping (``renderer_tpu.ops.shadow``): light cameras, the cached
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

The cached atlas's change detection, a signature per unit, is kernel 8
on the card (``shadow_signature_kernel``, ``csrc/signature.cu``) and the
plain version ``shadow_signature`` on the CPU (``signatures``).

Under a frame trace (``utils.profiling``) the cached atlas stamps three
spans: ``shadow.signature`` (signatures and the selection),
``shadow.slots`` (every slot's ``cond``: the copy of its previous depth and
any band it renders) and ``shadow.stack`` (the slots stacked into the
atlas).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from renderer_tpu_torch.mathx.camera import (frustum_planes, look_at, matmul4, orthographic,
                                             perspective)
from renderer_tpu_torch.ops.control import cond
from renderer_tpu_torch.ops.cuda_build import check_inputs, library
from renderer_tpu_torch.ops.geometry import clip_rows, coarse_cull, expand_clip_only
from renderer_tpu_torch.ops.raster_cuda import rasterize_cuda
from renderer_tpu_torch.ops.raster_scan import rasterize_scan
from renderer_tpu_torch.utils.profiling import span

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
_KIND = {True: 17.0, False: 39.0}  # a unit's kind term, by directional
_EMPTY = (-1e30, -2e30)  # the sentinels of an empty slot's unit 0 and of an untracked unit


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


def directional_light_matrices(lights, scene_min, scene_max) -> torch.Tensor:
    """(L, 4, 4) light view-projection per light (identity for lights
    without a shadow slot): the single-face variant of the ray-traced
    shadow path.

    Directional lights: an orthographic box fitted around the scene AABB,
    looking along the light direction from outside the scene. Point
    lights: a perspective camera at the light aimed at the scene centre,
    fov fitted to the scene's bounding sphere. All lights are computed at
    once, as the JAX package's vmap does."""
    center, radius = _scene_sphere(scene_min, scene_max)
    position = lights.position
    directional = lights.directional[:, None]
    d_dir = position / torch.clamp(_norm3(position), min=1e-8)[:, None]
    eye_dir = center - d_dir * (radius * 2.0)
    to_c = center - position
    dist = torch.maximum(_norm3(to_c), radius * 0.1 + 1e-3)
    eye = torch.where(directional, eye_dir, position)
    look_dir = torch.where(directional, d_dir, to_c / dist[:, None])
    axes = torch.eye(3, dtype=torch.float32, device=position.device)
    up = torch.where((look_dir[:, 1].abs() > 0.95)[:, None], axes[0], axes[1])
    view = look_at(eye, eye + look_dir, up)
    proj_dir = orthographic(radius, radius, radius * 0.5, radius * 3.5)
    fov = torch.clamp(2.0 * torch.atan(radius / dist), 0.2, 2.8)
    proj_pt = perspective(fov, 1.0, torch.maximum(dist - radius, radius * 0.02), dist + radius)
    proj = torch.where(directional[:, :, None], proj_dir, proj_pt)
    mats = matmul4(proj, view)
    want = (lights.alive & (lights.shadow_slot >= 0))[:, None, None]
    return torch.where(want, mats, torch.eye(4, dtype=torch.float32, device=mats.device))


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


def shadow_caster_truncation(scene, model: torch.Tensor, lod: torch.Tensor,
                             light_mats: torch.Tensor, n_slots: int, caster_capacity: int,
                             slot_size: int = 4096, scene_min=None,
                             scene_max=None) -> torch.Tensor:
    """(n_slots,) int64: the shadow casters each slot's expansion drops this
    frame (its demand past ``caster_capacity``; a point light's worst
    face), with the render path's caster LOD picks. ``light_mats`` is
    ``light_matrices_cube``'s (L, 6, 4, 4). For the HUD, between frames."""
    lights = scene.lights
    mesh_id = scene.instances.mesh_id.long()

    def demand(visible, lod_pick):
        return torch.where(visible, scene.meshes.lod_tri_count[mesh_id, lod_pick], 0).sum()

    out = []
    for slot in range(n_slots):
        match = (lights.shadow_slot == slot) & lights.alive
        li = torch.argmax(match.to(torch.int32))
        active = match.any()
        is_point = active & ~lights.directional[li]
        vis_d = coarse_cull(scene, model, light_mats[li, 0]) & active
        if scene_min is not None:
            center, radius = _scene_sphere(scene_min, scene_max)
            pos = lights.position[li]
            eye = center - pos / torch.clamp(_norm3(pos), min=1e-8) * (radius * 2.0)
            lod_d = lod_by_distance(scene, model, eye, bias=shadow_lod_bias(slot_size))
        else:
            lod_d = lod
        lod_l = lod_by_distance(scene, model, lights.position[li],
                                bias=shadow_lod_bias(slot_size))
        worst = torch.stack([demand(coarse_cull(scene, model, light_mats[li, f]) & active, lod_l)
                             for f in range(6)]).max()
        d = torch.where(is_point, worst, demand(vis_d, lod_d))
        out.append(torch.clamp(d - caster_capacity, min=0))
    return torch.stack(out)


def shadow_lod_bias(slot_size: int) -> float:
    """Resolution-aware caster LOD bias for a slot_size^2 atlas slot: 0 at
    the reference's 4096^2 slots, one level coarser per halving."""
    return max(0.0, math.log2(4096.0 / slot_size))


def cube_face_matrices(near, far) -> torch.Tensor:
    """(6, 4, 4) fov-90 view-projections of the cube faces around the origin
    (a light-centred frame)."""
    proj = perspective(math.pi / 2, 1.0, near, far)
    dirs, ups = _cube_axes(proj.device)
    return matmul4(proj, look_at(torch.zeros_like(dirs[0]), dirs, ups))


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


# -- change detection and scheduling -------------------------------------------

def _weights(n: int, salt: float, device) -> torch.Tensor:
    """(n,) deterministic pseudo-random fold weights in ~[-1, 1] (change
    detection only: a collision needs an exact cancellation)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.sin(i * 12.9898 + salt * 78.233)


class SignatureWeights(NamedTuple):
    """The constant fold weights of ``shadow_signature`` for N instances, per
    salt: made once (``signature_weights``) and reused every frame."""

    light: tuple       # (6, 16) per salt: the fold of a light's face matrices
    model_cols: tuple  # (16,) per salt
    rows: tuple        # (N,) per salt: weights of the model fold
    mesh: tuple        # (N,) per salt: weights of the mesh id
    count: tuple       # (N,) per salt: the per-instance count term


def signature_weights(n_instances: int, device) -> SignatureWeights:
    out = [[], [], [], [], []]
    for salt in _SALTS:
        out[0].append(_weights(6, salt + 3.0, device)[:, None]
                      * _weights(16, salt + 4.0, device)[None, :])
        out[1].append(_weights(16, salt + 1.0, device))
        out[2].append(_weights(n_instances, salt, device))
        out[3].append(_weights(n_instances, salt + 11.0, device)
                      * _weights(1, salt + 12.0, device)[0])
        out[4].append(_weights(n_instances, salt + 29.0, device))
    return SignatureWeights(*(tuple(v) for v in out))


def signature_visibility(scene, model: torch.Tensor, light_mats: torch.Tensor, slot: tuple,
                         progressive: int = 1) -> torch.Tensor:
    """(units, N) bool: the instances each unit of the live slot ``slot``
    (light index, directional) folds, culled by ``coarse_cull`` as the render
    culls them: a directional slot's ``progressive`` band frustums (its whole
    frustum under progressive <= 1), a point slot's six faces as one unit."""
    li, directional = slot
    mats = light_mats[li]  # (6, 4, 4)
    if directional and progressive > 1:  # one unit per band
        return coarse_cull(scene, model, band_matrix(
            mats[0], torch.arange(progressive, device=mats.device), progressive))
    if directional:
        return coarse_cull(scene, model, mats[0])[None]
    return coarse_cull(scene, model, mats).any(dim=0, keepdim=True)  # the union of the faces


def shadow_signature(scene, light_mats: torch.Tensor, model: torch.Tensor, slots: tuple,
                     progressive: int = 1, weights: SignatureWeights = None) -> torch.Tensor:
    """Per-unit f32 change-detection signatures of the cached atlas.

    progressive=1: (n_slots, SIG_C), one unit per slot. progressive=K>1:
    (n_slots, K, SIG_C); a directional slot is K horizontal band units,
    each folding only the casters its band frustum can see, so a moving
    caster dirties only the bands it projects into. Point and empty slots
    track on band 0; their bands 1..K-1 hold a constant and are never dirty.

    A unit's depth is a function of its light's face matrices, its kind
    and the casters inside its frustum (model matrices, mesh ids), culled
    by ``coarse_cull`` as the render culls them. The fold has SIG_C
    independently salted components, so a change must round away in all
    of them to be missed. An empty slot holds a sentinel. ``slots`` is
    ``rt_grid.slot_lights`` of the light-cast pattern."""
    flat = model.reshape(model.shape[0], -1).to(torch.float32)
    dev = flat.device
    if weights is None:
        weights = signature_weights(flat.shape[0], dev)
    mid = scene.instances.mesh_id.to(torch.float32)
    # the caster fold is bilinear in (instance weights x column weights), so
    # the column contraction is done once: one (N,) profile per salt
    profiles = [(flat * wk[None, :]).sum(dim=1) * wr + mid * wm + wc
                for wk, wr, wm, wc in zip(*weights[1:])]

    def sentinel(v, n=1):
        return torch.full((n, SIG_C), v, dtype=torch.float32, device=dev)

    out = []
    for slot in slots:
        if slot is None:
            units = [sentinel(_EMPTY[0]), sentinel(_EMPTY[1], progressive - 1)]
        else:
            li, directional = slot
            mats = light_mats[li]  # (6, 4, 4)
            vis = signature_visibility(scene, model, light_mats, slot, progressive)
            visf = vis.to(torch.float32)  # (units, N)
            kind = _KIND[directional]
            comps = [torch.sum(mats.reshape(6, 16) * wl) + kind + (visf * prof).sum(dim=-1)
                     for wl, prof in zip(weights.light, profiles)]
            units = [torch.stack(comps, dim=-1), sentinel(_EMPTY[1], progressive - vis.shape[0])]
        sig = torch.cat(units)
        out.append(sig if progressive > 1 else sig[0])
    return torch.stack(out)


class SignatureSlot(NamedTuple):
    """One slot of kernel 8's unit table (``signature_units``)."""

    light: int    # the slot's light, -1 for an empty slot
    units: int    # units it tracks: K bands of a directional slot, else 1 (0 empty)
    views: int    # frustums a unit unions: 1, or a point light's 6 cube faces
    view0: int    # its first frustum in ``signature_planes``' table
    kind: float   # its kind term


def signature_units(slots: tuple, progressive: int = 1) -> tuple:
    """Kernel 8's unit table, per slot a ``SignatureSlot``, from the static
    slot pattern (``rt_grid.slot_lights``) as ``shadow_signature`` reads it:
    a directional slot is ``progressive`` band units (one under
    progressive <= 1), a point slot one unit of six faces, an empty slot no
    unit. Frustums are numbered in slot order."""
    out, view0 = [], 0
    for slot in slots:
        if slot is None:
            out.append(SignatureSlot(-1, 0, 0, 0, 0.0))
            continue
        li, directional = slot
        units, views = (max(progressive, 1), 1) if directional else (1, 6)
        out.append(SignatureSlot(li, units, views, view0, _KIND[directional]))
        view0 += units * views
    return tuple(out)


def signature_planes(light_mats: torch.Tensor, table: tuple) -> torch.Tensor:
    """(views, 6, 4): the frustum planes of every unit of ``table``
    (``signature_units``) in one batched plain call, bit for bit the planes
    that ``coarse_cull`` takes per slot in ``shadow_signature``: the band
    matrices of all banded slots through one ``band_matrix`` (each matrix
    given as its rows, so ``m[r]`` is row r of all of them), then one
    ``frustum_planes``. Elementwise operations and a norm over three
    elements do not depend on the batch."""
    banded = [e for e in table if e.views == 1 and e.units > 1]
    if banded:
        k = banded[0].units
        m = torch.stack([light_mats[e.light, 0] for e in banded])  # (B, 4, 4)
        bands = iter(band_matrix(m.transpose(0, 1)[:, :, None, :],
                                 torch.arange(k, device=m.device), k))  # (B, K, 4, 4)
    chunks = []
    for e in table:
        if e.light < 0:
            continue
        if e.views == 1 and e.units > 1:
            chunks.append(next(bands))
        elif e.views == 1:
            chunks.append(light_mats[e.light, :1])
        else:
            chunks.append(light_mats[e.light])
    if not chunks:
        return light_mats.new_zeros((0, 6, 4))
    return frustum_planes(torch.cat(chunks))


# kernel 8 (csrc/signature.cu): the signatures in one call
_SIG_TILE = 256  # csrc/signature.cu's THREADS: instances per tile
LIBRARY = library("signature.cu")
_PTR = ctypes.c_void_p
SIGNATURE = LIBRARY.kernel("rtt_signature", [_PTR, _PTR, _PTR])


def shadow_signature_kernel(scene, light_mats: torch.Tensor, model: torch.Tensor, slots: tuple,
                            progressive: int = 1,
                            weights: SignatureWeights = None) -> torch.Tensor:
    """Kernel 8: ``shadow_signature``'s arguments and shape, CUDA tensors
    only. Each unit's visible instances are ``coarse_cull``'s bit for bit
    (the planes from ``signature_planes``); the fold takes the same weights
    and sums in the kernel's own fixed order, so its values are not the
    plain version's, but the same inputs give the same bits on every call
    and replay, and the same units change. Reads no device value on the
    host. ``SIGNATURE.launches`` counts the launches."""
    n = model.shape[0]
    flat = model.reshape(n, 16)
    inst, meshes = scene.instances, scene.meshes
    n_mesh, n_light = meshes.mesh_aabb_min.shape[0], light_mats.shape[0]
    index = check_inputs(
        "shadow signature", (flat, torch.float32, (n, 16)), (inst.mesh_id, torch.int32, (n,)),
        (meshes.mesh_aabb_min, torch.float32, (n_mesh, 3)),
        (meshes.mesh_aabb_max, torch.float32, (n_mesh, 3)), (inst.alive, torch.bool, (n,)),
        (light_mats, torch.float32, (n_light, 6, 4, 4)))
    if flat.data_ptr() % 16:
        raise ValueError("shadow signature kernel input: the model rows must be 16-byte aligned")
    n_units = max(progressive, 1)
    if weights is None:
        weights = signature_weights(n, flat.device)
    table = signature_units(slots, progressive)
    planes = signature_planes(light_mats, table)
    fields = (weights.model_cols, weights.rows, weights.mesh, weights.count, weights.light)
    check_inputs("shadow signature", (planes, torch.float32, (planes.shape[0], 6, 4)),
                 *((w, torch.float32, shape) for field, shape in zip(
                     fields, ((16,), (n,), (n,), (n,), (6, 16))) for w in field))
    tiles = -(-n // _SIG_TILE)
    dev = flat.device
    partial = torch.empty((len(slots) * n_units * max(tiles, 1) * SIG_C,), dtype=torch.float32,
                          device=dev)
    shape = (len(slots), n_units, SIG_C) if progressive > 1 else (len(slots), SIG_C)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    ptrs = [flat, inst.mesh_id, meshes.mesh_aabb_min, meshes.mesh_aabb_max, inst.alive, planes,
            light_mats, *(w for field in fields for w in field), partial, out]
    ints = [n, tiles, len(slots), n_units, n_mesh]
    for e in table:
        ints += [e.light, e.units, e.views, e.view0]
    floats = [*_EMPTY, *(e.kind for e in table)]
    SIGNATURE.launch(index, (ctypes.c_uint64 * len(ptrs))(*(t.data_ptr() for t in ptrs)),
                     (ctypes.c_int * len(ints))(*ints), (ctypes.c_float * len(floats))(*floats))
    return out


def signatures(scene, light_mats: torch.Tensor, model: torch.Tensor, slots: tuple,
               progressive: int = 1, weights: SignatureWeights = None) -> torch.Tensor:
    """The cached atlas's per-unit signatures: kernel 8
    (``shadow_signature_kernel``) on the card, the plain version
    ``shadow_signature`` on the CPU."""
    dev = model.device
    if dev.type == "cuda":
        return shadow_signature_kernel(scene, light_mats, model, slots, progressive, weights)
    if dev.type == "cpu":
        return shadow_signature(scene, light_mats, model, slots, progressive, weights)
    raise ValueError(f"no shadow signature kernel for device {dev}")


def select_shadow_updates(sig: torch.Tensor, sig_prev: torch.Tensor, cursor: torch.Tensor,
                          budget: int):
    """Round-robin budgeted scheduling of dirty units.

    Returns (selected (n,) bool, new_sig, new_cursor). A unit is dirty when
    any component of its signature changed (a NaN previous signature, the
    initial state, is always dirty). With budget <= 0 every dirty unit
    renders; otherwise at most ``budget`` dirty units, taken in round-robin
    order from ``cursor``, and the cursor moves past the last one served.
    Units not served keep their old signature and stay dirty. Everything
    stays on the device."""
    n = sig.shape[0]
    dirty = ~torch.all(sig == sig_prev, dim=-1) if sig.dim() == 2 else ~(sig == sig_prev)
    if budget <= 0 or budget >= n:
        sel, new_cursor = dirty, cursor
    else:
        order = torch.remainder(torch.arange(n, dtype=torch.int32, device=sig.device) - cursor, n)
        pri = torch.where(dirty, order, n + 1)
        rank = torch.argsort(pri, stable=True)
        sel_sorted = (torch.arange(n, device=sig.device) < budget) & (pri[rank] <= n)
        sel = torch.zeros_like(dirty).scatter(0, rank, sel_sorted)
        last_order = torch.max(torch.where(sel, order, -1))
        new_cursor = torch.where(sel.any(), torch.remainder(cursor + last_order + 1, n),
                                 cursor).to(torch.int32)
    new_sig = torch.where(sel[:, None] if sig.dim() == 2 else sel, sig, sig_prev)
    return sel, new_sig, new_cursor


def initial_cache(n_slots: int, slot_size: int, progressive: int, device) -> tuple:
    """The cache's state before frame 1: (atlas of ones, NaN signatures, so
    every unit is dirty, cursor 0)."""
    sig_shape = (n_slots, SIG_C) if progressive <= 1 else (n_slots, progressive, SIG_C)
    return (torch.ones((n_slots, slot_size, slot_size), dtype=torch.float32, device=device),
            torch.full(sig_shape, math.nan, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def render_shadow_atlas_cached(scene, light_mats, model, lod, slots: tuple, slot_size: int,
                               caster_capacity: int, prev: tuple, budget: int = 0,
                               progressive: int = 1, scene_min=None, scene_max=None,
                               weights: SignatureWeights = None, tile_raster: bool = True):
    """The cached atlas: re-render only the units whose signature changed,
    at most ``budget`` of them per frame (round robin). A static scene
    converges to no raster work. ``prev`` is the state (atlas, sig, cursor)
    of ``initial_cache`` or of the previous frame. progressive=K>1 (needs
    budget 1) schedules (slot, band) units: at most one band renders per
    frame. Returns (atlas, (atlas, new_sig, new_cursor))."""
    atlas_prev, sig_prev, cursor = prev
    n_slots = len(slots)
    if progressive > 1 and (budget != 1 or slot_size % progressive):
        raise ValueError("progressive band updates need budget 1 and slot_size % K == 0")
    with span("shadow.signature"):
        sig = signatures(scene, light_mats, model, slots, progressive, weights)
        if progressive > 1:
            sel, new_sig, new_cursor = select_shadow_updates(
                sig.reshape(n_slots * progressive, -1),
                sig_prev.reshape(n_slots * progressive, -1), cursor, 1)
            sel, new_sig = sel.reshape(n_slots, progressive), new_sig.reshape(sig.shape)
        else:
            sel, new_sig, new_cursor = select_shadow_updates(sig, sig_prev, cursor, budget)
    atlas = render_shadow_atlas_per_light(
        scene, light_mats, model, lod, slots, slot_size, caster_capacity, selected=sel,
        atlas_prev=atlas_prev, scene_min=scene_min, scene_max=scene_max, progressive=progressive,
        tile_raster=tile_raster)
    return atlas, (atlas, new_sig, new_cursor)


def render_shadow_atlas_per_light(scene, light_mats, model, lod, slots: tuple, slot_size: int,
                                  caster_capacity: int, selected=None, atlas_prev=None,
                                  scene_min=None, scene_max=None, progressive: int = 1,
                                  tile_raster: bool = True):
    """(n_slots, S, S) depth atlas with per-light caster cull and expansion.

    ``slots``: per slot (light index, directional) or None
    (``rt_grid.slot_lights``). A directional slot culls against its light
    matrix and renders the whole slot, or with ``progressive`` K > 1 the
    band of ``selected[slot]`` (at most one set) into ``atlas_prev``'s rows;
    a point slot renders its six faces into the 2x3 grid, padded with 1.0.
    ``selected`` (per slot, or (n_slots, K)) and ``atlas_prev`` come from the
    cache: an unselected slot keeps its previous depth.

    Caster LOD: point slots pick by distance to the light; directional
    slots by distance to the light's virtual eye when the scene bounds are
    given (camera-independent, so the cache stays exact as the camera
    moves), else the camera's ``lod``. ``tile_raster=False`` rasterizes
    the views through the scan rasterizer."""
    if progressive > 1 and (selected is None or atlas_prev is None):
        raise ValueError("progressive band renders need the cache's selection and atlas")
    dev = light_mats.device
    s = slot_size
    fw, fh = s // 2, s // 4
    bias = shadow_lod_bias(s)

    def render_view(m, on, w, h, lod_pick):
        visible = coarse_cull(scene, model, m)
        if on is not None:
            visible = visible & on
        clip, valid, count = expand_clip_only(scene, visible, lod_pick, clip_rows(m, model),
                                              caster_capacity)
        if tile_raster:
            return rasterize_cuda(clip, valid, w, h, cull_backface=False, with_bary=False).depth
        return rasterize_scan(clip, valid, w, h, cull_backface=False, with_bary=False,
                              count=count).depth

    def ones(h):
        return torch.ones((h, s), dtype=torch.float32, device=dev)

    def render_slot(li, directional, on, row, prev):
        """The slot's depth (S, S): its views' cull, expansion and raster."""
        if directional:
            if scene_min is not None:
                center, radius = _scene_sphere(scene_min, scene_max)
                pos = scene.lights.position[li]
                eye = center - pos / torch.clamp(_norm3(pos), min=1e-8) * (radius * 2.0)
                lod_pick = lod_by_distance(scene, model, eye, bias=bias)
            else:
                lod_pick = lod
            m = light_mats[li, 0]
            if progressive > 1:
                bh = s // progressive
                band = torch.argmax(row.to(torch.int32))
                depth = render_view(band_matrix(m, band, progressive), on, s, bh, lod_pick)
                rows = band * bh + torch.arange(bh, device=dev)
                return prev.index_copy(0, rows, depth)
            return render_view(m, on, s, s, lod_pick)
        lod_l = lod_by_distance(scene, model, scene.lights.position[li], bias=bias)
        grid = [torch.cat([render_view(light_mats[li, 2 * r + c], on, fw, fh, lod_l)
                           for c in range(2)], dim=1) for r in range(3)]
        return torch.cat(grid + [ones(s - 3 * fh)], dim=0)

    out = []
    with span("shadow.slots"):
        for slot, light in enumerate(slots):
            if light is None:
                out.append(ones(s))
                continue
            prev = None if atlas_prev is None else atlas_prev[slot]
            row = None if selected is None else selected[slot]
            on = None if row is None else (row.any() if progressive > 1 else row)
            fresh = functools.partial(render_slot, *light, on, row, prev)
            # lax.cond's counterpart: an unselected slot skips its chain under a
            # captured frame program with conditional nodes (ops/control.py)
            out.append(fresh() if on is None else cond(on, fresh, prev))
    with span("shadow.stack"):
        return torch.stack(out)


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
