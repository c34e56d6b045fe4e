"""The forward frame (``renderer_tpu.passes.pipeline``) as an ordered plan of
passes, each declaring the resources it reads and writes.

Plan order: pose (identity: no skinning yet) -> prepare -> cull |
cull_occluded | transform_frozen | aabb_soup -> raster | raster_dbg ->
[shadow_pass] -> shade | shade_shadowed | shade_rt | shade_debug ->
present. The JAX package builds a plan per set of runtime switches; the
port has the switches whose passes are ported, with the JAX conditions:
``occlusion_culling`` (``cull_occluded`` refines the coarse cull against
the previous frame's depth), ``freeze_culling`` (``transform_frozen``
renders the kept draw list under the live camera), ``debug_aabbs`` (the
instances' boxes in flat colours; no shadows), ``shadows`` (the shadow-map
atlas and ``shade_shadowed``) and ``rt`` (``shade_rt``, ray-traced
shadows, which wins over ``shadows``). A pass may read a persistent
resource as the previous frame left it (``reads_prev``, the JAX package's
resource of the same name): ``vis`` and ``prev_vp`` (the last depth and
viewproj), ``draw_list`` (the last cull's list) and the cached atlas's
``shadow_cache``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.ops.cull import compact_soup
from renderer_tpu_torch.ops.debug import aabb_soup
from renderer_tpu_torch.ops.occlusion import LEVELS, occlusion_cull
from renderer_tpu_torch.ops.pbr import shade_pbr
from renderer_tpu_torch.ops.raster_cuda import (
    BLOCK, TILE_H, TILE_W, VisibilityBuffer, rasterize_cuda,
)
from renderer_tpu_torch.ops.raster_spec import DEPTH_CLEAR, NO_TRIANGLE
from renderer_tpu_torch.ops.shading import shade_flat_instance
from renderer_tpu_torch.ops.rt_grid import RtGrid, slot_lights
from renderer_tpu_torch.ops.shadow import (
    ShadowMaps, directional_light_matrices, initial_cache, light_matrices_cube,
    render_shadow_atlas_cached, render_shadow_atlas_per_light, signature_weights,
)

EXTERNAL = ("scene", "camera")  # given to every frame by the Renderer


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The fields of the JAX ``PipelineConfig`` that the ported frame reads.
    Shading is PBR (metallic-roughness), the only mode ported."""

    width: int = 256
    height: int = 256
    tri_capacity: int = 16384
    aa: str = "none"  # "edge": edge-aware AA on triangle-id edges
    cull_backface: bool = True
    background: tuple = (0.05, 0.05, 0.08)
    enable_textures: bool = True
    enable_normal_maps: bool = True
    trilinear: bool = True  # False = bilinear at the nearest-below mip
    # shade only the first k light slots (None: the Renderer sets the
    # scene's live light count)
    shade_light_slots: int = None
    rt_scale: int = 2  # ray-traced shadows trace a 1/rt_scale receiver grid
    shadow_slots: int = 4
    shadow_size: int = 512  # atlas slot resolution
    # per-light caster expansion capacity (0: tri_capacity); casters are
    # culled against each light's frustum, not the camera's
    shadow_tri_capacity: int = 0
    # persist the atlas across frames and re-render only the units whose
    # light/caster signature changed (ops/shadow.py render_shadow_atlas_cached)
    shadow_cache: bool = True
    # with shadow_cache: at most this many dirty units per frame, round robin
    # (0: every dirty unit)
    shadow_update_budget: int = 0
    # K > 1 (needs shadow_cache and budget 1): a directional slot updates as
    # K horizontal bands, one unit per frame
    shadow_progressive: int = 1
    # "full" shades every pixel; "checkerboard" shades the (x + y) even
    # half-lattice and rebuilds the rest (ops/pbr.py); "quarter" is not ported
    shade_rate: str = "full"
    shade_fix: bool = True  # checkerboard: re-shade the worst rebuilt pixels
    # cull whole 32-triangle clusters (bounding sphere, normal cone) before
    # the per-triangle cull (geometry._cluster_slot_map)
    cluster_cull: bool = False

    @property
    def expand_capacity(self) -> int:
        """Pre-cull expansion capacity (the JAX default, 2x tri_capacity)."""
        return 2 * self.tri_capacity

    @property
    def caster_capacity(self) -> int:
        """Per-light caster expansion capacity."""
        return self.shadow_tri_capacity or self.tri_capacity

    def __post_init__(self):
        if self.aa not in ("none", "edge"):
            raise ValueError(f"aa={self.aa!r}")
        if self.shade_rate == "quarter":
            raise NotImplementedError('shade_rate="quarter" is not ported')
        if self.shade_rate not in ("full", "checkerboard"):
            raise ValueError(f"shade_rate={self.shade_rate!r}")
        if self.tri_capacity % BLOCK or self.width % TILE_W or self.height % TILE_H:
            raise ValueError(
                f"need tri_capacity % {BLOCK} == 0, width % {TILE_W} == 0 and "
                f"height % {TILE_H} == 0"
            )
        if self.caster_capacity % BLOCK or self.rt_scale < 1 or self.shadow_slots < 0:
            raise ValueError(f"need shadow_tri_capacity % {BLOCK} == 0, rt_scale >= 1 "
                             "and shadow_slots >= 0")
        # the atlas's views are raster shapes: S x S slots, (S/2, S/4) cube
        # faces and (S, S/K) bands
        if self.shadow_size % (2 * TILE_W) or self.shadow_size % (4 * TILE_H):
            raise ValueError(f"need shadow_size % {2 * TILE_W} == 0 and % {4 * TILE_H} == 0")
        if self.shadow_progressive > 1 and not (
                self.shadow_cache and self.shadow_update_budget == 1
                and self.shadow_size % (self.shadow_progressive * TILE_H) == 0):
            raise ValueError("shadow_progressive needs shadow_cache, shadow_update_budget=1 "
                             f"and shadow_size % (shadow_progressive * {TILE_H}) == 0")


def initial_state(cfg: PipelineConfig, device) -> dict:
    """The persistent resources before frame 1: an empty draw list, an
    all-far visibility buffer, a zero viewproj and the cached atlas's state
    when ``cfg.shadow_cache``. Under the zero viewproj every AABB corner has
    w = 0, which occlusion culling never culls: frame 1 culls nothing. (The
    JAX package starts from the identity, under which an instance whose
    world AABB lies wholly at z > 1 is culled against the all-far depth.)"""
    h, w = cfg.height, cfg.width
    state = {
        "draw_list": geometry.DrawList.empty(cfg.tri_capacity, device),
        "vis": VisibilityBuffer(
            depth=torch.full((h, w), DEPTH_CLEAR, dtype=torch.float32, device=device),
            tri_id=torch.full((h, w), NO_TRIANGLE, dtype=torch.int32, device=device),
            bary=torch.zeros((3, h, w), dtype=torch.float32, device=device)),
        "prev_vp": torch.zeros((4, 4), dtype=torch.float32, device=device),
    }
    if cfg.shadow_cache:
        state["shadow_cache"] = initial_cache(cfg.shadow_slots, cfg.shadow_size,
                                              cfg.shadow_progressive, device)
    return state


def state_names(cfg: PipelineConfig) -> tuple:
    """The persistent resources of ``initial_state``."""
    return ("draw_list", "vis", "prev_vp") + (("shadow_cache",) if cfg.shadow_cache else ())


class Pass(NamedTuple):
    name: str
    reads: tuple
    writes: tuple
    fn: Callable  # fn(**{read: value}, **{f"{prev}_prev": value}) -> {write: value}
    reads_prev: tuple = ()  # persistent resources read as the previous frame left them


def check_plan(passes, outputs, state=()) -> None:
    """Raise ValueError unless every pass reads only external resources or
    what an earlier pass writes, reads the previous frame only of
    persistent resources (``state``), and every output is written."""
    have = set(EXTERNAL)
    for p in passes:
        missing = [r for r in p.reads if r not in have]
        missing += [f"{r} (previous frame)" for r in p.reads_prev if r not in state]
        if missing:
            raise ValueError(f"pass {p.name!r} reads {missing}, which no earlier pass writes")
        have.update(p.writes)
    missing = [o for o in outputs if o not in have]
    if missing:
        raise ValueError(f"outputs {missing} are written by no pass")


def build_forward_plan(cfg: PipelineConfig, outputs=("image",), light_casts: tuple = (),
                       shadows: bool = False, rt: bool = False, freeze_culling: bool = False,
                       debug_aabbs: bool = False, occlusion_culling: bool = False) -> list:
    """The ordered passes of one frame for the switch set, the JAX plan's
    passes. ``light_casts``, (shadow_slot, directional) per shaded light
    with slot -1 for none, picks the lights that shadow and that
    ``shade_rt`` traces."""
    w, h = cfg.width, cfg.height
    if occlusion_culling and not freeze_culling and not debug_aabbs and (w | h) % (1 << LEVELS):
        raise ValueError(f"occlusion culling's {LEVELS}-level depth pyramid needs width and "
                         f"height divisible by {1 << LEVELS}")

    def pose(scene):
        return {"scene_view": scene}

    def prepare(scene_view, camera):
        prepared = geometry.prepare_frame_columns(scene_view, camera)
        return {"prepared": prepared, "prev_vp": prepared.vp}

    def cull(scene_view, prepared):
        soup, rec = geometry.build_draw_stream(
            scene_view, prepared, cfg.expand_capacity, cfg.tri_capacity, w, h,
            cull_backface=cfg.cull_backface, cluster_cull=cfg.cluster_cull,
        )
        draw_list = geometry.DrawList(soup.instance, soup.tri_idx, soup.valid, soup.count)
        return {"soup": soup, "shade_rec": rec, "draw_list": draw_list}

    def cull_occluded(scene_view, prepared, vis_prev, prev_vp_prev):
        """The coarse cull refined against frame N-1's depth pyramid, the
        instances projected with frame N-1's viewproj (ops/occlusion.py)."""
        visible = occlusion_cull(scene_view, prepared.model, prev_vp_prev, prepared.visible,
                                 vis_prev.depth)
        return cull(scene_view, prepared._replace(visible=visible))

    def transform_frozen(scene_view, prepared, draw_list_prev):
        """The kept draw list under the live camera: no cull, so triangles
        behind the camera or facing away reach the raster's own tests."""
        soup = geometry.soup_from_draw_list(scene_view, draw_list_prev, prepared.clip_mats,
                                            prepared.model)
        soup = geometry.finalize_tex_lod(soup, w, h, scene_view.atlas.level_size[0])
        return {"soup": soup,
                "shade_rec": geometry.build_shade_records(soup, scene_view, render_size=(w, h))}

    def aabb(scene_view, prepared):
        return {"soup": compact_soup(aabb_soup(scene_view, prepared.visible, prepared.clip_mats,
                                               prepared.model, cfg.tri_capacity))}

    # PBR shading re-derives barycentrics from the records' edge columns,
    # so the raster kernel stores depth and id only; the debug view
    # interpolates the soup's normals through the raster's barycentrics
    def raster(soup, with_bary=False):
        return {"vis": rasterize_cuda(soup.clip, soup.valid, w, h,
                                      cull_backface=cfg.cull_backface, with_bary=with_bary)}

    def raster_dbg(soup):
        return raster(soup, with_bary=True)

    slots = slot_lights(light_casts, cfg.shadow_slots)
    sig_weights = {}  # the signature's fold weights, made at the first shadowed frame

    def shadow_pass(scene_view, prepared, shadow_cache_prev=None):
        """The shadow-map atlas: cached (the previous frame's state in,
        this frame's out) or rendered whole every frame."""
        lights = scene_view.lights
        smin, smax = prepared.scene_min, prepared.scene_max
        mats = light_matrices_cube(lights, smin, smax)
        args = (scene_view, mats, prepared.model, prepared.lod, slots, cfg.shadow_size,
                cfg.caster_capacity)
        if not cfg.shadow_cache:
            atlas = render_shadow_atlas_per_light(*args, scene_min=smin, scene_max=smax)
            return {"shadow": ShadowMaps(atlas, mats, light_casts)}
        n = prepared.model.shape[0]
        if n not in sig_weights:
            sig_weights[n] = signature_weights(n, prepared.model.device)
        atlas, cache = render_shadow_atlas_cached(
            *args, prev=shadow_cache_prev, budget=cfg.shadow_update_budget,
            progressive=cfg.shadow_progressive, scene_min=smin, scene_max=smax,
            weights=sig_weights[n])
        return {"shadow": ShadowMaps(atlas, mats, light_casts), "shadow_cache": cache}

    def _shade(vis, shade_rec, scene, camera, prepared, rt_grid=None, shadow_maps=None):
        return shade_pbr(
            vis, shade_rec, scene, camera.position, prepared.vp_inv,
            background=cfg.background, enable_textures=cfg.enable_textures,
            enable_normal_maps=cfg.enable_normal_maps, trilinear=cfg.trilinear,
            light_slots=cfg.shade_light_slots, aa=(cfg.aa == "edge"), rt_grid=rt_grid,
            shadow=shadow_maps, checkerboard=(cfg.shade_rate == "checkerboard"),
            shade_fix=cfg.shade_fix,
        )

    def shade(vis, shade_rec, scene_view, camera, prepared):
        return {"image_pre": _shade(vis, shade_rec, scene_view, camera, prepared)}

    def shade_shadowed(vis, shade_rec, scene_view, camera, prepared, shadow):
        return {"image_pre": _shade(vis, shade_rec, scene_view, camera, prepared,
                                    shadow_maps=shadow)}

    def shade_rt(vis, shade_rec, scene_view, camera, prepared):
        """Ray-traced shadows: per-light caster expansion, light-space
        binning and the occlusion walk (ops/rt_grid.py)."""
        smin, smax = prepared.scene_min, prepared.scene_max
        d = smax - smin
        radius = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) * 0.5 + 1e-3
        rt_grid = RtGrid(
            directional_light_matrices(scene_view.lights, smin, smax), prepared.lod,
            prepared.model, radius, cfg.caster_capacity, light_casts, cfg.shadow_slots,
            cfg.rt_scale,
        )
        return {"image_pre": _shade(vis, shade_rec, scene_view, camera, prepared, rt_grid)}

    def shade_debug(vis, soup):
        return {"image_pre": shade_flat_instance(vis, soup, background=cfg.background)}

    def present(image_pre):
        return {"image": image_pre}

    geo_reads = ("scene_view", "prepared")
    culled = ("soup", "shade_rec", "draw_list")
    passes = [
        Pass("pose", ("scene",), ("scene_view",), pose),
        Pass("prepare", ("scene_view", "camera"), ("prepared", "prev_vp"), prepare),
    ]
    if debug_aabbs:
        passes += [Pass("aabb_soup", geo_reads, ("soup",), aabb),
                   Pass("raster_dbg", ("soup",), ("vis",), raster_dbg),
                   Pass("shade_debug", ("vis", "soup"), ("image_pre",), shade_debug)]
    else:
        if freeze_culling:
            passes.append(Pass("transform_frozen", geo_reads, ("soup", "shade_rec"),
                               transform_frozen, reads_prev=("draw_list",)))
        elif occlusion_culling:
            passes.append(Pass("cull_occluded", geo_reads, culled, cull_occluded,
                               reads_prev=("vis", "prev_vp")))
        else:
            passes.append(Pass("cull", geo_reads, culled, cull))
        passes.append(Pass("raster", ("soup",), ("vis",), raster))
        # the JAX plan drops a pass whose writes nobody reads, unless one of
        # them is persistent: under rt only the cached atlas keeps its pass
        if shadows and cfg.shadow_cache:
            passes.append(Pass("shadow_pass", geo_reads, ("shadow", "shadow_cache"),
                               shadow_pass, reads_prev=("shadow_cache",)))
        elif shadows and not rt:
            passes.append(Pass("shadow_pass", geo_reads, ("shadow",), shadow_pass))
        shade_reads = ("vis", "shade_rec", "scene_view", "camera", "prepared")
        if rt:
            passes.append(Pass("shade_rt", shade_reads, ("image_pre",), shade_rt))
        elif shadows:
            passes.append(Pass("shade_shadowed", shade_reads + ("shadow",), ("image_pre",),
                               shade_shadowed))
        else:
            passes.append(Pass("shade", shade_reads, ("image_pre",), shade))
    passes.append(Pass("present", ("image_pre",), ("image",), present))
    check_plan(passes, outputs, state=state_names(cfg))
    return passes
