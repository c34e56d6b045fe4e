"""The forward frame (``renderer_tpu.passes.pipeline``) as an ordered plan of
passes, each declaring the resources it reads and writes.

Plan order: pose -> prepare -> cull | cull_occluded | transform_frozen |
aabb_soup -> raster | raster_dbg -> [shadow_pass] -> shade |
shade_shadowed | shade_rt | shade_debug -> [resolve] -> present |
reference_view | overlay_pass. The JAX package builds a plan per set of
runtime switches; the port has them all, with the JAX conditions:
``occlusion_culling`` (``cull_occluded`` refines the coarse cull against
the previous frame's depth), ``freeze_culling`` (``transform_frozen``
renders the kept draw list under the live camera), ``debug_aabbs`` (the
instances' boxes in flat colours; no shadows), ``shadows`` (the shadow-map
atlas and ``shade_shadowed``), ``rt`` (``shade_rt``, ray-traced shadows,
which wins over ``shadows``), ``reference_image`` (``reference_view``:
the same soup through the independent scan rasterizer at a quarter of
the size, a diff heat map over the frame) and ``hud`` (``overlay_pass``:
the 2D overlay blended over the frame). With ``PipelineConfig.skinning``
the pose pass poses the skinned vertices at the ``time`` external; with
``ssaa`` > 1 the frame renders at ssaa times the size and ``resolve``
box-filters it down. A pass may read a persistent resource as the
previous frame left it (``reads_prev``, the JAX package's resource of
the same name): ``vis`` and ``prev_vp`` (the last depth and viewproj),
``draw_list`` (the last cull's list) and the cached atlas's
``shadow_cache``.

``PipelineConfig.tile_raster`` picks between the JAX package's two
configurations. True (the port's default): the draw stream is built,
culled and Morton-sorted in one pass (``geometry.build_draw_stream``),
kernel 1 rasterizes the frame and the atlas, shading derives barycentrics
from the records' edge columns, and ``rt`` traces through the light-space
grid. False (the JAX package's default, ``use_pallas=False``): the cull
expands, culls and compacts the stream (``expand_draw_stream``,
``cull_triangles``, ``compact_soup``) and packs records without edge
columns, the scan rasterizer (``ops/raster_scan.py``) rasterizes the
frame and the atlas with barycentrics, shading interpolates with those,
and ``rt`` traces by brute force against the culled soup (``ops/rt.py``).
``cluster_cull`` has no effect there, as in the JAX package, where only
``build_draw_stream`` reads it.

``PipelineConfig.spmd_devices`` = n > 1 makes the same plan the split
frame, run by ``Renderer(spmd_mesh=...)`` on n shards, each reading its
``parallel.sharding.Shard`` (the JAX plan's SPMD branches): each shard
culls and expands every n-th instance (strided, at 1/n of the
capacities) and the culled soups and shade records are gathered once;
each shard rasterizes and shades its rows [i H/n, (i + 1) H/n) of the
frame, with halo rows from its neighbours where shading reads across a
shard edge; ``cull_occluded`` gathers the previous depth first; the
shadow atlas, the frozen and debug soups are made whole on every shard;
``present``, ``overlay_pass`` and ``reference_view`` gather the rows. It
needs the tile raster, as the JAX package needs Pallas. Two steps go
past the JAX plan so that the split frame is the single-shard frame
(while no shard's capacity overflows): the gathered stream, whose valid
mask is segmented by shard, is put back in the cull's order
(``geometry.draw_order``), so a depth tie falls to the triangle that wins
it on one shard; and the checkerboard and quarter fixes pick their
suspects over the whole frame (``ops/pbr.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.ops.cull import compact_soup
from renderer_tpu_torch.ops.debug import aabb_soup
from renderer_tpu_torch.ops.occlusion import LEVELS, occlusion_cull
from renderer_tpu_torch.ops.overlay import (
    Overlay, build_font_atlas, compose_overlay, host_to_device,
)
from renderer_tpu_torch.ops.pbr import shade_pbr
from renderer_tpu_torch.ops.raster_cuda import (
    BLOCK, TILE_H, TILE_W, VisibilityBuffer, rasterize_cuda,
)
from renderer_tpu_torch.ops.raster_scan import rasterize_scan
from renderer_tpu_torch.ops.raster_spec import DEPTH_CLEAR, NO_TRIANGLE
from renderer_tpu_torch.ops.rt import RtBrute, triangles_world
from renderer_tpu_torch.ops.shading import shade_flat_instance, shade_lambert
from renderer_tpu_torch.ops.skin import pose_scene
from renderer_tpu_torch.ops.rt_grid import RtGrid, slot_lights
from renderer_tpu_torch.ops.shadow import (
    ShadowMaps, directional_light_matrices, initial_cache, light_matrices_cube,
    render_shadow_atlas_cached, render_shadow_atlas_per_light, signature_weights,
)
from renderer_tpu_torch.parallel.sharding import current_shard
from renderer_tpu_torch.utils.profiling import span

# given to every frame by the Renderer: the scene, the camera, the
# animation clock (a () tensor, under skinning) and the 2D overlay tables
EXTERNAL = ("scene", "camera", "time", "overlay")
REFERENCE_SCALE = 4  # the reference view renders at 1/4 of the width and height
REFERENCE_TINT_AT = 0.08  # mean abs difference over which a reference cell is tinted
SCAN_CAPACITY_ALIGN = 128  # the plain configuration's tri_capacity multiple (the JAX check)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The fields of the JAX ``PipelineConfig`` that the ported frame reads."""

    width: int = 256
    height: int = 256
    tri_capacity: int = 16384
    # supersampling: the frame renders at (ssaa * width, ssaa * height) and
    # the resolve pass box-filters it down
    ssaa: int = 1
    aa: str = "none"  # "edge": edge-aware AA on triangle-id edges (PBR only)
    cull_backface: bool = True
    background: tuple = (0.05, 0.05, 0.08)
    shading: str = "pbr"  # "pbr" (GGX metallic-roughness) or "lambert"
    skinning: bool = False  # the pose pass: skinned vertices posed at `time`
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
    # half-lattice and rebuilds the rest, "quarter" the (even x, even y)
    # lattice and rebuilds three of four pixels (ops/pbr.py); PBR only
    shade_rate: str = "full"
    shade_fix: bool = True  # checkerboard, quarter: re-shade the worst rebuilt pixels
    # cull whole 32-triangle clusters (bounding sphere, normal cone) before
    # the per-triangle cull (geometry._cluster_slot_map); tile raster only
    cluster_cull: bool = False
    # the JAX package's use_pallas: True rasterizes with kernel 1 (the
    # port's main path), False is the plain configuration (the module
    # docstring). The default differs from the JAX package's (False) on
    # purpose: the port's main path is kernel 1
    tile_raster: bool = True
    # > 1: the split frame over that many shards (the module docstring),
    # rendered by Renderer(spmd_mesh=...)
    spmd_devices: int = 1

    @property
    def expand_capacity(self) -> int:
        """Pre-cull expansion capacity (the JAX default, 2x tri_capacity)."""
        return 2 * self.tri_capacity

    @property
    def caster_capacity(self) -> int:
        """Per-light caster expansion capacity."""
        return self.shadow_tri_capacity or self.tri_capacity

    @property
    def render_size(self) -> tuple:
        """(width, height) of the frame as rendered, before the resolve."""
        return self.width * self.ssaa, self.height * self.ssaa

    def __post_init__(self):
        if self.aa not in ("none", "edge") or self.shading not in ("pbr", "lambert"):
            raise ValueError(f"aa={self.aa!r}, shading={self.shading!r}")
        if self.shade_rate not in ("full", "checkerboard", "quarter"):
            raise ValueError(f"shade_rate={self.shade_rate!r}")
        if self.ssaa < 1:
            raise ValueError(f"ssaa={self.ssaa}")
        if self.shading != "pbr" and (self.aa != "none" or self.shade_rate != "full"):
            raise ValueError("edge AA and the shade-rate tiers need PBR shading")
        if self.rt_scale < 1 or self.shadow_slots < 0:
            raise ValueError("need rt_scale >= 1 and shadow_slots >= 0")
        band_rows = TILE_H  # a band's rows are a multiple of this
        if self.tile_raster:
            if self.tri_capacity % BLOCK or self.width % TILE_W or self.height % TILE_H:
                raise ValueError(
                    f"need tri_capacity % {BLOCK} == 0, width % {TILE_W} == 0 and "
                    f"height % {TILE_H} == 0"
                )
            if self.caster_capacity % BLOCK:
                raise ValueError(f"need shadow_tri_capacity % {BLOCK} == 0")
            # the atlas's views are raster shapes: S x S slots, (S/2, S/4)
            # cube faces and (S, S/K) bands
            if self.shadow_size % (2 * TILE_W) or self.shadow_size % (4 * TILE_H):
                raise ValueError(f"need shadow_size % {2 * TILE_W} == 0 and % {4 * TILE_H} == 0")
        else:  # what the JAX package checks without Pallas
            band_rows = 1
            if self.tri_capacity % SCAN_CAPACITY_ALIGN:
                raise ValueError(f"need tri_capacity % {SCAN_CAPACITY_ALIGN} == 0")
            rw, rh = self.render_size
            if self.shade_rate != "full" and rw % 2 or self.shade_rate == "quarter" and rh % 2:
                raise ValueError("the shade-rate tiers need an even render width (and height, "
                                 "quarter)")
        n = self.spmd_devices
        if n < 1:
            raise ValueError(f"spmd_devices={n}")
        if n > 1:  # the JAX checks, in the tile raster's units
            rw, rh = self.render_size
            if not self.tile_raster:
                raise ValueError("the split frame needs tile_raster=True, as the JAX "
                                 "package's needs use_pallas=True")
            if (rh % (n * TILE_H) or self.tri_capacity % (BLOCK * n)
                    or self.expand_capacity % n or rh // n % self.ssaa):
                raise ValueError(
                    f"spmd_devices={n} needs height * ssaa % ({n} * {TILE_H}) == 0, "
                    f"tri_capacity % ({BLOCK} * {n}) == 0 and each shard's rows a multiple "
                    "of ssaa")
        if self.shadow_progressive > 1 and not (
                self.shadow_cache and self.shadow_update_budget == 1
                and self.shadow_size % (self.shadow_progressive * band_rows) == 0):
            raise ValueError("shadow_progressive needs shadow_cache, shadow_update_budget=1 "
                             f"and shadow_size % (shadow_progressive * {band_rows}) == 0")


def initial_state(cfg: PipelineConfig, device) -> dict:
    """The persistent resources before frame 1: an empty draw list, an
    all-far visibility buffer at the render size (a shard's rows of it
    under the split frame), the identity viewproj
    and the cached atlas's state when ``cfg.shadow_cache``, as in the JAX
    package. Under the identity, occlusion culling on frame 1 culls the
    instances whose world AABB lies wholly at z > 1 against the all-far
    depth (a fault shared with the JAX package, whose resource note says
    nothing can be culled on frame 1)."""
    w, h = cfg.render_size
    h //= cfg.spmd_devices
    state = {
        "draw_list": geometry.DrawList.empty(cfg.tri_capacity, device),
        "vis": VisibilityBuffer(
            depth=torch.full((h, w), DEPTH_CLEAR, dtype=torch.float32, device=device),
            tri_id=torch.full((h, w), NO_TRIANGLE, dtype=torch.int32, device=device),
            bary=torch.zeros((3, h, w), dtype=torch.float32, device=device)),
        "prev_vp": torch.eye(4, dtype=torch.float32, device=device),
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
                       debug_aabbs: bool = False, occlusion_culling: bool = False,
                       hud: bool = False, reference_image: bool = False,
                       atlas_casts: tuple = None) -> list:
    """The ordered passes of one frame for the switch set, the JAX plan's
    passes. ``light_casts``, (shadow_slot, directional) per shaded light
    with slot -1 for none, picks the lights that shadow and that
    ``shade_rt`` traces. ``atlas_casts``, the same for every light of the
    table (None: ``light_casts``), picks the slots the atlas renders."""
    w, h = cfg.render_size
    if occlusion_culling and not freeze_culling and not debug_aabbs and (w | h) % (1 << LEVELS):
        raise ValueError(f"occlusion culling's {LEVELS}-level depth pyramid needs the render "
                         f"width and height divisible by {1 << LEVELS}")
    lambert = cfg.shading == "lambert"
    plain = not cfg.tile_raster
    n_sp = cfg.spmd_devices
    rows = h // n_sp  # the rows a shard rasterizes and shades
    if rt and n_sp > 1 and rows % cfg.rt_scale:
        raise ValueError(f"the split frame's rt needs each shard's {rows} rows a multiple of "
                         f"rt_scale {cfg.rt_scale}")

    def shard():
        """The running shard under the split frame, else None."""
        if n_sp == 1:
            return None
        s = current_shard()
        if s is None or s.axis_size() != n_sp:
            raise RuntimeError(f"a plan for spmd_devices={n_sp} runs on a mesh of as many "
                               "shards: Renderer(spmd_mesh=...)")
        return s

    def first_row(s) -> int:
        return 0 if s is None else s.axis_index() * rows

    def assemble(image):
        """The whole frame: the shards' rows gathered under the split frame."""
        s = shard()
        return image if s is None else s.all_gather(image)

    def pose(scene, time=None):
        return {"scene_view": pose_scene(scene, time) if cfg.skinning else scene}

    def prepare(scene_view, camera):
        prepared = geometry.prepare_frame_columns(scene_view, camera)
        return {"prepared": prepared, "prev_vp": prepared.vp}

    def cull_sharded(s, scene, prepared):
        """This shard's instances, local i <- global d + n i (strided, so
        one mesh's instances spread over the shards; the n_inst % n last
        are dropped, as in the JAX plan), built at 1/n of the capacities;
        local instance ids lifted to global, then one gather of the soups
        and records and a sum of the counts, and the gathered stream put in
        the single-shard cull's order."""
        d = s.axis_index()
        shard_len = scene.instances.mesh_id.shape[0] // n_sp

        def sl(x):
            return x[d: d + n_sp * shard_len: n_sp]

        inst = scene.instances
        inst = inst._replace(**{f: sl(getattr(inst, f)) for f in inst._fields if f != "count"})
        prepared = prepared._replace(model=sl(prepared.model), clip_mats=sl(prepared.clip_mats),
                                     visible=sl(prepared.visible), lod=sl(prepared.lod))
        soup, rec = geometry.build_draw_stream(
            scene._replace(instances=inst), prepared, cfg.expand_capacity // n_sp,
            cfg.tri_capacity // n_sp, w, h, cull_backface=cfg.cull_backface,
            cluster_cull=cfg.cluster_cull, want_soup_attrs=lambert,
        )
        instance = soup.instance * n_sp + d
        rec[:, geometry.SR_INSTANCE] = instance.float()
        soup, rec = s.all_gather((soup._replace(instance=instance), rec))
        order = geometry.draw_order(soup, scene.meshes.indices.shape[0])
        soup = geometry.TriangleSoup(**{f: v if v is None or f == "count" else v[order]
                                        for f, v in soup._asdict().items()})
        return soup._replace(count=s.psum(soup.count)), rec[order]

    def cull(scene_view, prepared):
        s = shard()
        if s is not None:
            soup, rec = cull_sharded(s, scene_view, prepared)
        elif plain:
            soup = geometry.expand_draw_stream(scene_view, prepared.visible, prepared.lod,
                                               prepared.clip_mats, prepared.model,
                                               cfg.tri_capacity)
            soup = compact_soup(geometry.cull_triangles(soup, cull_backface=cfg.cull_backface))
            soup = geometry.finalize_tex_lod(soup, w, h, scene_view.atlas.level_size[0])
            rec = geometry.build_shade_records(soup, scene_view)
        else:
            soup, rec = geometry.build_draw_stream(
                scene_view, prepared, cfg.expand_capacity, cfg.tri_capacity, w, h,
                cull_backface=cfg.cull_backface, cluster_cull=cfg.cluster_cull,
                want_soup_attrs=lambert,
            )
        draw_list = geometry.DrawList(soup.instance, soup.tri_idx, soup.valid, soup.count)
        return {"soup": soup, "shade_rec": rec, "draw_list": draw_list}

    def cull_occluded(scene_view, prepared, vis_prev, prev_vp_prev):
        """The coarse cull refined against frame N-1's depth pyramid, the
        instances projected with frame N-1's viewproj (ops/occlusion.py);
        under the split frame, the shards' rows of that depth gathered first."""
        visible = occlusion_cull(scene_view, prepared.model, prev_vp_prev, prepared.visible,
                                 assemble(vis_prev.depth))
        return cull(scene_view, prepared._replace(visible=visible))

    def transform_frozen(scene_view, prepared, draw_list_prev):
        """The kept draw list under the live camera: no cull, so triangles
        behind the camera or facing away reach the raster's own tests."""
        soup = geometry.soup_from_draw_list(scene_view, draw_list_prev, prepared.clip_mats,
                                            prepared.model)
        soup = geometry.finalize_tex_lod(soup, w, h, scene_view.atlas.level_size[0])
        return {"soup": soup, "shade_rec": geometry.build_shade_records(
            soup, scene_view, render_size=None if plain else (w, h))}

    def aabb(scene_view, prepared):
        return {"soup": compact_soup(aabb_soup(scene_view, prepared.visible, prepared.clip_mats,
                                               prepared.model, cfg.tri_capacity))}

    # PBR shading re-derives barycentrics from the records' edge columns,
    # so the raster kernel stores depth and id only; Lambert and the debug
    # view interpolate the soup's normals through the raster's barycentrics.
    # The plain configuration's scan raster always makes them
    def raster(soup, with_bary=lambert):
        if plain:
            return {"vis": rasterize_scan(soup.clip, soup.valid, w, h,
                                          cull_backface=cfg.cull_backface, count=soup.count)}
        return {"vis": rasterize_cuda(soup.clip, soup.valid, w, rows,
                                      cull_backface=cfg.cull_backface, with_bary=with_bary,
                                      y0=first_row(shard()), full_height=h)}

    def raster_dbg(soup):
        return raster(soup, with_bary=True)

    slots = slot_lights(light_casts if atlas_casts is None else atlas_casts, cfg.shadow_slots)
    sig_weights = {}  # the signature's fold weights per device, made at the first shadowed frame

    def shadow_pass(scene_view, prepared, shadow_cache_prev=None):
        """The shadow-map atlas: cached (the previous frame's state in,
        this frame's out) or rendered whole every frame."""
        lights = scene_view.lights
        smin, smax = prepared.scene_min, prepared.scene_max
        with span("shadow.lights"):  # the frame trace's; ops/shadow.py stamps the rest
            mats = light_matrices_cube(lights, smin, smax)
        args = (scene_view, mats, prepared.model, prepared.lod, slots, cfg.shadow_size,
                cfg.caster_capacity)
        if not cfg.shadow_cache:
            atlas = render_shadow_atlas_per_light(*args, scene_min=smin, scene_max=smax,
                                                  tile_raster=cfg.tile_raster)
            return {"shadow": ShadowMaps(atlas, mats, light_casts)}
        key = (prepared.model.shape[0], prepared.model.device)
        if key not in sig_weights:
            sig_weights[key] = signature_weights(*key)
        atlas, cache = render_shadow_atlas_cached(
            *args, prev=shadow_cache_prev, budget=cfg.shadow_update_budget,
            progressive=cfg.shadow_progressive, scene_min=smin, scene_max=smax,
            weights=sig_weights[key], tile_raster=cfg.tile_raster)
        return {"shadow": ShadowMaps(atlas, mats, light_casts), "shadow_cache": cache}

    img_res = "image_hires" if cfg.ssaa > 1 else "image_pre"

    def _shade(vis, soup, shade_rec, scene, camera, prepared, rt_grid=None, shadow_maps=None,
               rt=None):
        s = shard()
        y0 = first_row(s)
        if lambert:
            return shade_lambert(vis, soup, scene, camera.position, prepared.vp_inv,
                                 background=cfg.background, y0=y0, full_height=h)
        return shade_pbr(
            vis, shade_rec, scene, camera.position, prepared.vp_inv, y0=y0, full_height=h,
            halo=s, background=cfg.background, enable_textures=cfg.enable_textures,
            enable_normal_maps=cfg.enable_normal_maps, trilinear=cfg.trilinear,
            light_slots=cfg.shade_light_slots, aa=(cfg.aa == "edge"), rt_grid=rt_grid, rt=rt,
            shadow=shadow_maps, checkerboard=(cfg.shade_rate == "checkerboard"),
            quarter=(cfg.shade_rate == "quarter"), shade_fix=cfg.shade_fix,
            bary_from_records=not plain,
        )

    def shade(vis, soup, shade_rec, scene_view, camera, prepared):
        return {img_res: _shade(vis, soup, shade_rec, scene_view, camera, prepared)}

    def shade_shadowed(vis, soup, shade_rec, scene_view, camera, prepared, shadow):
        return {img_res: _shade(vis, soup, shade_rec, scene_view, camera, prepared,
                                shadow_maps=shadow)}

    def shade_rt(vis, soup, shade_rec, scene_view, camera, prepared):
        """Ray-traced shadows: per-light caster expansion, light-space
        binning and the occlusion walk (ops/rt_grid.py); in the plain
        configuration exact rays against the camera's culled soup
        (ops/rt.py)."""
        if plain:
            rt = RtBrute(triangles_world(soup.clip, prepared.vp_inv), soup.valid, light_casts,
                         cfg.shadow_slots, cfg.rt_scale, soup.count)
            return {img_res: _shade(vis, soup, shade_rec, scene_view, camera, prepared, rt=rt)}
        smin, smax = prepared.scene_min, prepared.scene_max
        d = smax - smin
        radius = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) * 0.5 + 1e-3
        rt_grid = RtGrid(
            directional_light_matrices(scene_view.lights, smin, smax), prepared.lod,
            prepared.model, radius, cfg.caster_capacity, light_casts, cfg.shadow_slots,
            cfg.rt_scale,
        )
        return {img_res: _shade(vis, soup, shade_rec, scene_view, camera, prepared, rt_grid)}

    def shade_debug(vis, soup):
        return {img_res: shade_flat_instance(vis, soup, background=cfg.background)}

    def resolve(image_hires):
        """The SSAA box resolve: the mean of each ssaa x ssaa block."""
        k = cfg.ssaa
        hh, ww = image_hires.shape[:2]  # a shard's rows under the split frame
        return {"image_pre": image_hires.reshape(hh // k, k, ww // k, k, 3).mean(dim=(1, 3))}

    def present(image_pre):
        return {"image": assemble(image_pre)}

    def reference_view(image_pre, soup, shade_rec, scene_view, camera, prepared):
        """The same soup through the independent scan rasterizer at 1/4 of
        the output size, shaded with its barycentrics; cells whose mean
        difference from the frame (averaged down to that grid) passes
        REFERENCE_TINT_AT are tinted magenta."""
        k = REFERENCE_SCALE
        wlo, hlo = cfg.width // k, cfg.height // k
        vis_lo = rasterize_scan(soup.clip, soup.valid, wlo, hlo, cull_backface=cfg.cull_backface,
                                count=soup.count)
        ref = shade_pbr(vis_lo, shade_rec, scene_view, camera.position, prepared.vp_inv,
                        background=cfg.background, enable_textures=cfg.enable_textures,
                        enable_normal_maps=cfg.enable_normal_maps, trilinear=cfg.trilinear,
                        bary_from_records=False)
        main = assemble(image_pre)
        mlo = main[: hlo * k, : wlo * k].reshape(hlo, k, wlo, k, 3).mean(dim=(1, 3))
        heat = (mlo - ref).abs().mean(dim=-1)
        heat_up = heat.repeat_interleave(k, 0).repeat_interleave(k, 1)
        heat_up = torch.nn.functional.pad(heat_up, (0, main.shape[1] - wlo * k,
                                                    0, main.shape[0] - hlo * k))
        tint = torch.stack([torch.full((), c, device=main.device) for c in (1.0, 0.0, 1.0)])
        return {"image": torch.where((heat_up > REFERENCE_TINT_AT)[..., None],
                                     0.35 * main + 0.65 * tint, main)}

    fonts = {}  # the font atlas per device, copied at the first HUD frame

    def overlay_pass(image_pre, overlay):
        dev = image_pre.device
        if dev not in fonts:
            fonts[dev] = host_to_device(build_font_atlas(), dev)
        return {"image": compose_overlay(assemble(image_pre), overlay or Overlay.empty(),
                                         fonts[dev])}

    geo_reads = ("scene_view", "prepared")
    culled = ("soup", "shade_rec", "draw_list")
    passes = [
        Pass("pose", ("scene", "time") if cfg.skinning else ("scene",), ("scene_view",), pose),
        Pass("prepare", ("scene_view", "camera"), ("prepared", "prev_vp"), prepare),
    ]
    if debug_aabbs:
        passes += [Pass("aabb_soup", geo_reads, ("soup",), aabb),
                   Pass("raster_dbg", ("soup",), ("vis",), raster_dbg),
                   Pass("shade_debug", ("vis", "soup"), (img_res,), shade_debug)]
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
        shade_reads = ("vis", "soup", "shade_rec", "scene_view", "camera", "prepared")
        if rt:
            passes.append(Pass("shade_rt", shade_reads, (img_res,), shade_rt))
        elif shadows:
            passes.append(Pass("shade_shadowed", shade_reads + ("shadow",), (img_res,),
                               shade_shadowed))
        else:
            passes.append(Pass("shade", shade_reads, (img_res,), shade))
    if cfg.ssaa > 1:
        passes.append(Pass("resolve", ("image_hires",), ("image_pre",), resolve))
    if hud:
        passes.append(Pass("overlay_pass", ("image_pre", "overlay"), ("image",), overlay_pass))
    elif reference_image:
        if not debug_aabbs:  # as in the JAX plan: no shade records to view
            passes.append(Pass("reference_view", ("image_pre", "soup", "shade_rec",
                                                  "scene_view", "camera", "prepared"),
                               ("image",), reference_view))
    else:
        passes.append(Pass("present", ("image_pre",), ("image",), present))
    check_plan(passes, outputs, state=state_names(cfg))
    return passes
