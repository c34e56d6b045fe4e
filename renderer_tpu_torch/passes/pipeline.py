"""The forward frame (``renderer_tpu.passes.pipeline``) as an ordered plan of
passes, each declaring the resources it reads and writes.

Ported passes, in plan order: pose (identity: no skinning yet) -> prepare
-> cull -> raster -> shade (or shade_rt) -> present. The JAX package builds
a plan per set of runtime switches (freeze, occlusion culling, shadows,
rt, HUD, ...); the port has the switches whose passes are ported, so far
``rt``, which swaps ``shade`` for ``shade_rt`` (ray-traced shadows). Each
later pass brings its switch with it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.ops.pbr import shade_pbr
from renderer_tpu_torch.ops.raster_cuda import BLOCK, TILE_H, TILE_W, rasterize_cuda
from renderer_tpu_torch.ops.rt_grid import RtGrid
from renderer_tpu_torch.ops.shadow import directional_light_matrices

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
    # per-light caster expansion capacity (0: tri_capacity); casters are
    # culled against each light's frustum, not the camera's
    shadow_tri_capacity: int = 0

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
        if self.tri_capacity % BLOCK or self.width % TILE_W or self.height % TILE_H:
            raise ValueError(
                f"need tri_capacity % {BLOCK} == 0, width % {TILE_W} == 0 and "
                f"height % {TILE_H} == 0"
            )
        if self.caster_capacity % BLOCK or self.rt_scale < 1 or self.shadow_slots < 0:
            raise ValueError(f"need shadow_tri_capacity % {BLOCK} == 0, rt_scale >= 1 "
                             "and shadow_slots >= 0")


class Pass(NamedTuple):
    name: str
    reads: tuple
    writes: tuple
    fn: Callable  # fn(**{read: value}) -> {write: value}


def check_plan(passes, outputs) -> None:
    """Raise ValueError unless every pass reads only external resources or
    what an earlier pass writes, and every output is written."""
    have = set(EXTERNAL)
    for p in passes:
        missing = [r for r in p.reads if r not in have]
        if missing:
            raise ValueError(f"pass {p.name!r} reads {missing}, which no earlier pass writes")
        have.update(p.writes)
    missing = [o for o in outputs if o not in have]
    if missing:
        raise ValueError(f"outputs {missing} are written by no pass")


def build_forward_plan(cfg: PipelineConfig, outputs=("image",), light_casts: tuple = (),
                       rt: bool = False) -> list:
    """The ordered passes of one frame for the switch set (``rt``).
    ``light_casts``, (shadow_slot, directional) per shaded light with slot
    -1 for none, picks the lights that ``shade_rt`` traces."""
    w, h = cfg.width, cfg.height

    def pose(scene):
        return {"scene_view": scene}

    def prepare(scene_view, camera):
        return {"prepared": geometry.prepare_frame_columns(scene_view, camera)}

    def cull(scene_view, prepared):
        soup, rec = geometry.build_draw_stream(
            scene_view, prepared, cfg.expand_capacity, cfg.tri_capacity, w, h,
            cull_backface=cfg.cull_backface,
        )
        return {"soup": soup, "shade_rec": rec}

    # PBR shading re-derives barycentrics from the records' edge columns,
    # so the raster kernel stores depth and id only
    def raster(soup):
        return {"vis": rasterize_cuda(soup.clip, soup.valid, w, h,
                                      cull_backface=cfg.cull_backface, with_bary=False)}

    def _shade(vis, shade_rec, scene, camera, prepared, rt_grid=None):
        return shade_pbr(
            vis, shade_rec, scene, camera.position, prepared.vp_inv,
            background=cfg.background, enable_textures=cfg.enable_textures,
            enable_normal_maps=cfg.enable_normal_maps, trilinear=cfg.trilinear,
            light_slots=cfg.shade_light_slots, aa=(cfg.aa == "edge"), rt_grid=rt_grid,
        )

    def shade(vis, shade_rec, scene_view, camera, prepared):
        return {"image_pre": _shade(vis, shade_rec, scene_view, camera, prepared)}

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

    def present(image_pre):
        return {"image": image_pre}

    shade_reads = ("vis", "shade_rec", "scene_view", "camera", "prepared")
    passes = [
        Pass("pose", ("scene",), ("scene_view",), pose),
        Pass("prepare", ("scene_view", "camera"), ("prepared",), prepare),
        Pass("cull", ("scene_view", "prepared"), ("soup", "shade_rec"), cull),
        Pass("raster", ("soup",), ("vis",), raster),
        Pass("shade_rt", shade_reads, ("image_pre",), shade_rt) if rt
        else Pass("shade", shade_reads, ("image_pre",), shade),
        Pass("present", ("image_pre",), ("image",), present),
    ]
    check_plan(passes, outputs)
    return passes
