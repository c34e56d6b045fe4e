"""The forward frame (``renderer_tpu.passes.pipeline``) as an ordered plan of
passes, each declaring the resources it reads and writes.

Ported passes, in plan order: pose (identity: no skinning yet) -> prepare
-> cull -> raster -> shade -> present. The JAX package compiles a plan per
set of runtime switches (freeze, occlusion culling, shadows, rt, HUD, ...);
none of the passes those switches select is ported yet, so the port has
this one plan, and each later pass brings its switch with it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.ops.pbr import shade_pbr
from renderer_tpu_torch.ops.raster_cuda import BLOCK, TILE_H, TILE_W, rasterize_cuda

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

    @property
    def expand_capacity(self) -> int:
        """Pre-cull expansion capacity (the JAX default, 2x tri_capacity)."""
        return 2 * self.tri_capacity

    def __post_init__(self):
        if self.aa not in ("none", "edge"):
            raise ValueError(f"aa={self.aa!r}")
        if self.tri_capacity % BLOCK or self.width % TILE_W or self.height % TILE_H:
            raise ValueError(
                f"need tri_capacity % {BLOCK} == 0, width % {TILE_W} == 0 and "
                f"height % {TILE_H} == 0"
            )


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


def build_forward_plan(cfg: PipelineConfig, outputs=("image",)) -> list:
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

    def shade(vis, shade_rec, scene_view, camera, prepared):
        return {"image_pre": shade_pbr(
            vis, shade_rec, scene_view, camera.position, prepared.vp_inv,
            background=cfg.background, enable_textures=cfg.enable_textures,
            enable_normal_maps=cfg.enable_normal_maps, trilinear=cfg.trilinear,
            light_slots=cfg.shade_light_slots, aa=(cfg.aa == "edge"),
        )}

    def present(image_pre):
        return {"image": image_pre}

    passes = [
        Pass("pose", ("scene",), ("scene_view",), pose),
        Pass("prepare", ("scene_view", "camera"), ("prepared",), prepare),
        Pass("cull", ("scene_view", "prepared"), ("soup", "shade_rec"), cull),
        Pass("raster", ("soup",), ("vis",), raster),
        Pass("shade", ("vis", "shade_rec", "scene_view", "camera", "prepared"),
             ("image_pre",), shade),
        Pass("present", ("image_pre",), ("image",), present),
    ]
    check_plan(passes, outputs)
    return passes
