"""The reference frame: what the port's replayed ``Renderer.render`` should
produce for one frame of a cell's traffic, recomputed in plain PyTorch from
the inputs the benchmark made (the scene's tables, the frame's camera pose,
the instance translations and light directions of each frame).

One frame is the plan the cells run (``PipelineConfig`` with the shadows
switch on and the cached, progressive atlas): prepare, cull (expansion,
per-triangle cull, Morton sort, shade records), raster (``raster.py``),
the shadow atlas, PBR shading at the configured shade rate, edge AA.

The atlas is a cache: a band unit (slot, band) holds the depth rendered the
last frame the schedule served it, and the schedule serves at most one
dirty unit a frame, round robin. ``AtlasSchedule`` follows that contract
from the renderer's first frame: a unit is dirty while its light's face
matrices, the set of instances its band frustum sees or the model matrix
of one of them differ from those of the frame it was last served (or it
was never served). It is computed from the scene alone, never from the
program's signatures or state. A unit's band is then rendered with the
scene of its last-served frame.

``precision="bfloat16"`` is the control: the same frame with its geometry
in bfloat16, the precision below the float32 the configurations state: the
camera's and each band's per-instance clip matrices and the clip-space
corners made with them (so the cull, the raster and the atlas) rounded to
bfloat16, and the shaded colours too.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from benchmark.reference import geometry, pbr, raster, shadow
from benchmark.reference.camera import Camera


class Visibility(NamedTuple):
    depth: torch.Tensor
    tri_id: torch.Tensor
    bary: torch.Tensor = None


def light_casts(lights, k: int) -> tuple:
    """(shadow_slot, directional) of the first k lights, slot -1 for a dead
    light."""
    slots = lights.shadow_slot[:k].tolist()
    dirs = lights.directional[:k].tolist()
    alive = lights.alive[:k].tolist()
    return tuple((int(s) if a else -1, bool(d)) for s, d, a in zip(slots, dirs, alive))


def slot_lights(casts: tuple, n_slots: int) -> tuple:
    """Per slot, (light index, directional) of the first light in it, or None."""
    out = []
    for slot in range(n_slots):
        hit = [(li, d) for li, (s, d) in enumerate(casts) if s == slot]
        out.append(hit[0] if hit else None)
    return tuple(out)


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if precision == "bfloat16" else x


class Frames:
    """The cell's frames as the reference sees them: ``scene_at(f)`` the scene
    of frame f (its instance and light tables as the benchmark set them),
    ``pose_at(f)`` the camera's 11 floats (position, rotation, fov_y,
    aspect, near, far), ``cfg`` the configuration's pipeline settings."""

    def __init__(self, scene_at: Callable, pose_at: Callable, cfg: dict, device,
                 scene_key: Callable = None):
        self.scene_at, self.pose_at, self.cfg, self.device = scene_at, pose_at, cfg, device
        # scene_key(f): equal for two frames whose scenes are equal (None: never)
        self.scene_key = scene_key or (lambda f: None)
        self._prepared = {}

    def camera(self, f: int) -> Camera:
        p = torch.as_tensor(self.pose_at(f), dtype=torch.float32).to(self.device)
        return Camera(position=p[0:3], rotation=p[3:7], fov_y=p[7], aspect=p[8], near=p[9],
                      far=p[10])

    def prepared(self, f: int):
        if f not in self._prepared:
            if len(self._prepared) > 64:
                self._prepared.clear()
            self._prepared[f] = geometry.prepare_frame_columns(self.scene_at(f), self.camera(f))
        return self._prepared[f]


class AtlasSchedule:
    """Which frame last served each (slot, band) unit, frame by frame."""

    def __init__(self, frames: Frames, n_slots: int, bands: int):
        self.frames, self.n_slots, self.bands = frames, n_slots, bands
        scene = frames.scene_at(None)
        self.slots = slot_lights(light_casts(scene.lights, scene.lights.alive.shape[0]), n_slots)
        for s in self.slots:
            if s is not None and not s[1]:
                raise ValueError("the reference atlas covers directional slots only")
        dev = frames.device
        n_units, n_inst = n_slots * bands, scene.instances.translation.shape[0]
        self.last = torch.full((n_units,), -(1 << 40), dtype=torch.int64, device=dev)
        self.served = torch.zeros((n_units,), dtype=torch.bool, device=dev)
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        live = [i for i, s in enumerate(self.slots) if s is not None]
        self.live_units = torch.tensor([s * bands + b for s in live for b in range(bands)],
                                       dtype=torch.int64, device=dev)
        self.live_lights = [self.slots[s][0] for s in live]
        n_live = len(self.live_units)
        self.mats_last = torch.zeros((n_live, 96), device=dev)
        self.vis_last = torch.zeros((n_live, n_inst), dtype=torch.bool, device=dev)
        self.model_last = torch.zeros((n_live, n_inst, 16), device=dev)
        self._content = {}  # scene key -> the units' content under that scene
        self._settled = None  # the scene key under which the last frame found no dirty unit

    def _units(self, f: int):
        """(light matrices, visible instances, model matrices) of every live
        unit under frame f's scene; made once per scene key (the traffic's
        tables repeat, so a window revisits each key)."""
        key = self.frames.scene_key(f)
        if key is not None and key in self._content:
            return self._content[key]
        dev = self.frames.device
        scene = self.frames.scene_at(f)
        prep = self.frames.prepared(f)
        mats = shadow.light_matrices_cube(scene.lights, prep.scene_min, prep.scene_max)
        lm = mats[self.live_lights]  # (live slots, 6, 4, 4)
        bands = torch.arange(self.bands, device=dev)
        bm = torch.stack([shadow.band_matrix(m[0], bands, self.bands) for m in lm])
        vis = geometry.coarse_cull(scene, prep.model, bm).reshape(-1, prep.model.shape[0])
        content = (lm.reshape(-1, 96).repeat_interleave(self.bands, dim=0), vis, prep.model)
        if key is not None:
            self._content[key] = content
        return content

    def step(self, f: int) -> None:
        """Frame f's choice: the first dirty unit from the cursor, round robin."""
        key = self.frames.scene_key(f)
        if key is not None and key == self._settled:
            return  # the same scene as a frame that found every unit clean
        dev = self.frames.device
        n_units = self.n_slots * self.bands
        dirty = ~self.served
        if len(self.live_units):
            mats_u, vis, model = self._units(f)
            moved = (vis & (model[None] != self.model_last).any(-1)).any(-1)
            changed = ((mats_u != self.mats_last).any(-1) | (vis != self.vis_last).any(-1) | moved)
            dirty = dirty.index_put((self.live_units,), dirty[self.live_units] | changed)
        order = torch.remainder(torch.arange(n_units, device=dev) - self.cursor, n_units)
        pri = torch.where(dirty, order, n_units + 1)
        pick = torch.argmin(pri)
        any_dirty = pri[pick] <= n_units
        if key is not None and not bool(any_dirty):
            self._settled = key
            return
        sel = (torch.arange(n_units, device=dev) == pick) & any_dirty
        self.served = self.served | sel
        self.last = torch.where(sel, f, self.last)
        self.cursor = torch.where(any_dirty, torch.remainder(pick + 1, n_units), self.cursor)
        if len(self.live_units):
            sl = sel[self.live_units]
            self.mats_last = torch.where(sl[:, None], mats_u, self.mats_last)
            self.vis_last = torch.where(sl[:, None], vis, self.vis_last)
            self.model_last = torch.where(sl[:, None, None], model[None], self.model_last)

    def last_served(self) -> list:
        """Per unit, the frame that last served it (None: never)."""
        return [int(v) if s else None for v, s in zip(self.last.tolist(), self.served.tolist())]


class ReferenceRenderer:
    """Frames, atlases and draw lists of one cell, by the reference."""

    def __init__(self, frames: Frames, precision: str = "float32"):
        self.frames, self.precision = frames, precision
        c = frames.cfg
        self.n_slots, self.size, self.bands = c["shadow_slots"], c["shadow_size"], c["shadow_progressive"]
        self.caster_capacity = c.get("shadow_tri_capacity") or c["tri_capacity"]
        self._bands = {}

    def band_depth(self, slot: int, band: int, f: int, li: int) -> torch.Tensor:
        """(S / K, S) depth of band ``band`` of directional slot ``slot``
        (light ``li``) under frame f's scene."""
        key = (slot, band, f)
        if key in self._bands:
            return self._bands[key]
        fr = self.frames
        scene, prep = fr.scene_at(f), fr.prepared(f)
        s, k = self.size, self.bands
        mats = shadow.light_matrices_cube(scene.lights, prep.scene_min, prep.scene_max)
        center, radius = shadow._scene_sphere(prep.scene_min, prep.scene_max)
        pos = scene.lights.position[li]
        eye = center - pos / torch.clamp(shadow._norm3(pos), min=1e-8) * (radius * 2.0)
        lod_pick = shadow.lod_by_distance(scene, prep.model, eye, bias=shadow.shadow_lod_bias(s))
        m = shadow.band_matrix(mats[li, 0], torch.tensor(band, device=fr.device), k)
        visible = geometry.coarse_cull(scene, prep.model, m)
        clip, valid, _ = geometry.expand_clip_only(
            scene, visible, lod_pick, _round(geometry.clip_rows(m, prep.model), self.precision),
            self.caster_capacity)
        depth = raster.rasterize(_round(clip, self.precision), valid, s, s // k,
                                 cull_backface=False).depth
        self._bands[key] = depth
        return depth

    def atlas(self, last: list, slots: tuple, only=None) -> torch.Tensor:
        """(n_slots, S, S) atlas from each unit's last-served frame; slots not
        in ``only`` (when given) are left at 1.0."""
        s, k = self.size, self.bands
        out = torch.ones((self.n_slots, s, s), dtype=torch.float32, device=self.frames.device)
        for slot, light in enumerate(slots):
            if light is None or (only is not None and slot not in only):
                continue
            for band in range(k):
                f = last[slot * k + band]
                if f is not None:
                    out[slot, band * (s // k):(band + 1) * (s // k)] = self.band_depth(
                        slot, band, f, light[0])
        return out

    def frame(self, f: int, last: list, slots: tuple) -> dict:
        """Frame f: its draw list, visibility and image, the atlas's units at
        their last-served frames ``last``."""
        fr, c = self.frames, self.frames.cfg
        scene, cam, prep = fr.scene_at(f), fr.camera(f), fr.prepared(f)
        prep = prep._replace(clip_mats=_round(prep.clip_mats, self.precision))
        w, h = c["width"], c["height"]
        soup, rec = geometry.build_draw_stream(scene, prep, 2 * c["tri_capacity"],
                                               c["tri_capacity"], w, h, cull_backface=True)
        vis = raster.rasterize(_round(soup.clip, self.precision), soup.valid, w, h,
                               cull_backface=True)
        k_lights = c.get("shade_light_slots") or int(scene.lights.count)
        casts = light_casts(scene.lights, k_lights)
        shaded = {s for s, _ in casts if s >= 0}
        atlas = self.atlas(last, slots, only=shaded)
        mats = shadow.light_matrices_cube(scene.lights, prep.scene_min, prep.scene_max)
        image = pbr.shade_pbr(
            Visibility(vis.depth, vis.tri_id), rec, scene, cam.position, prep.vp_inv,
            background=tuple(c.get("background", (0.05, 0.05, 0.08))),
            enable_textures=c.get("enable_textures", True),
            enable_normal_maps=c["enable_normal_maps"], trilinear=c["trilinear"],
            light_slots=k_lights, aa=c["aa"] == "edge",
            shadow=shadow.ShadowMaps(atlas, mats, casts),
            checkerboard=c["shade_rate"] == "checkerboard", quarter=c["shade_rate"] == "quarter",
            shade_fix=c.get("shade_fix", True), bary_from_records=True)
        draw = (soup.instance, soup.tri_idx, soup.valid, soup.count)
        return {"image": _round(image, self.precision), "depth": vis.depth,
                "tri_id": vis.tri_id, "draw_list": draw}


def outputs(frames: Frames, first: int, last: int, ks, precision: str = "float32") -> tuple:
    """The reference's frames ``ks`` ({k: draw list, depth, triangle ids,
    image}) and its whole atlas at frame ``last``, the atlas schedule
    followed from the renderer's first frame ``first``."""
    c = frames.cfg
    sched = AtlasSchedule(frames, c["shadow_slots"], c["shadow_progressive"])
    lasts = {}
    for f in range(first, last + 1):
        sched.step(f)
        if f in ks or f == last:
            lasts[f] = sched.last_served()
    ref = ReferenceRenderer(frames, precision)
    out = {k: ref.frame(k, lasts[k], sched.slots) for k in sorted(ks)}
    return out, ref.atlas(lasts[last], sched.slots)
