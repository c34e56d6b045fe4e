"""The Renderer: per-frame driver around the forward plan
(``renderer_tpu.runtime.frame``).

- ``execute_plan`` runs the plan's passes in order, each inside a
  ``torch.profiler`` range named ``forward.<pass>``.
- Runtime switches (``RuntimeConfig``: ``freeze_culling``,
  ``debug_aabbs``, ``shadows``, ``occlusion_culling``, ``rt``, ``hud``,
  ``reference_image``) with the two-frame latch: ``set_config`` edits a pending copy that the next frame
  takes up; ``apply_config_now`` takes it up at once. One plan per switch
  set, built on first use and kept.
- Light specialization, read once at construction: shading loops over the
  scene's live light count, and shadows (maps or rays) cover only the
  shadow slots that hold a light, each with its kind (directional or
  point) fixed. A scene passed to ``render`` later must keep both.
- Persistent state (``Renderer.state``): the last cull's draw list
  (``draw_list``, which freeze culling keeps), the last visibility buffer
  and viewproj (``vis``, ``prev_vp``, which occlusion culling reads) and
  the cached shadow atlas (``shadow_cache``). A frame reads them as the
  previous frame left them; what it writes of them is the next state, the
  rest is kept.
- Per-frame externals besides the scene and camera: the animation clock
  ``time_s`` (under ``PipelineConfig.skinning``, a device fill, not a host
  copy) and the 2D ``overlay`` tables the ``hud`` switch blends in.
- Construction fixes the build directory of the kernels
  (``utils.compile_cache.enable_persistent_cache``), as the JAX Renderer
  enables its compilation cache.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from renderer_tpu_torch.mathx.camera import Camera
from renderer_tpu_torch.passes.pipeline import PipelineConfig, build_forward_plan, initial_state
from renderer_tpu_torch.scene.types import Scene
from renderer_tpu_torch.utils.compile_cache import enable_persistent_cache


@dataclasses.dataclass
class RuntimeConfig:
    """Runtime switches: ``freeze_culling`` renders the draw list of the
    last culled frame under the live camera; ``debug_aabbs`` draws the
    visible instances' boxes instead of their meshes; ``shadows`` renders
    and looks up the shadow-map atlas; ``occlusion_culling`` culls against
    the previous frame's depth; ``rt`` traces shadows through the
    light-space grid instead of the atlas; ``hud`` blends the overlay
    tables into the frame; ``reference_image`` tints where the frame
    differs from the same soup through the independent scan rasterizer."""

    freeze_culling: bool = False
    debug_aabbs: bool = False
    shadows: bool = False
    occlusion_culling: bool = False
    rt: bool = False
    hud: bool = False
    reference_image: bool = False


def light_casts(lights, k: int) -> tuple:
    """(shadow_slot, directional) of the first k lights, slot -1 for a dead
    light: read on the host."""
    slots = lights.shadow_slot[:k].tolist()
    dirs = lights.directional[:k].tolist()
    alive = lights.alive[:k].tolist()
    return tuple((int(s) if a else -1, bool(d)) for s, d, a in zip(slots, dirs, alive))


def _record_pass(name: str):
    return torch.profiler.record_function(f"forward.{name}")


def execute_plan(passes, outputs, state: dict, wrap=_record_pass, **external):
    """Run the passes in order. Returns (the named outputs, the new state):
    a pass reads ``state`` (the previous frame's persistent resources) for
    its ``reads_prev``, and what it writes of them is the new state.
    ``wrap(name)`` gives the context each pass runs in (a profiler range by
    default)."""
    env = dict(external)
    for p in passes:
        args = {r: env[r] for r in p.reads}
        args.update({f"{r}_prev": state[r] for r in p.reads_prev})
        with wrap(p.name):
            result = p.fn(**args)
        if set(result) != set(p.writes):
            raise RuntimeError(f"pass {p.name!r} returned {sorted(result)}, claims {sorted(p.writes)}")
        env.update(result)
    return {o: env[o] for o in outputs}, {k: env.get(k, v) for k, v in state.items()}


class Renderer:
    def __init__(self, scene: Scene, cfg: Optional[PipelineConfig] = None,
                 outputs=("image", "vis"), device=None):
        enable_persistent_cache()
        scene_device = scene.lights.count.device
        # normalized ("cuda" -> "cuda:0") so it compares with tensor devices
        self.device = scene_device if device is None else torch.empty(0, device=device).device
        if scene_device != self.device:
            raise ValueError(f"scene lives on {scene_device}, renderer on {self.device}")
        self.cfg = cfg or PipelineConfig()
        self._auto_light_slots = self.cfg.shade_light_slots is None
        if self._auto_light_slots:
            self.cfg = dataclasses.replace(
                self.cfg, shade_light_slots=int(scene.lights.count)
            )
        self.light_casts = light_casts(scene.lights, self.cfg.shade_light_slots)
        self.outputs = tuple(outputs)
        self.config = RuntimeConfig()
        self._pending_config = RuntimeConfig()
        # the plan builder (``build_forward_plan``'s signature); the kernel
        # reloader swaps it and clears the plans
        self.plan_builder = build_forward_plan
        self._plans = {}
        self.scene = scene
        self.state = initial_state(self.cfg, self.device)
        self.stats = {"frames": 0, "last_ms": 0.0}

    # -- switches (two-frame latch) -----------------------------------------
    def set_config(self, **switches) -> None:
        """Edit runtime switches; the edit takes effect on the next frame."""
        for k, v in switches.items():
            if not hasattr(self._pending_config, k):
                raise AttributeError(f"unknown runtime switch {k!r}")
            setattr(self._pending_config, k, bool(v))

    def apply_config_now(self) -> None:
        """Take up the pending switches at once (a copy, so later edits stay
        pending)."""
        self.config = dataclasses.replace(self._pending_config)

    @property
    def passes(self) -> list:
        """The plan of the active switch set, built on first use."""
        key = tuple(sorted(vars(self.config).items()))
        if key not in self._plans:
            self._plans[key] = self.plan_builder(self.cfg, self.outputs, self.light_casts,
                                                 **vars(self.config))
        return self._plans[key]

    def _external(self, camera: Camera, time_s: float = 0.0, overlay=None) -> dict:
        camera = Camera(*(t.to(self.device) for t in camera))
        t = (torch.full((), float(time_s), dtype=torch.float32, device=self.device)
             if self.cfg.skinning else None)
        return {"scene": self.scene, "camera": camera, "time": t, "overlay": overlay}

    def render(self, camera: Camera, scene: Optional[Scene] = None, time_s: float = 0.0,
               overlay=None) -> dict:
        """Render one frame; returns the outputs dict (device tensors). The
        work is queued on the current stream, not waited for. ``time_s``
        drives the skins' clips (``PipelineConfig.skinning``); ``overlay``
        (``ops.overlay.Overlay``, host tables) is what the ``hud`` switch
        blends in (None: nothing)."""
        if scene is not None:
            if scene.lights is not self.scene.lights:
                self._check_light_contract(scene)
            self.scene = scene
        t0 = time.perf_counter()
        outputs, self.state = execute_plan(self.passes, self.outputs, self.state,
                                           **self._external(camera, time_s, overlay))
        self.stats["last_ms"] = (time.perf_counter() - t0) * 1e3
        self.stats["frames"] += 1
        if self.config != self._pending_config:  # the latch: next frame's switches
            self.config = dataclasses.replace(self._pending_config)
        return outputs

    def _check_light_contract(self, scene: Scene) -> None:
        """Shading loops over the construction scene's live light count and
        traces the shadow slots of its light-cast pattern; a scene override
        with more live lights, or with lights moved between slots or kinds,
        would be shaded wrong."""
        count = int(scene.lights.count)
        if self._auto_light_slots and count > self.cfg.shade_light_slots:
            raise ValueError(
                f"scene has {count} live lights but the Renderer shades "
                f"{self.cfg.shade_light_slots} (shade_light_slots); construct a "
                "new Renderer or pass shade_light_slots explicitly"
            )
        pattern = light_casts(scene.lights, self.cfg.shade_light_slots)
        if pattern != self.light_casts:
            raise ValueError(
                f"scene changes the light cast pattern {self.light_casts} -> "
                f"{pattern}; construct a new Renderer for it"
            )

    def pass_timings(self, camera: Camera, iters: int = 5, time_s: float = 0.0,
                     overlay=None) -> dict:
        """Mean device milliseconds of each pass, from CUDA events around
        the pass over ``iters`` runs (not counted as frames; the state is
        not advanced)."""
        if self.device.type != "cuda":
            raise RuntimeError("pass timings need a CUDA device")
        pairs: dict[str, list] = {}

        @contextlib.contextmanager
        def timed(name):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with _record_pass(name):
                yield
            end.record()
            pairs.setdefault(name, []).append((start, end))

        for _ in range(iters):
            execute_plan(self.passes, self.outputs, self.state, wrap=timed,
                         **self._external(camera, time_s, overlay))
        torch.cuda.synchronize(self.device)
        return {n: sum(s.elapsed_time(e) for s, e in v) / len(v) for n, v in pairs.items()}
