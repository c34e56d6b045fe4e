"""The Renderer: per-frame driver around the forward plan
(``renderer_tpu.runtime.frame``).

- ``execute_plan`` runs the plan's passes in order, each inside a
  ``torch.profiler`` range named ``forward.<pass>`` (under the frame trace,
  also a span of it).
- Runtime switches (``RuntimeConfig``: ``freeze_culling``,
  ``debug_aabbs``, ``shadows``, ``occlusion_culling``, ``rt``, ``hud``,
  ``reference_image``) with the two-frame latch: ``set_config`` edits a pending copy that the next frame
  takes up; ``apply_config_now`` takes it up at once. One plan per switch
  set, built on first use and kept.
- Light specialization, read once at construction: shading loops over the
  scene's live light count (or ``shade_light_slots``), and shadows cover
  only the shadow slots that hold a light, each with its kind
  (directional or point) fixed. Ray-traced shadows trace the shaded
  lights' slots (``light_casts``); the atlas renders the slot of every
  live light in the table (``atlas_casts``), as the JAX atlas matches its
  slots against the whole table. A scene passed to ``render`` later must
  keep both patterns.
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
- The split frame: ``Renderer(scene, cfg, spmd_mesh=mesh)`` with
  ``cfg.spmd_devices == len(mesh)`` runs the same plan on every shard of
  the mesh (``parallel.sharding.run_shards``), as the JAX Renderer runs it
  in one ``shard_map``. The scene and camera are copied to each shard's
  device; each shard keeps its own state (``shard_states``: its rows of
  ``vis``, full copies of the rest). ``state`` reads and writes the whole
  frame's, so checkpoints hold the single-shard layout. ``render``
  returns shard 0's outputs, the image gathered, with ``vis`` joined over
  the shards' rows; ``shard_outputs`` keeps each shard's.
- One program per plan, as the JAX Renderer jits one program per switch
  set and donates the state to it: on CUDA devices ``render`` replays the
  plan's captured CUDA graphs (``runtime/program.py``), one program per
  switch set and shapes of the scene and camera, captured after its first
  frame (``stats["compiles"]`` counts the captures). On one device the
  program is one graph; under ``spmd_mesh`` it is a graph per shard and
  stretch between collectives, replayed from the caller's thread with no
  shard thread. The persistent state then lives in fixed buffers (each
  shard's) that every program reads and overwrites in place: ``state``
  (``shard_states``) returns them, and assigning a state of the same
  layout copies into them. ``Renderer(..., replay=False)`` gives the eager
  frame (the counterpart of ``jax.disable_jit``), which chip_smoke and the
  tests compare against; ``replay=True`` on the CPU runs the programs'
  static buffers without a capture. The HUD's overlay pass (after the
  replays) stays eager.
- The frame trace (``utils.profiling.FrameTrace``), off by default:
  ``trace_frames(capacity)`` turns it on (0: off) and drops the programs,
  which the next frame captures again. Each frame then stamps its passes and the donation on
  the device (in the replayed graphs too, one ring per shard) and records
  the host's spans (``render.check_lights``, the program's copy-in,
  launch, copy-out and tail); ``frame_trace.read()`` returns the last
  ``capacity`` frames on the profiler's clock. Off, ``render`` tests one
  attribute, the program's host spans test one list each, and the graphs
  hold no stamp.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Optional

import torch

from renderer_tpu_torch.mathx.camera import Camera
from renderer_tpu_torch.ops.raster_cuda import VisibilityBuffer
from renderer_tpu_torch.parallel.sharding import Mesh, run_shards
from renderer_tpu_torch.passes.pipeline import PipelineConfig, build_forward_plan, initial_state
from renderer_tpu_torch.runtime.program import FrameProgram, donate, same_layout, tree_key
from renderer_tpu_torch.scene.types import Scene
from renderer_tpu_torch.utils import tree
from renderer_tpu_torch.utils.compile_cache import enable_persistent_cache
from renderer_tpu_torch.utils.profiling import FrameTrace, flush, host_span, span


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


@contextlib.contextmanager
def _traced_pass(name: str):
    """The wrap of a frame under the frame trace: the profiler range and a
    span of the trace."""
    with _record_pass(name), span(name):
        yield


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
    flush()  # the last pass's end, under the frame trace
    return {o: env[o] for o in outputs}, {k: env.get(k, v) for k, v in state.items()}


def to_device(x, device, copy: bool = False):
    """A container of tensors (``utils.tree``) with its tensors on
    ``device``; copies of them, even where they lie there, with ``copy``."""
    leaves, structure = tree.flatten(x)
    return tree.unflatten(structure, [v.to(device, copy=copy) if isinstance(v, torch.Tensor)
                                      else v for v in leaves])


class Renderer:
    def __init__(self, scene: Scene, cfg: Optional[PipelineConfig] = None,
                 outputs=("image", "vis"), device=None, spmd_mesh: Optional[Mesh] = None,
                 replay: Optional[bool] = None):
        enable_persistent_cache()
        self.cfg = cfg or PipelineConfig()
        self.spmd_mesh = spmd_mesh
        if (len(spmd_mesh) if spmd_mesh is not None else 1) != self.cfg.spmd_devices:
            raise ValueError(f"PipelineConfig.spmd_devices={self.cfg.spmd_devices} must match "
                             "the mesh's shard count (spmd_mesh)")
        scene_device = scene.lights.count.device
        # normalized ("cuda" -> "cuda:0") so it compares with tensor devices
        self.device = scene_device if device is None else torch.empty(0, device=device).device
        if spmd_mesh is not None:
            self.device = spmd_mesh.devices[0]  # where the gathered outputs live
        elif scene_device != self.device:
            raise ValueError(f"scene lives on {scene_device}, renderer on {self.device}")
        self._auto_light_slots = self.cfg.shade_light_slots is None
        if self._auto_light_slots:
            self.cfg = dataclasses.replace(
                self.cfg, shade_light_slots=int(scene.lights.count)
            )
        self.light_casts = light_casts(scene.lights, self.cfg.shade_light_slots)
        self.atlas_casts = light_casts(scene.lights, scene.lights.alive.shape[0])
        self.outputs = tuple(outputs)
        self.config = RuntimeConfig()
        self._pending_config = RuntimeConfig()
        # the plan builder (``build_forward_plan``'s signature); the kernel
        # reloader swaps it and clears the plans
        self.plan_builder = build_forward_plan
        self._plans = {}
        # one program per plan and shapes (None: replayed on a CUDA device)
        if replay is None:
            replay = self.device.type == "cuda"
        self.replay = bool(replay)
        self._programs = {}
        self._program_scene = (None, None)  # (scene, its tree_key)
        self._times = {}  # device -> the animation clock of eager frames
        self.scene = scene
        self._state = self.shard_states = self.shard_outputs = None
        if spmd_mesh is None:
            self.state = initial_state(self.cfg, self.device)
        else:
            self.shard_states = [initial_state(self.cfg, d) for d in spmd_mesh.devices]
        self.stats = {"frames": 0, "last_ms": 0.0, "compiles": 0}
        self.frame_trace = None

    def trace_frames(self, capacity: int) -> None:
        """Turn the frame trace on with a ring of ``capacity`` frames, or
        off (0), dropping the programs: the next frame captures again."""
        self.drop_plans(programs_only=True)
        self.frame_trace = None
        if capacity:
            shards = self.spmd_mesh.devices if self.spmd_mesh is not None else (self.device,)
            self.frame_trace = FrameTrace(capacity, shards)

    @property
    def state(self) -> dict:
        """The persistent resources. Replayed, the buffers the programs
        read and overwrite (a frame changes them in place). Under the split
        frame the whole frame's: ``vis`` joined over the shards' rows on
        ``device`` (a copy), the replicated entries as shard 0 holds them."""
        if self.spmd_mesh is None:
            return dict(self._state) if self.replay else self._state
        return {**self.shard_states[0], "vis": self._join_rows(
            [st["vis"] for st in self.shard_states])}

    @state.setter
    def state(self, state: dict) -> None:
        """Replayed, the state is copied into the programs' buffers (a
        state of another layout takes their place, and the programs are
        captured anew). Under the split frame, ``vis`` is cut into the
        shards' rows and every other entry copied to each shard's device."""
        if self.spmd_mesh is None:
            if self.replay and self._state is not None and same_layout(self._state, state):
                donate(self._state, state)
            else:
                self.drop_plans(programs_only=True)
                self._state = dict(state) if self.replay else state
            return
        n = len(self.spmd_mesh)
        parts = [{k: VisibilityBuffer(*(f.chunk(n, dim=-2)[i].to(d).contiguous() for f in v))
                  if k == "vis" else to_device(v, d, copy=True) for k, v in state.items()}
                 for i, d in enumerate(self.spmd_mesh.devices)]
        if self.replay and all(map(same_layout, self.shard_states, parts)):
            for buffers, part in zip(self.shard_states, parts):
                donate(buffers, part)
        else:
            self.drop_plans(programs_only=True)
            self.shard_states = parts

    def _join_rows(self, parts) -> VisibilityBuffer:
        """The shards' visibility buffers joined over rows, on ``device``."""
        return VisibilityBuffer(*(torch.cat([getattr(v, f).to(self.device) for v in parts],
                                            dim=-2) for f in VisibilityBuffer._fields))

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

    def drop_plans(self, programs_only: bool = False) -> None:
        """Forget the captured programs (their graphs hold the kernels'
        functions and the state's buffers) and, unless ``programs_only``,
        the plans (after ``plan_builder`` changed)."""
        for program in self._programs.values():
            program.close()
        self._programs.clear()
        if not programs_only:
            self._plans.clear()

    @property
    def programs(self) -> dict:
        """The frame programs made so far, by (switch set, shapes)."""
        return dict(self._programs)

    @property
    def passes(self) -> list:
        """The plan of the active switch set, built on first use."""
        key = tuple(sorted(vars(self.config).items()))
        if key not in self._plans:
            self._plans[key] = self.plan_builder(self.cfg, self.outputs, self.light_casts,
                                                 atlas_casts=self.atlas_casts,
                                                 **vars(self.config))
        return self._plans[key]

    def _external(self, camera: Camera, time_s: float = 0.0, overlay=None, device=None) -> dict:
        device = device or self.device
        camera = Camera(*(t.to(device) for t in camera))
        t = None
        if self.cfg.skinning:  # a fill of a kept scalar: no tensor made of a host float
            t = self._times.get(device)
            if t is None:
                t = self._times[device] = torch.empty((), dtype=torch.float32, device=device)
            t.fill_(float(time_s))
        scene = self.scene if self.scene.lights.count.device == device else self._scene_on(device)
        return {"scene": scene, "camera": camera, "time": t, "overlay": overlay}

    def _scene_on(self, device):
        """The scene copied to a shard's device, once per scene object."""
        copies = getattr(self, "_scene_copies", None)
        if copies is None or copies[0] is not self.scene:
            copies = self._scene_copies = (self.scene, {})
        if device not in copies[1]:
            copies[1][device] = to_device(self.scene, device)
        return copies[1][device]

    def _run(self, commit=True, **frame) -> dict:
        """One frame of the active plan, on one device or split over the
        mesh; with ``commit`` its state becomes the renderer's (without, an
        eager frame)."""
        passes = self.passes
        trace = self.frame_trace
        if self.replay and commit:
            outs = self._program(passes, frame["camera"]).run(self.scene, **frame)
            if self.spmd_mesh is None:
                return outs[0]
        else:
            kw = {}
            if trace is not None:
                trace.fill(trace.cards)
                kw["wrap"] = _traced_pass
            if self.spmd_mesh is None:
                outputs, state = execute_plan(passes, self.outputs, self.state,
                                              **kw, **self._external(**frame))
                if commit:
                    self.state = state
                return outputs
            ext = [self._external(**frame, device=d) for d in self.spmd_mesh.devices]
            results = run_shards(self.spmd_mesh, lambda s: execute_plan(
                passes, self.outputs, self.shard_states[s.index], **kw, **ext[s.index]))
            if not commit:
                return results[0][0]
            outs = [out for out, _ in results]
            self.shard_states = [state for _, state in results]
        self.shard_outputs = outs
        outputs = dict(outs[0])
        if "vis" in outputs:
            outputs["vis"] = self._join_rows([o["vis"] for o in self.shard_outputs])
        return outputs

    def _program(self, passes, camera) -> FrameProgram:
        """The program of the active switch set for the scene's and the
        camera's shapes, made on first use; a capture counts as a compile."""
        scene, key = self._program_scene
        if scene is not self.scene:
            key = tree_key(self.scene)
            self._program_scene = (self.scene, key)
        key = (tuple(sorted(vars(self.config).items())), key, tree_key(camera))
        program = self._programs.get(key)
        if program is None:
            where, state = ((self.device, self._state) if self.spmd_mesh is None
                            else (self.spmd_mesh, self.shard_states))
            trace = self.frame_trace
            execute = execute_plan if trace is None else functools.partial(execute_plan,
                                                                           wrap=_traced_pass)
            program = self._programs[key] = FrameProgram(
                passes, self.outputs, state, self.scene, camera, where, self.cfg.skinning,
                execute, trace)
        if not program.graphs and self.device.type == "cuda":
            self.stats["compiles"] += 1  # this frame captures it
        return program

    def render(self, camera: Camera, scene: Optional[Scene] = None, time_s: float = 0.0,
               overlay=None) -> dict:
        """Render one frame; returns the outputs dict (device tensors). The
        work is queued on the current stream, not waited for. ``time_s``
        drives the skins' clips (``PipelineConfig.skinning``); ``overlay``
        (``ops.overlay.Overlay``, host tables) is what the ``hud`` switch
        blends in (None: nothing)."""
        trace = self.frame_trace
        if trace is not None:
            trace.next_frame()
            with trace.active():
                return self._render(camera, scene, time_s, overlay)
        return self._render(camera, scene, time_s, overlay)

    def _render(self, camera, scene, time_s, overlay) -> dict:
        if scene is not None:
            if scene.lights is not self.scene.lights:
                with host_span("render.check_lights"):
                    self._check_light_contract(scene)
            self.scene = scene
        t0 = time.perf_counter()
        outputs = self._run(camera=camera, time_s=time_s, overlay=overlay)
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
        for mine, k in ((self.light_casts, self.cfg.shade_light_slots),
                        (self.atlas_casts, scene.lights.alive.shape[0])):
            pattern = light_casts(scene.lights, k)
            if pattern != mine:
                raise ValueError(
                    f"scene changes the light cast pattern {mine} -> "
                    f"{pattern}; construct a new Renderer for it"
                )
