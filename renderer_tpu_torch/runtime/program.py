"""One frame of a plan as one CUDA graph replay: the counterpart of the JAX
Renderer's jitted program per plan (``renderer_tpu.runtime.frame._jit_for``,
``graph.core.CompiledPlan.execute``: every pass in one XLA program, the
persistent state donated to it).

A ``FrameProgram`` is made per switch set and per shapes of the frame's
scene and camera (``tree_key``). It holds:

- static copies of the externals the graph reads: the scene's and the
  camera's tensors (``StaticTree``: before each run only the leaves that
  changed are copied in, a leaf being another tensor or the same one
  written since, by its version counter) and the animation clock, a ()
  tensor filled before a run whose ``time_s`` differs;
- the Renderer's persistent state, whose buffers the graph reads as the
  previous frame left them and, after the last pass, overwrites with the
  new state in stream order (``donate``): they stay the same tensors;
- on a CUDA device, a ``torch.cuda.CUDAGraph`` of ``execute_plan`` over
  those buffers.

The first run of a program on the card is its warm-up: the frame runs
eagerly on the program's side stream (every kernel of the plan built,
loaded and launched once, lazy initialisations done, as
``torch.cuda.graphs`` prescribes) and is the frame returned; the graph is
captured after it. Every later run is a replay. The named outputs are
copied out of the graph's pool after each run, so a frame already returned
is never overwritten. On the CPU nothing is captured: every run executes
the plan over the same static buffers.

What runs outside the graph is named here: the passes of ``EAGER_TAIL``
(``overlay_pass`` loops on the host over the overlay's glyph layers and
copies them pinned) run eagerly after the replay, over its outputs.

Kernel launches: a replay calls no wrapper, so the program records each
kernel's launches during the capture and adds them at every replay
(``CudaKernel.count``); those inside conditional nodes count through the
bodies' tallies on the device (``ops/control.py``).
"""

from __future__ import annotations

import time

import torch

from renderer_tpu_torch.ops import control, cuda_build
from renderer_tpu_torch.passes.pipeline import EXTERNAL
from renderer_tpu_torch.utils import tree

EAGER_TAIL = ("overlay_pass",)


def tree_key(source) -> tuple:
    """What a program is specialised to besides the switch set, for the
    scene and for the camera: the structure, shapes and dtypes of the
    tree's tensors."""
    leaves, structure = tree.flatten(source)
    return repr(structure), tuple((tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                                  else v for v in leaves)


class StaticTree:
    """Copies of a tree's tensors on ``device`` (``value``), refreshed from
    a tree of the same structure by ``update``."""

    def __init__(self, source, device):
        leaves, self.structure = tree.flatten(source)
        self.leaves = [v.to(device, copy=True) if isinstance(v, torch.Tensor) else v
                       for v in leaves]
        self.value = tree.unflatten(self.structure, self.leaves)
        self._seen = [(v, v._version) if isinstance(v, torch.Tensor) else None for v in leaves]

    def update(self, source) -> None:
        """Copy in each leaf that is another tensor than the last one copied,
        or the same one written since."""
        for i, v in enumerate(tree.flatten(source)[0]):
            seen = self._seen[i]
            if seen is None or (seen[0] is v and seen[1] == v._version):
                continue
            self.leaves[i].copy_(v)
            self._seen[i] = (v, v._version)


def donate(static: dict, new: dict) -> None:
    """Write the state ``new`` into the buffers of ``static`` (the same
    structure): a buffer that ``new`` holds itself is kept as it is."""
    dst, s_dst = tree.flatten(static)
    src, s_src = tree.flatten(new)
    if repr(s_dst) != repr(s_src) or any(a.shape != b.shape or a.dtype != b.dtype
                                         for a, b in zip(dst, src)):
        raise ValueError("the new state's structure or shapes differ from the buffers'")
    for a, b in zip(dst, src):
        if b is a:
            continue
        if b.untyped_storage().data_ptr() == a.untyped_storage().data_ptr():
            b = b.clone()  # a view of the buffer it overwrites
        a.copy_(b)


def same_layout(a: dict, b: dict) -> bool:
    """Whether two states have one structure, shapes and dtypes."""
    la, sa = tree.flatten(a)
    lb, sb = tree.flatten(b)
    return repr(sa) == repr(sb) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb))


def _clone(x):
    leaves, structure = tree.flatten(x)
    return tree.unflatten(structure, [v.clone() if isinstance(v, torch.Tensor) else v
                                      for v in leaves])


class FrameProgram:
    """The frame of one plan (``passes``, writing ``outputs``) over static
    buffers: the Renderer's ``state`` dict, copies of the externals made
    from ``scene`` and ``camera``. ``run`` renders a frame."""

    def __init__(self, passes, outputs, state: dict, scene, camera, device, skinning: bool,
                 execute):
        self.device = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
        self.tail = [p for p in passes if p.name in EAGER_TAIL]
        self.passes = [p for p in passes if p.name not in EAGER_TAIL]
        if passes[len(self.passes):] != self.tail:
            raise ValueError(f"the eager passes {EAGER_TAIL} must come last")
        written = {w for p in self.passes for w in p.writes}
        needed = [r for p in self.tail for r in p.reads if r not in EXTERNAL]
        self.outputs = tuple(outputs)
        self.graph_outputs = tuple(dict.fromkeys([o for o in outputs if o in written] + needed))
        self.state = state
        self.scene = StaticTree(scene, self.device)
        self.camera = StaticTree(camera, self.device)
        self.time = (torch.zeros((), dtype=torch.float32, device=self.device)
                     if skinning else None)
        self._time_s = 0.0
        self._execute_plan = execute
        self.graph = None
        self.capture_s = None  # host seconds of the capture
        self.pool_bytes = None  # memory reserved by the capture (its pools)
        self.conditional = None  # why not, when the capture made no conditional node
        self._static_out = None
        self._launches = {}
        self._bodies = None  # the capture's control.Conditional (its pool and tallies)

    def _run_plan(self) -> dict:
        """The plan over the static buffers, the new state donated."""
        ext = {"scene": self.scene.value, "camera": self.camera.value, "time": self.time,
               "overlay": None}
        out, new_state = self._execute_plan(self.passes, self.graph_outputs, self.state, **ext)
        donate(self.state, new_state)
        return out

    def run(self, scene, camera, time_s: float = 0.0, overlay=None) -> dict:
        """One frame: the externals copied in, then a replay (on the card
        after the first run) or the plan run over the static buffers; the
        outputs copied out; the eager tail."""
        self.scene.update(scene)
        self.camera.update(camera)
        if self.time is not None and time_s != self._time_s:
            self.time.fill_(float(time_s))
            self._time_s = time_s
        if self.graph is not None:
            self.graph.replay()
            for kernel, n in self._launches.items():
                kernel.count(n)
            out = _clone(self._static_out)
        elif self.device.type == "cuda":
            out = _clone(self._warm_up_and_capture())
        else:
            out = _clone(self._run_plan())
        if self.tail:
            env = {**out, "overlay": overlay}
            tail_out, _ = self._execute_plan(self.tail, [o for o in self.outputs if o not in out],
                                             {}, **env)
            out.update(tail_out)
        return {o: out[o] for o in self.outputs}

    def _warm_up_and_capture(self) -> dict:
        main = torch.cuda.current_stream(self.device)
        side = control.own_stream(self.device, "capture")
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._run_plan()
        main.wait_stream(side)
        self._capture(side)
        return out

    def _capture(self, side) -> None:
        """Capture the plan's frame on ``side``, after every kernel it
        launched is built and loaded; record the launches it captured."""
        t0 = time.perf_counter()
        loaded = [k for k in cuda_build.all_kernels() if k._fn is not None]
        cuda_build.build_all({id(k.library): k.library for k in loaded}.values())
        for k in loaded:
            k.load()
        ok, why = control.conditional_nodes()
        self.conditional = None if ok else why
        bodies = control.Conditional(self.device) if ok else None
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = cuda_build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side), control.capturing(bodies):
            out = self._run_plan()
        after = cuda_build.launch_counts()
        in_bodies = {}
        for tally, per_run in (bodies.bodies if bodies else ()):
            cuda_build.add_tally(tally, per_run)
            for k, n in per_run.items():
                in_bodies[k] = in_bodies.get(k, 0) + n
        captured = {k: n - before.get(k, 0) - in_bodies.get(k, 0) for k, n in after.items()}
        self._launches = {k: n for k, n in captured.items() if n}
        for k in after:  # the capture launched nothing
            k._launches = before.get(k, 0)
        self._static_out, self.graph, self._bodies = out, graph, bodies
        torch.cuda.synchronize(self.device)
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s = time.perf_counter() - t0

    def close(self) -> None:
        """Free the graph and its pools; the conditional bodies' runs so far
        are read with the next launch count (no device read here)."""
        if self._bodies is not None:
            cuda_build.retire_tallies(self._bodies.bodies)
        if self.graph is not None:
            self.graph.reset()
        self.graph = self._static_out = self._bodies = None
