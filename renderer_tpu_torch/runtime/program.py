"""One frame of a plan as CUDA graph replays: the counterpart of the JAX
Renderer's jitted program per plan (``renderer_tpu.runtime.frame._jit_for``,
``graph.core.CompiledPlan.execute``: every pass in one XLA program, the
persistent state donated to it; under ``spmd_mesh`` the whole plan in one
``shard_map``).

A ``FrameProgram`` is made per switch set and per shapes of the frame's
scene and camera (``tree_key``), on one device or over a mesh of shards
(``parallel.sharding``). It holds:

- static copies of the externals the graphs read, one per device: the
  scene's and the camera's tensors (``StaticTree``: before each run only
  the leaves that changed are copied in, a leaf being another tensor or
  the same one written since, by its version counter) and the animation
  clock, a () tensor filled before a run whose ``time_s`` differs;
- the persistent state of each shard (the Renderer's state on one
  device), whose buffers the graphs read as the previous frame left them
  and, after the last pass, overwrite with the new state in stream order
  (``donate``): they stay the same tensors;
- on CUDA devices, the captured graphs (``graphs``): one on one device;
  over a mesh one per shard and *segment*, a segment being a shard's work
  from one collective to the next (``Segments``).

The first run of a program on the card is its warm-up: the frame runs
eagerly on the program's side stream of each device (every kernel of the
plan built, loaded and launched once, lazy initialisations done, as
``torch.cuda.graphs`` prescribes) and is the frame returned; the graphs
are captured after it. Every later run is replays only. The named outputs
are copied out of the graphs' pools after each run, so a frame already
returned is never overwritten. On the CPU nothing is captured: every run
executes the plan over the same static buffers.

The split frame's capture. The shards meet only at their collectives,
taking turns on the host (``run_shards``), so one capture is open at a
time: at each collective a shard's thread ends its segment's capture
before it hands over its value, and begins the next segment when its turn
comes back; what the collective does with its peers' values (their
``torch.cat``, the copies from other cards, the psum's adds, the halo
slices) is captured into that next segment. Each segment is captured in
``thread_local`` error mode (the waiting shard threads make no CUDA call,
but no capture may depend on that) into one memory pool per device, which
that device's segments share in capture order. ``Segments`` keeps every
value a collective exchanged or returned for the program's life: the pool
would otherwise hand their memory to a later segment that a peer's replay
still reads. A replay launches the segments from the calling thread in
capture order on each device's current stream, so shards on one card run
in the eager frame's order; across cards, before each collective's step
every card waits on an event every other card recorded after its
previous step.

What runs outside the graphs is named here: the passes of ``EAGER_TAIL``
(``overlay_pass`` loops on the host over the overlay's glyph layers and
copies them pinned; under a mesh it gathers the rows first) run eagerly
after the replay, over its outputs.

Kernel launches: a replay calls no wrapper, so the program records each
kernel's launches during the capture and adds them at every replay
(``CudaKernel.count``); those inside conditional nodes count through the
bodies' tallies on the device (``ops/control.py``, one ``Conditional`` per
device, shared by its shards).

The frame trace (``utils.profiling.FrameTrace``, given as ``trace``; the
Renderer drops its programs when it turns the trace on or off): a run then
records the host spans ``copy_in`` (the externals and the frame's id),
``launch`` (the replays and the launch bookkeeping, or the warm-up and the
capture), ``copy_out`` and ``tail``, and the capture takes the stamps of
every pass (``execute``'s wrap) and of the donation into the graphs, so
each replay stamps its own frame. Without it a run is the same calls,
unrecorded, and the graphs hold no stamp.
"""

from __future__ import annotations

import contextlib
import time

import torch

from renderer_tpu_torch.ops import control, cuda_build
from renderer_tpu_torch.parallel.sharding import Mesh, run_shards
from renderer_tpu_torch.passes.pipeline import EXTERNAL
from renderer_tpu_torch.utils import tree
from renderer_tpu_torch.utils.profiling import flush, host_span, span

EAGER_TAIL = ("overlay_pass",)
# a segment's capture refuses unsafe CUDA calls from its own thread only
CAPTURE_MODE = "thread_local"


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


@contextlib.contextmanager
def _on(streams):
    """Within: each of ``streams`` current on its device (the last one's
    device current)."""
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        yield


class Segments:
    """The capture of one frame cut at the collectives: ``begin(i)`` and
    ``end(i)`` bracket a segment of shard i (a ``torch.cuda.CUDAGraph``
    captured on the current stream, into its device's pool), ``keep``
    holds a collective's values. ``graphs``: (shard, graph) in capture
    order."""

    def __init__(self, devices):
        self.devices = devices
        self.pools = {}  # device -> its pool handle, made at its first segment
        self.graphs = []
        self.kept = []
        self._open = {}

    def begin(self, shard: int) -> None:
        device = self.devices[shard]
        if device not in self.pools:
            self.pools[device] = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pools[device], capture_error_mode=CAPTURE_MODE)
        self._open[shard] = graph, torch.cuda.current_stream(device)

    def end(self, shard: int) -> None:
        graph, _ = self._open.pop(shard)
        graph.capture_end()
        self.graphs.append((shard, graph))

    def abandon(self, shard: int) -> None:
        """End shard's open capture, if any, after its frame raised (the
        frame's error is the one raised): its stream leaves capture mode.
        Ending an invalidated capture raises at the stream's end of capture,
        before ``CUDAGraph.capture_end`` reaches its two calls into the
        allocator, so they are made here."""
        graph, stream = self._open.pop(shard, (None, None))
        if graph is None:
            return
        with torch.cuda.stream(stream):
            try:
                graph.capture_end()
            except RuntimeError:
                device = self.devices[shard]
                # stop routing allocations to the pool: the routing test
                # reads the graph object, which is freed with the program
                torch._C._cuda_endAllocateToPool(device.index, self.pools[device])
                # drop the capture's use of the pool: a graph whose capture
                # did not end never drops it, and the pool is never freed
                torch._C._cuda_releasePool(device.index, self.pools[device])

    def keep(self, value) -> None:
        self.kept.append(value)

    def steps(self) -> list:
        """Per collective crossed, the segments the shards captured before
        it (the last step: after the last one), as (device, graph) in
        capture order."""
        steps, done = [], [0] * len(self.devices)
        for shard, graph in self.graphs:
            if done[shard] == len(steps):
                steps.append([])
            steps[done[shard]].append((self.devices[shard], graph))
            done[shard] += 1
        if len(set(done)) != 1:
            raise RuntimeError(f"the shards' frames crossed different numbers of collectives: "
                               f"{done} segments")
        return steps


class FrameProgram:
    """The frame of one plan (``passes``, writing ``outputs``) over static
    buffers made from ``scene`` and ``camera``, on ``device``, or over the
    shards of a ``Mesh`` passed as ``device`` (``state`` is then the list
    of the shards' states). ``run`` renders a frame, recorded into
    ``trace`` (a ``utils.profiling.FrameTrace``) if given."""

    def __init__(self, passes, outputs, state, scene, camera, device, skinning: bool,
                 execute, trace=None):
        self.mesh = device if isinstance(device, Mesh) else None
        if self.mesh is None:
            self.devices = (torch.empty(0, device=device).device,)  # "cuda" -> "cuda:0"
            self.states = [state]
        else:
            self.devices, self.states = self.mesh.devices, list(state)
        self.device = self.devices[0]
        self.cards = tuple(dict.fromkeys(self.devices))
        self.tail = [p for p in passes if p.name in EAGER_TAIL]
        self.passes = [p for p in passes if p.name not in EAGER_TAIL]
        if passes[len(self.passes):] != self.tail:
            raise ValueError(f"the eager passes {EAGER_TAIL} must come last")
        written = {w for p in self.passes for w in p.writes}
        needed = [r for p in self.tail for r in p.reads if r not in EXTERNAL]
        self.outputs = tuple(outputs)
        self.graph_outputs = tuple(dict.fromkeys([o for o in outputs if o in written] + needed))
        self.scene = {d: StaticTree(scene, d) for d in self.cards}
        self.camera = {d: StaticTree(camera, d) for d in self.cards}
        self.time = ({d: torch.zeros((), dtype=torch.float32, device=d) for d in self.cards}
                     if skinning else None)
        self._time_s = 0.0
        self._execute_plan = execute
        self.trace = trace
        self.capture_s = None  # host seconds of the capture
        self.pool_bytes = None  # memory reserved by the capture (its pools), all devices
        self.conditional = None  # why not, when the capture made no conditional node
        self._steps = []  # Segments.steps() of the capture
        self._kept = None  # what the collectives exchanged and returned in the capture
        self._events = None  # per device, when the program spans several
        self._static_out = None
        self._launches = {}
        self._bodies = []  # the capture's control.Conditional per device (pools, tallies)

    @property
    def state(self) -> dict:
        """The state buffers of the (first) shard."""
        return self.states[0]

    @property
    def graphs(self) -> list:
        """The captured graphs in capture order (none before the capture)."""
        return [graph for step in self._steps for _, graph in step]

    def _shard_frame(self, i: int) -> dict:
        """Shard i's plan over its static buffers, its new state donated."""
        d = self.devices[i]
        ext = {"scene": self.scene[d].value, "camera": self.camera[d].value,
               "time": None if self.time is None else self.time[d], "overlay": None}
        out, new_state = self._execute_plan(self.passes, self.graph_outputs, self.states[i],
                                            **ext)
        with span("donate"):
            donate(self.states[i], new_state)
        flush()
        return out

    def _each_shard(self, fn, segments=None) -> list:
        """``fn(i)`` for each shard, in the calling thread on one device,
        else through ``run_shards``; captured into ``segments`` if given."""
        if self.mesh is not None:
            return run_shards(self.mesh, lambda s: fn(s.index), segments=segments)
        if segments is None:
            return [fn(0)]
        segments.begin(0)
        try:
            out = fn(0)
        except BaseException:
            segments.abandon(0)
            raise
        segments.end(0)
        return [out]

    def run(self, scene, camera, time_s: float = 0.0, overlay=None) -> list:
        """One frame: the externals copied in, then the replays (on the
        card after the first run) or the plan run over the static buffers;
        the outputs copied out; the eager tail. Returns each shard's
        outputs."""
        with host_span("copy_in"):
            for d in self.cards:
                self.scene[d].update(scene)
                self.camera[d].update(camera)
                if self.time is not None and time_s != self._time_s:
                    self.time[d].fill_(float(time_s))
            self._time_s = time_s
            if self.trace is not None:
                self.trace.fill(self.cards)
        with host_span("launch"):
            if self._steps:
                self.replay()
                for kernel, n in self._launches.items():
                    kernel.count(n)
                outs = self._static_out
            elif self.device.type == "cuda":
                outs = self._warm_up_and_capture()
            else:
                outs = self._each_shard(self._shard_frame)
        with host_span("copy_out"):
            outs = [_clone(o) for o in outs]
        with host_span("tail"):
            if self.tail:
                def tail(i):
                    return self._execute_plan(self.tail,
                                              [o for o in self.outputs if o not in outs[i]],
                                              {}, **outs[i], overlay=overlay)[0]

                for out, more in zip(outs, self._each_shard(tail)):
                    out.update(more)
            return [{o: out[o] for o in self.outputs} for out in outs]

    def replay(self) -> None:
        """Launch the captured graphs in capture order on each device's
        current stream; across devices, each step after every device's
        previous one."""
        streams = {d: torch.cuda.current_stream(d) for d in self.cards}
        for step in self._steps:
            if self._events is not None:
                for d, event in self._events.items():
                    event.record(streams[d])
                for d in self.cards:
                    for other, event in self._events.items():
                        if other != d:
                            streams[d].wait_event(event)
            for d, graph in step:
                with torch.cuda.device(d):
                    graph.replay()

    def _warm_up_and_capture(self) -> list:
        mains = [torch.cuda.current_stream(d) for d in self.cards]
        sides = [control.own_stream(d, "capture") for d in self.cards]
        for side, main in zip(sides, mains):
            side.wait_stream(main)
        with _on(sides), host_span("warm_up"):
            outs = self._each_shard(self._shard_frame)
        for side, main in zip(sides, mains):
            main.wait_stream(side)
        with host_span("capture"):
            self._capture(sides)
        if self.trace is not None:
            self.trace.captures.append(self.pool_bytes)
        return outs

    def _capture(self, sides) -> None:
        """Capture the plan's frame on ``sides`` (one stream per device),
        after every kernel it launched is built and loaded; record the
        launches it captured."""
        t0 = time.perf_counter()
        loaded = [k for k in cuda_build.all_kernels() if k._fn is not None]
        cuda_build.build_all({id(k.library): k.library for k in loaded}.values())
        for k in loaded:
            k.load()
        ok, why = control.conditional_nodes()
        self.conditional = None if ok else why
        bodies = {d: control.Conditional(d) for d in self.cards} if ok else {}
        for d in self.cards:
            torch.cuda.synchronize(d)
        torch.cuda.empty_cache()
        reserved = sum(torch.cuda.memory_reserved(d) for d in self.cards)
        before = cuda_build.launch_counts()
        segments = Segments(self.devices)
        with _on(sides), control.capturing(bodies):
            out = self._each_shard(self._shard_frame, segments)
        after = cuda_build.launch_counts()
        in_bodies = {}
        for tally, per_run in (b for c in bodies.values() for b in c.bodies):
            cuda_build.add_tally(tally, per_run)
            for k, n in per_run.items():
                in_bodies[k] = in_bodies.get(k, 0) + n
        captured = {k: n - before.get(k, 0) - in_bodies.get(k, 0) for k, n in after.items()}
        self._launches = {k: n for k, n in captured.items() if n}
        for k in after:  # the capture launched nothing
            k._launches = before.get(k, 0)
        self._steps, self._kept = segments.steps(), segments.kept
        self._static_out, self._bodies = out, list(bodies.values())
        if len(self.cards) > 1:
            self._events = {d: torch.cuda.Event() for d in self.cards}
        for d in self.cards:
            torch.cuda.synchronize(d)
        self.pool_bytes = sum(torch.cuda.memory_reserved(d) for d in self.cards) - reserved
        self.capture_s = time.perf_counter() - t0

    def close(self) -> None:
        """Free the graphs and their pools; the conditional bodies' runs so
        far are read with the next launch count (no device read here)."""
        for bodies in self._bodies:
            cuda_build.retire_tallies(bodies.bodies)
        for graph in self.graphs:
            graph.reset()
        self._steps, self._bodies = [], []
        self._kept = self._static_out = None
