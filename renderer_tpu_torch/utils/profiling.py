"""Profiling, the frame trace and frame statistics
(``renderer_tpu.utils.profiling``).

- ``trace(log_dir)``: a ``torch.profiler`` window over host and card that
  exports a Chrome trace (open it in Perfetto or chrome://tracing). The
  Renderer already wraps every pass in a ``forward.<pass>`` range, so the
  trace shows per-pass spans of eager frames; the frame traces that are on
  add their own tracks (below), so a replayed frame's passes show on the
  device beside the host's launches. The JAX package's ``dump_hlo`` has no
  counterpart: there is no compiled graph; the nearest thing is the ptxas
  report of each kernel build (``ops.cuda_build.CudaLibrary.build_log``).
- ``FrameTrace``: the frame trace of a Renderer, off unless asked for
  (``Renderer.trace_frames(capacity)``). Per
  frame, into rings that keep the last ``capacity`` frames:
  - device stamps at the bounds of each ``span(name)``: every pass of
    ``execute_plan``, the state's donation, the shadow pass's
    ``shadow.lights``, ``shadow.signature``, ``shadow.slots`` and
    ``shadow.stack``. On the card a stamp is a one-thread kernel
    (``csrc/stamp.cu``) writing the card's clock into row
    ``frame % capacity`` of the shard's ring; inside a capture it becomes a
    node of the graph, so every replay stamps its own row. A span's end
    waits for the next stamp (``flush``: the next span's begin, or the end
    of ``execute_plan`` and of the donation), so a boundary between spans
    is one stamp. On the CPU a stamp is the host clock at the bound (the
    work is done when the call returns).
  - host spans (``host_span(name)``): ``render.check_lights``, and the
    frame program's ``copy_in``, ``launch``, ``copy_out`` and ``tail``; a
    program's ``warm_up`` and ``capture`` with the kernel builds and loads
    they make (``cuda_build.build_all``, ``nvcc <source>``,
    ``CudaKernel.load <symbol>``).
  - counters, read by ``read()``: frames, captures and their graph pools'
    bytes, conditional bodies run (``ops/control.py``'s tallies, through
    ``cuda_build.body_runs``), the allocator's device allocations and
    retries since the trace began.
  ``span`` and ``host_span`` cost one list test while no trace is active,
  and nothing at a replay, which runs no Python.
- One clock: ``read()`` gives every time in Unix nanoseconds, the clock
  the profiler's exported trace means (its ``ts`` plus
  ``baseTimeNanoseconds``). Host times map from ``time.perf_counter_ns``
  through host anchors (adjacent reads of both clocks); a card's stamps map
  to the host clock through card anchors, each a stamp bracketed by host
  reads around a synchronize (the tightest of ``ANCHOR_TRIES``), taken when
  the trace begins and at every read, and interpolated between for drift.
  A profile's own clock strays from that by up to ~1% of the time since its
  start, differently in each profile (its conversion of the card's and the
  host's clocks), so ``trace()`` takes an anchor inside the profile at its
  start and end, each in a ``record_function`` range (``ANCHOR_RANGE``), and
  ``profile_offsets`` reads there where the profile put the anchor's range
  and its stamp kernels: ``write_tracks`` moves the spans by those offsets,
  and a stamp lands on its own kernel.
- ``summary(record)``: a read trace's per-frame means; ``span_ms``: the
  device spans' alone; ``metrics``: the benchmark's names for them.
- ``FrameStats``: rolling per-frame wall times and the fps figures of the
  HUD.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import json
import os
import tempfile
import time
import weakref

import numpy as np
import torch

from renderer_tpu_torch.parallel.sharding import current_shard

MAX_MARKS = 64  # stamp columns of a ring: a span's begin and end take one each
STAMP_COLS = 4  # columns one stamp writes
HOST_SPANS_PER_FRAME = 16  # host spans kept per frame of the ring
ANCHOR_TRIES = 16  # bracketed stamps per card anchor; the tightest is kept
HOST_TRIES = 5  # adjacent reads of the two host clocks per host anchor
TRACK_PID = 1 << 24  # the exported trace's process id of the first frame trace's tracks
ANCHOR_RANGE = "frame_trace.anchor"  # the profiler range of an anchor: "<it> <trace>.<anchor>"

_ACTIVE: list = []  # the FrameTrace of the frame being rendered, if any
_LIVE = weakref.WeakSet()  # every FrameTrace made and not freed, for trace()
_NULL = contextlib.nullcontext()
_STAMP = []  # the stamp kernel, made at the first trace on a card
_IDS = itertools.count()  # FrameTrace serial numbers, which name their anchors' ranges


def span(name: str):
    """A device span of the active frame trace (nothing when none is)."""
    return _ACTIVE[-1].span(name) if _ACTIVE else _NULL


def host_span(name: str):
    """A host span of the active frame trace (nothing when none is)."""
    return _ACTIVE[-1].host(name) if _ACTIVE else _NULL


def flush() -> None:
    """Stamp the active frame trace's waiting span ends, if any: before the
    calling shard's next device work outside a span."""
    if _ACTIVE:
        _ACTIVE[-1].flush()


def _stamp_kernel():
    if not _STAMP:
        from renderer_tpu_torch.ops import cuda_build

        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        _STAMP.append(cuda_build.library("stamp.cu").kernel(
            "rtt_stamp", [ptr, ptr, i32, i32, i32, i32, i32, i32]))
    return _STAMP[0]


def _host_anchor() -> tuple:
    """(perf_counter_ns, time_ns) read together: the tightest of HOST_TRIES."""
    best = None
    for _ in range(HOST_TRIES):
        p0 = time.perf_counter_ns()
        u = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, (p0 + p1) // 2, u)
    return best[1:]


def _map(x, anchors) -> np.ndarray:
    """``x`` (int ns) moved by the offset between the anchors' clocks
    ((from, to) pairs, sorted by ``from``), interpolated between anchors and
    the nearest anchor's beyond them."""
    x = np.asarray(x, dtype=np.int64)
    a = np.asarray(anchors, dtype=np.int64)
    off = a[:, 1] - a[:, 0]
    rel = np.interp((x - a[0, 0]).astype(np.float64), (a[:, 0] - a[0, 0]).astype(np.float64),
                    (off - off[0]).astype(np.float64))
    return x + off[0] + np.round(rel).astype(np.int64)


class FrameTrace:
    """The frame trace of one Renderer (module docstring): device stamps of
    each shard (``shards``: the shard's device, one ring each) and host
    spans of the last ``capacity`` frames, and the counters. ``frame`` is
    the id of the frame being rendered (``next_frame``), -1 before the
    first; the frame program fills it into ``frame_ids`` on copy-in
    (``fill``), where the stamps of the card read it."""

    def __init__(self, capacity: int, shards):
        if capacity < 1:
            raise ValueError(f"a frame trace holds at least one frame, not {capacity}")
        self.capacity = int(capacity)
        self.shards = tuple(torch.empty(0, device=d).device for d in shards)
        self.cards = tuple(dict.fromkeys(self.shards))
        self.frame = -1
        self.rings = [torch.full((self.capacity, MAX_MARKS, 2), -1, dtype=torch.int64, device=d)
                      for d in self.shards]
        self.frame_ids = {d: torch.full((), -1, dtype=torch.int64, device=d) for d in self.cards}
        self.marks = {}  # (span, 0: begin | 1: end) -> its column of the rings
        self._waiting = {}  # shard index -> the columns its next stamp writes
        self.host_spans = collections.deque(maxlen=self.capacity * HOST_SPANS_PER_FRAME)
        self.captures = []  # the graph pool bytes of each program captured while on
        self.id = next(_IDS)
        self._host_anchors = []  # (perf_counter_ns, time_ns)
        self._card_anchors = {d: [] for d in self.cards if d.type == "cuda"}  # (card ns, host ns)
        self._anchors = []  # per anchor: (its range's name, host ns at its start, {card: tries})
        self._anchor_rings = {d: (torch.full((1, ANCHOR_TRIES, 2), -1, dtype=torch.int64,
                                             device=d),
                                  torch.zeros((), dtype=torch.int64, device=d))
                              for d in self._card_anchors}
        self._start = self._counters()
        self.anchor()
        _LIVE.add(self)

    # -- recording ---------------------------------------------------------------
    @contextlib.contextmanager
    def active(self):
        """Within: ``span`` and ``host_span`` record into this trace."""
        _ACTIVE.append(self)
        try:
            yield
        finally:
            _ACTIVE.pop()

    def next_frame(self) -> None:
        self._waiting.clear()  # what a frame that raised left marked
        self.frame += 1

    def fill(self, cards) -> None:
        """The frame's id into the buffer the stamps of each card read."""
        for d in cards:
            self.frame_ids[d].fill_(self.frame)

    def mark(self, name: str, edge: int) -> None:
        """Mark the begin (0) or end (1) of span ``name`` for the calling
        shard's next stamp (``flush``)."""
        col = self.marks.get((name, edge))
        if col is None:
            if len(self.marks) == MAX_MARKS:
                raise ValueError(f"more than {MAX_MARKS} stamps a frame: {sorted(self.marks)}")
            col = self.marks[(name, edge)] = len(self.marks)
        shard = current_shard()
        self._waiting.setdefault(0 if shard is None else shard.index, []).append(col)

    def flush(self) -> None:
        """Stamp the calling shard's marked columns, at most STAMP_COLS a
        stamp, into its ring."""
        shard = current_shard()
        i = 0 if shard is None else shard.index
        cols = self._waiting.pop(i, [])
        ring = self.rings[i]
        frame_id = self.frame_ids[ring.device]
        for k in range(0, len(cols), STAMP_COLS):
            chunk = cols[k:k + STAMP_COLS]
            if ring.is_cuda:
                chunk += [-1] * (STAMP_COLS - len(chunk))
                _stamp_kernel().launch(ring.get_device(), ring.data_ptr(), frame_id.data_ptr(),
                                       self.capacity, MAX_MARKS, *chunk)
            else:
                f = int(frame_id)
                ring[f % self.capacity, chunk] = torch.tensor([f, time.perf_counter_ns()])

    @contextlib.contextmanager
    def span(self, name: str):
        self.mark(name, 0)
        self.flush()
        yield
        self.mark(name, 1)

    @contextlib.contextmanager
    def host(self, name: str):
        t0 = time.perf_counter_ns()
        yield
        self.host_spans.append((self.frame, name, t0, time.perf_counter_ns()))

    def anchor(self) -> None:
        """Anchor the clocks (module docstring) inside a profiler range named
        for this anchor; waits for every card."""
        kernel = _stamp_kernel() if self._card_anchors else None
        name = f"{ANCHOR_RANGE} {self.id}.{len(self._anchors)}"
        tries = {}
        p0 = time.perf_counter_ns()
        with torch.profiler.record_function(name):
            start = (p0 + time.perf_counter_ns()) // 2
            for d, (ring, zero) in self._anchor_rings.items():
                brackets = tries[d] = []
                torch.cuda.synchronize(d)
                for j in range(ANCHOR_TRIES):
                    t0 = time.perf_counter_ns()
                    kernel.launch(d.index, ring.data_ptr(), zero.data_ptr(), 1, ANCHOR_TRIES, j,
                                  -1, -1, -1)
                    torch.cuda.synchronize(d)
                    brackets.append((t0, time.perf_counter_ns()))
        for d, brackets in tries.items():
            stamps = self._anchor_rings[d][0][0, :, 1].tolist()
            j = min(range(ANCHOR_TRIES), key=lambda i: brackets[i][1] - brackets[i][0])
            self._card_anchors[d].append((stamps[j], (brackets[j][0] + brackets[j][1]) // 2))
            tries[d] = (stamps, [b[0] for b in brackets])
        self._host_anchors.append(_host_anchor())
        self._anchors.append((name, start, tries))

    def _counters(self) -> dict:
        from renderer_tpu_torch.ops import cuda_build

        stats = [torch.cuda.memory_stats(d) for d in self.cards if d.type == "cuda"]
        return {"bodies_run": cuda_build.body_runs(),
                "device_allocs": sum(s.get("num_device_alloc", 0) for s in stats),
                "alloc_retries": sum(s.get("num_alloc_retries", 0) for s in stats)}

    def counters(self) -> dict:
        """``frames`` rendered, ``captures``, ``pool_bytes`` (per capture),
        ``bodies_run``, ``device_allocs`` and ``alloc_retries``, each since
        the trace began. Reads the cards: taken at a window's start, it is
        ``summary``'s ``since``."""
        now = self._counters()
        return {"frames": self.frame + 1, "captures": len(self.captures),
                "pool_bytes": list(self.captures),
                **{k: now[k] - self._start[k] for k in now}}

    # -- reading ---------------------------------------------------------------------
    def to_unix(self, t, device=None) -> np.ndarray:
        """Host ``perf_counter_ns`` times (or, with a card's ``device``, its
        stamps) on the profiler's clock, Unix ns."""
        if device is not None and device.type == "cuda":
            t = _map(t, self._card_anchors[device])
        return _map(t, self._host_anchors)

    def read(self) -> dict:
        """The frames held (the last ``capacity``), on the profiler's clock:

        - ``device``: per shard, ``{frame: {span: (begin, end)}}``, spans in
          the order of their first stamp ever, each span with both its
          stamps written by that frame;
        - ``host``: ``(frame, span, begin, end)`` by begin;
        - ``counters``: ``counters()``;
        - ``drift_ppm``: per card, its clock's rate against the host's;
        - ``anchors``: each anchor's range name and start, and per card its
          stamps and the host's time before each stamp's launch, for
          ``profile_offsets``.

        Reads the cards: call it between frames."""
        self.anchor()
        frames = list(range(max(0, self.frame - self.capacity + 1), self.frame + 1))
        cols = {}
        for (name, edge), col in sorted(self.marks.items(), key=lambda kv: kv[1]):
            cols.setdefault(name, [None, None])[edge] = col
        cols = {n: c for n, c in cols.items() if None not in c}
        device = []
        for shard, ring in zip(self.shards, self.rings):
            cells = ring.cpu().numpy()[[f % self.capacity for f in frames]]
            mine = cells[..., 0] == np.asarray(frames, dtype=np.int64)[:, None]
            times = self.to_unix(cells[..., 1], shard)
            device.append({f: {n: (int(times[i, b]), int(times[i, e])) for n, (b, e) in cols.items()
                               if mine[i, b] and mine[i, e]} for i, f in enumerate(frames)})
        first = frames[0] if frames else 0
        held = sorted((s for s in list(self.host_spans) if s[0] >= first), key=lambda s: s[2])
        host = []
        if held:
            ts = self.to_unix(np.array([[s[2], s[3]] for s in held]))
            host = [(f, n, int(t0), int(t1)) for (f, n, _, _), (t0, t1) in zip(held, ts)]
        counters = self.counters()
        drift = {}
        for d, anchors in self._card_anchors.items():
            (g0, h0), (g1, h1) = anchors[0], anchors[-1]
            drift[str(d)] = (g1 - g0 - (h1 - h0)) / (h1 - h0) * 1e6 if h1 > h0 else 0.0
        anchors = [{"name": name, "t": int(self.to_unix(start)),
                    "cards": {str(d): {"stamps": self.to_unix(g, d).tolist(),
                                       "launched": self.to_unix(t0).tolist()}
                              for d, (g, t0) in tries.items()}}
                   for name, start, tries in self._anchors]
        return {"capacity": self.capacity, "frames": frames,
                "shards": [str(d) for d in self.shards], "device": device, "host": host,
                "counters": counters, "drift_ppm": drift, "anchors": anchors,
                "clock": "unix_ns"}


def frame_bounds(record, frame) -> tuple:
    """(first stamp, last stamp) of ``frame`` over the shards, or None."""
    times = [t for per in record["device"] for s in per.get(frame, {}).values() for t in s]
    return (min(times), max(times)) if times else None


def span_ms(record, frames=None) -> dict:
    """Mean device ms of each span over ``frames`` (every frame read by
    default) and the shards, over the frames that hold it."""
    frames = record["frames"] if frames is None else frames
    sums, counts = {}, {}
    for per in record["device"]:
        for f in frames:
            for name, (b, e) in per.get(f, {}).items():
                sums[name] = sums.get(name, 0) + (e - b)
                counts[name] = counts.get(name, 0) + 1
    return {n: sums[n] * 1e-6 / counts[n] for n in sums}


def _union_ns(intervals) -> int:
    total, end = 0, None
    for b, e in sorted(intervals):
        if end is None or b > end:
            total, end = total + e - b, e
        elif e > end:
            total, end = total + e - end, e
    return total


def summary(record, frames=None, since=None) -> dict:
    """Per frame over ``frames`` (every frame read by default):

    - ``host_ms``: each host span's ms per frame (a frame without it
      counts 0);
    - ``device_ms``: ``span_ms``;
    - ``donate_ms``: from the last stamp before the donation to its end;
    - ``frame_gap_pct``: 100 x the device's time between one frame's last
      stamp and the next frame's first (where positive) over the wall of
      the runs of consecutive frames, each from its first frame's first
      stamp to its last frame's last (a frame left out ends a run: the time
      around it counts in neither);
    - ``cover_pct``: the least share of a frame's first-to-last stamp span
      that its spans cover;
    - ``bodies_per_frame``: conditional bodies run per frame rendered since
      ``since`` (the trace's ``counters()`` at the window's start; None:
      since the trace began, set-up frames included); ``pool_bytes``: the
      last capture's pool.

    A value the record holds nothing for is None."""
    frames = sorted(record["frames"] if frames is None else frames)
    held = set(frames)
    host = {}
    for f, name, b, e in record["host"]:
        if f in held:
            host[name] = host.get(name, 0.0) + (e - b) * 1e-6
    donate, cover, bounds = [], [], {}
    for f in frames:
        bounds[f] = frame_bounds(record, f)
        for per in record["device"]:
            spans = per.get(f, {})
            if "donate" in spans:
                b, e = spans["donate"]
                before = [s[1] for n, s in spans.items() if n != "donate" and s[1] <= b]
                donate.append((e - max(before or [b])) * 1e-6)
            if spans:
                first = min(s[0] for s in spans.values())
                last = max(s[1] for s in spans.values())
                if last > first:
                    cover.append(100.0 * _union_ns(spans.values()) / (last - first))
    gaps = wall = 0
    run_start = None
    for f in frames:
        if bounds[f] is None:
            continue
        if bounds.get(f - 1) is None:
            run_start = bounds[f][0]
        else:
            gaps += max(0, bounds[f][0] - bounds[f - 1][1])
        if bounds.get(f + 1) is None:
            wall += bounds[f][1] - run_start
    c = record["counters"]
    s = since or {"frames": 0, "bodies_run": 0}
    rendered = c["frames"] - s["frames"]
    return {
        "frames": len(frames),
        "host_ms": {n: v / len(frames) for n, v in host.items()} if frames else {},
        "device_ms": span_ms(record, frames),
        "donate_ms": sum(donate) / len(donate) if donate else None,
        "frame_gap_pct": 100.0 * gaps / wall if wall else None,
        "cover_pct": min(cover) if cover else None,
        "bodies_per_frame": (c["bodies_run"] - s["bodies_run"]) / rendered if rendered else None,
        "pool_bytes": c["pool_bytes"][-1] if c["pool_bytes"] else None,
    }


def metrics(record, frames=None, since=None) -> dict:
    """The benchmark's per-layer metrics of the frame trace, by name, from
    ``summary(record, frames, since)``: the host spans' and the replayed
    passes' ms, the shadow pass's sub-spans, the donation, the gaps
    between frames, the conditional bodies run per frame and the graph
    pool. A frame without a light change has no ``render.check_lights``
    (``host_wait_ms`` 0)."""
    s = summary(record, frames, since)
    host, dev = s["host_ms"], s["device_ms"]
    return {"copy_in_ms": host.get("copy_in"), "launch_ms": host.get("launch"),
            "copy_out_ms": host.get("copy_out"),
            "host_wait_ms": host.get("render.check_lights", 0.0),
            "cull_replay_ms": dev.get("cull"), "raster_replay_ms": dev.get("raster"),
            "shade_replay_ms": dev.get("shade_shadowed"),
            "shadow_signature_ms": dev.get("shadow.signature"),
            "shadow_slots_ms": dev.get("shadow.slots"), "shadow_stack_ms": dev.get("shadow.stack"),
            "donate_ms": s["donate_ms"], "frame_gap_pct": s["frame_gap_pct"],
            "shadow_bands_per_frame": s["bodies_per_frame"],
            "graph_pool_gib": None if s["pool_bytes"] is None else s["pool_bytes"] / 2**30}


def profile_offsets(doc: dict, record: dict) -> dict:
    """Where an exported profile (``doc``, its ``trace.json``) put the
    anchors of ``record`` that it holds: ``{"host": pairs, card: pairs}``,
    each pair (a time of the record, that time on the profile's clock), in
    Unix ns, the median over an anchor's tries: on the host, each stamp's
    ``cudaLaunchKernel`` call (found inside the anchor's range) against the
    host's time before it (the range's start on a host without cards); per
    card, the stamp kernel's start (by the call's correlation id) against
    the stamp."""
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.get("traceEvents", [])
    ranges = {e["name"]: (e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith(ANCHOR_RANGE)}
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaLaunchKernel"
                      and "correlation" in e.get("args", {}))
    kernels = {e["args"]["correlation"]: e["ts"] for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}

    def on_profile(ts):
        return base + round(ts * 1e3)

    def pair(ts, offs):
        offs = sorted(offs)
        return ts[len(ts) // 2], ts[len(ts) // 2] + offs[len(offs) // 2]

    out = {"host": []}
    for a in record["anchors"]:
        if a["name"] not in ranges:
            continue
        lo, hi = ranges[a["name"]]
        calls = [(ts, c) for ts, c in launches if lo <= ts <= hi]
        host = []
        for card, tries in a["cards"].items():
            mine, calls = calls[:len(tries["stamps"])], calls[len(tries["stamps"]):]
            host += [on_profile(ts) - t for (ts, _), t in zip(mine, tries["launched"])]
            offs = [on_profile(kernels[c]) - t for (_, c), t in zip(mine, tries["stamps"])
                    if c in kernels]
            if offs:
                out.setdefault(card, []).append(pair(tries["stamps"], offs))
        if host:
            out["host"].append(pair(next(iter(a["cards"].values()))["launched"], host))
        else:
            out["host"].append((a["t"], on_profile(lo)))
    return out


def to_profile(t, pairs) -> np.ndarray:
    """Times of a record (Unix ns) on a profile's clock through
    ``profile_offsets``' pairs (none: as they are)."""
    return _map(t, sorted(pairs)) if pairs else np.asarray(t, dtype=np.int64)


def write_tracks(path: str, records, window=None) -> None:
    """Add each frame trace's ``record`` to the Chrome trace at ``path`` as
    tracks of their own: one per shard's device spans, one of host spans
    (``args.frame``: the frame), moved onto the profile's clock by the
    anchors it holds (``profile_offsets``). ``window``: (first, last) Unix
    ns of what is kept (None: all)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc.setdefault("traceEvents", [])
    lo, hi = window or (-(1 << 62), 1 << 62)

    def add(pid, tid, pairs, f, name, b, e):
        if e >= lo and b <= hi:
            b, e = to_profile([b, e], pairs).tolist()
            events.append({"ph": "X", "cat": "frame_trace", "name": name, "pid": pid, "tid": tid,
                           "ts": (b - base) * 1e-3, "dur": (e - b) * 1e-3, "args": {"frame": f}})

    for k, rec in enumerate(records):
        offsets = profile_offsets(doc, rec)
        pid = TRACK_PID + k
        names = [f"device spans, shard {i} ({d})" for i, d in enumerate(rec["shards"])]
        names.append("host spans")
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"frame trace {k}"}})
        for tid, name in enumerate(names):
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": name}})
        for tid, (shard, per) in enumerate(zip(rec["shards"], rec["device"])):
            pairs = offsets.get(shard, offsets["host"])
            for f, spans in per.items():
                for name, (b, e) in spans.items():
                    add(pid, tid, pairs, f, name, b, e)
        for f, name, b, e in rec["host"]:
            add(pid, len(rec["shards"]), offsets["host"], f, name, b, e)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the block (CPU, and CUDA when there is a card); on exit
    write ``<log_dir>/trace.json`` (default: a directory in the temporary
    directory) with the tracks of every frame trace that is on, over the
    block, each anchored at the block's start and end (waits for the
    cards). Yields the log directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "renderer_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    start = time.time_ns()
    with profile(activities=activities) as prof:
        for t in list(_LIVE):
            t.anchor()
        yield log_dir
        traces = list(_LIVE)
        for t in traces:
            t.anchor()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if traces:
        write_tracks(path, [t.read() for t in traces], (start, time.time_ns()))


class FrameStats:
    """Rolling frame-time statistics over the last ``window`` frames."""

    def __init__(self, window: int = 120):
        self.window = window
        self.samples: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.window:
                self.samples.pop(0)
        self._last = now

    def summary(self) -> dict:
        if not self.samples:
            return {"fps": 0.0, "ms_avg": 0.0, "ms_p99": 0.0}
        s = sorted(self.samples)
        avg = sum(s) / len(s)
        p99 = s[min(len(s) - 1, int(len(s) * 0.99))]
        return {"fps": 1.0 / avg if avg > 0 else 0.0, "ms_avg": avg * 1e3, "ms_p99": p99 * 1e3}
