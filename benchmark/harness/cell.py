"""One run of one cell: set-up, the measured window, the traced readings
(``--trace 1``), the output check, the result line.

Set-up: the scene from the seed, the traffic's tables on the device, the
Renderer with the configuration's switches, and the cell's first frames
k = -S..-1 (S = the atlas's units + 1), whose first frame runs eagerly and
captures the switch set's CUDA graph and whose others fill the atlas the
way the traffic leaves it. The window then renders frames k = 0, 1, ...
for ``seconds`` on the host clock and waits for the last.

A traced run measures the same window with the profiler over two
stretches of its frames (``Stretches``), then counts the atlas units
re-rendered over frames after the window, then profiles eager frames
(``Renderer(replay=False)``) at the window's first poses for the per-pass
device times.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from benchmark.harness import check, program, spec, timing
from benchmark.harness import trace as tr_mod
from benchmark.harness.traffic import Traffic, get_field, replace_field, seed_of

IN_FLIGHT = 2        # frames submitted ahead of the host: before frame k it waits on frame k - 2
TRACE_START = 8      # window frame at which the traced stretch starts
TRACE_FRAMES = 32    # frames in the traced stretch of device activity
HOST_FRAMES = 8      # frames in the stretch that also traces the host
UNIT_FRAMES = 16     # frames after the window over which atlas units are counted
EAGER_FRAMES = 5     # eager frames profiled for the per-pass device times
SLOWEST_FRAME_MS = 60.0  # compared frames are drawn among the frames a window this slow holds
FORBIDDEN = ("jax", "jaxlib", "flax", "renderer_tpu")
KERNEL1 = ("raster_prep_kernel", "raster_walk_kernel")


def loaded_forbidden() -> list:
    """Modules of ``FORBIDDEN`` in ``sys.modules``, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _outputs(out) -> dict:
    return {"image": out["image"], "depth": out["vis"].depth, "tri_id": out["vis"].tri_id}


class Stretches:
    """The traced stretches of a window: ``busy``, TRACE_FRAMES frames from
    window frame TRACE_START under the profiler with device activity only
    (the busy time, the idle share, the device ops), then ``host``,
    HOST_FRAMES frames that also trace the host (what the host did while
    the device idled). Each starts with no frame in flight and ends once its
    last frame has completed; ``results[name]`` is (the profile, its
    host-clock seconds)."""

    def __init__(self, device, clock, marks_box):
        from torch.profiler import ProfilerActivity

        cuda = [ProfilerActivity.CUDA] if device.type == "cuda" else []
        host_start = TRACE_START + TRACE_FRAMES + 4
        self.plan = (("busy", TRACE_START, TRACE_FRAMES, cuda or [ProfilerActivity.CPU]),
                     ("host", host_start, HOST_FRAMES, [ProfilerActivity.CPU] + cuda))
        self.clock, self.marks = clock, marks_box
        self.open, self.results = None, {}

    def frames(self) -> set:
        """Window frame positions inside a stretch."""
        return {i for _, start, n, _ in self.plan for i in range(start, start + n)}

    def _drain(self, i):
        if i > 0:
            self.clock.wait(self.marks["marks"][i - 1])

    def on_frame(self, i):
        from torch.profiler import profile, record_function

        for name, start, n, acts in self.plan:
            if i == start + n and self.open is not None:
                self.close(i)
            if i == start:
                self._drain(i)
                prof = profile(activities=acts)
                prof.start()
                rf = record_function("bench.stretch")
                rf.__enter__()
                self.open = (name, prof, rf, time.perf_counter())

    def close(self, i):
        name, prof, rf, t0 = self.open
        self._drain(i)
        wall = time.perf_counter() - t0
        rf.__exit__(None, None, None)
        prof.stop()
        self.results[name] = (prof, wall)
        self.open = None


def inputs(cell: str, seed: int, device, override=None, bench_dir: str = spec.BENCH_DIR):
    """What the benchmark makes for a cell and seed before any frame: (its
    workload file, its configuration, the scene, the traffic, the number of
    set-up frames S, the atlas's units + 1)."""
    wl = spec.workload(cell, bench_dir)
    cfg = spec.config(wl["config"], bench_dir)
    if override is not None:
        cfg = override(cfg)
    params = spec.traffic(wl["traffic"], bench_dir)
    pc = cfg["pipeline"]
    scene = program.build_scene(cfg, seed_of(seed), device)
    n_setup = pc["shadow_slots"] * pc["shadow_progressive"] + 1
    base = {f: program.host_array(get_field(scene, f)) for f in Traffic.moved_fields(params)}
    traffic = Traffic(params, seed, pc["width"] / pc["height"], n_setup, base)
    return wl, cfg, scene, traffic, n_setup


def run(cell: str, seed: int, seconds: float, traced: bool, t_start: float, device="cuda",
        override=None, bench_dir: str = spec.BENCH_DIR, root: str = spec.ROOT, log=None):
    """Run the cell once. Returns (the result line's dict, the check's
    table); ``override(cfg)`` resizes the configuration (the tests)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # -- set-up ----------------------------------------------------------------
    parts = {"imports": time.perf_counter() - t_start}
    mark = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    wl, cfg, scene, traffic, n_setup = inputs(cell, seed, device, override, bench_dir)
    pc = cfg["pipeline"]
    part("scene")
    tables = traffic.device_tables(device)
    frames = program.Frames(scene, tables, traffic)
    renderer = program.make_renderer(scene, cfg, device)
    clock = program.Clock(device)
    part("tables and renderer")
    program.run_frames(renderer, frames, range(-n_setup, -n_setup + 1), clock, IN_FLIGHT)
    part("first frame (eager, capture)")
    program.run_frames(renderer, frames, range(-n_setup + 1, 0), clock, IN_FLIGHT)
    part(f"{n_setup - 1} more set-up frames")
    tracer = None
    if traced:  # the profiler's own start-up, outside the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if cuda else [])):
            torch.ones(1, device=device).add_(1)
        if cuda:
            torch.cuda.synchronize(device)
        part("profiler start-up")
    compare_ks = traffic.compared(max(1, int(seconds * 1e3 / SLOWEST_FRAME_MS)))

    # -- the window ----------------------------------------------------------------
    marks_box = {}
    if traced:
        tracer = Stretches(device, clock, marks_box)

    def on_frame(i, k):
        if tracer is not None:
            tracer.on_frame(i)

    setup_s = time.perf_counter() - t_start
    res = program.run_frames(renderer, frames, _count(), clock, IN_FLIGHT, keep=compare_ks,
                             seconds=seconds, on_frame=on_frame, marks_out=marks_box)
    if tracer is not None and tracer.open is not None:
        tracer.close(res["frames"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    n = res["frames"]
    comp = [clock.between_ms(res["start"], m) for m in res["marks"]]
    record = {"frames": n, "wall_s": res["wall_s"], "intervals_ms": timing.intervals_ms(0.0, comp),
              "setup_s": setup_s, "peak_bytes": peak, "trace": None}
    ivs = record["intervals_ms"]
    calls = [c * 1e3 for c in res["calls_s"]]
    log("benchmark: per 64 frames, mean frame interval / render call (ms): "
        + " ".join(f"{statistics.mean(ivs[i:i + 64]):.2f}/{statistics.mean(calls[i:i + 64]):.2f}"
                   for i in range(0, len(ivs), 64)))
    log(f"benchmark: {cell} seed {seed}: {n} frames in {res['wall_s']:.3f} s, set-up "
        f"{setup_s:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + f"), peak {peak / 2**30:.3f} GiB")

    last_k, last_out = res["last"]
    compared = {k: _outputs(res["kept"][k]) for k in compare_ks if k in res["kept"]}
    compared[last_k] = _outputs(last_out)
    st = renderer.state
    final = {"draw_list": tuple(t.clone() for t in st["draw_list"]),
             "atlas": st["shadow_cache"][0].clone()}

    breakdown = None
    if traced:
        record["trace"], breakdown = _traced_readings(renderer, frames, scene, cfg, device, res,
                                                      tracer, n)
    renderer.drop_plans()
    del renderer, res, last_out, st
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"benchmark: the process loaded {found} (jax or the JAX package)")

    # -- the output check -------------------------------------------------------------
    scene_at = reference_scenes(scene, traffic, device)
    reference = check.reference_module(cfg)
    ref_frames = reference.Frames(scene_at, traffic.pose, pc, device, traffic.scene_key)
    t0 = time.perf_counter()
    per_frame = check.reference_numbers(reference, ref_frames, -n_setup, last_k, compared, final)
    worst = check.worst(per_frame)
    limits = wl["limits"]
    ok, table = check.verdict(worst, limits)
    log(f"benchmark: output check of frames {sorted(per_frame)} in "
        f"{time.perf_counter() - t0:.1f} s")

    readers = spec.metric_readers(bench_dir)
    metrics = {}
    for name in spec.cell_metrics(cell, traced, readers, root):
        v = readers[name].read(record)
        if v is not None:
            metrics[name] = {"value": v, "unit": readers[name].UNIT}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced and "busy_s" in (record["trace"] or {}):
        dev["busy_s"] = record["trace"]["busy_s"]
        dev["window_s"] = record["trace"]["window_s"]
    line = {"correct": bool(ok), "attempted": n, "failed": check.failed(per_frame, limits),
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = table
    return line, table


def reference_scenes(scene, traffic, device):
    """``scene_at(f)``: frame f's scene as the reference reads it, the base
    scene with every column the traffic moves made anew for frame f (None:
    the base scene)."""
    def scene_at(f):
        sc = scene
        if f is None:
            return sc
        for field, value in traffic.fields(f).items():
            sc = replace_field(sc, field, torch.from_numpy(value).to(device))
        return sc
    return scene_at


def _count():
    k = 0
    while True:
        yield k
        k += 1


def _traced_readings(renderer, frames, scene, cfg, device, res, tracer, n):
    """The traced stretch's busy time, idle share and breakdown, the host
    time of its render calls, the atlas units re-rendered per frame after
    the window, and the eager frames' per-pass device times."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    # the render calls of the window outside the traced stretches (the
    # profiler slows every host call inside them)
    skip = tracer.frames() | {start + count for _, start, count, _ in tracer.plan}
    out = {"render_call_ms": [c * 1e3 for i, c in enumerate(res["calls_s"]) if i not in skip]}
    breakdown = None
    if "busy" in tracer.results:
        prof, wall = tracer.results["busy"]
        recs = tr_mod.records(prof)
        busy_us = tr_mod.union_length(tr_mod.device_intervals(recs))
        out.update(busy_s=busy_us * 1e-6, window_s=wall, stretch_frames=TRACE_FRAMES)
        breakdown = {"device_ops": tr_mod.device_ops(recs, float("-inf"), float("inf"))}
        if "host" in tracer.results:
            recs = tr_mod.records(tracer.results["host"][0])
            t0, t1 = tr_mod.host_range(recs, "bench.stretch")
            breakdown["idle_gaps"] = tr_mod.idle_gaps(recs, t0, t1)
        del recs
    if cfg["pipeline"].get("shadow_cache", True):
        out["units_per_frame"] = program.units_per_frame(renderer, frames,
                                                         range(n, n + UNIT_FRAMES))
    eager = program.make_renderer(scene, cfg, device, replay=False)
    cam, sc = frames.at(0)
    eager.render(cam, scene=sc)  # its first frame: lazy set-up outside the profile
    counts = []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof2:
        for k in range(EAGER_FRAMES):
            cam, sc = frames.at(k)
            eager.render(cam, scene=sc)
            counts.append(int(eager.state["draw_list"].count))
        if cuda:
            torch.cuda.synchronize(device)
    recs = tr_mod.records(prof2)
    per_pass = tr_mod.pass_device_us(recs)
    k1 = tr_mod.pass_device_us(recs, kernel=lambda name: any(k in name for k in KERNEL1))
    pc = cfg["pipeline"]
    out.update(pass_ms={p: us * 1e-3 / EAGER_FRAMES for p, us in per_pass.items()
                        if p is not None},
               k1_ms=k1.get("raster", 0.0) * 1e-3 / EAGER_FRAMES,
               k1_triangles=statistics.mean(counts), width=pc["width"], height=pc["height"],
               device_kind="cuda" if cuda else device.type)
    del eager, prof2, recs
    return out, breakdown
