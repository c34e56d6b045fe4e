"""The frame trace (``utils/profiling.py``) over the benchmark's cells on the
card: what the port's own spans and counters read in a cell's window, what
the trace costs, and whether its stamps sit on the profiler's clock.

    python3 scripts/frame_trace_cells.py --workload <cell> --seeds 1,2 --seconds 51 --mode on
    python3 scripts/frame_trace_cells.py --workload <cell> --seeds 1,2 --seconds 51 --mode ab

Each seed is one window of the cell as ``benchmark/run.py`` renders it (its
scene, traffic, set-up frames and closed loop, 2 frames in flight, through
``benchmark/harness``), in this process:

- ``--mode on``: the window with the frame trace on (from the first set-up
  frame) and two stretches of ``STRETCH`` frames under the profiler (host
  and card), one from window frame ``STRETCH_AT`` and one at the window's
  end. Prints the trace's readings over the window's frames outside the
  stretches and the frame after each (``profiling.metrics``, the names the
  benchmark's readers would give them; the harness does not turn the
  trace on yet), the render calls over ``HITCH_MS``
  with the host spans of their frame, and per stretch how far each stamp,
  mapped onto the profiler's clock (by anchors inside the stretch), lies
  from its own stamp kernel's interval in the profile. Writes the per-frame
  record to ``<out>/<cell>.<seed>.json`` (``--out``, by default
  ``frame_trace_out/`` in the checkout, which git ignores).
- ``--mode ab``: two renderers of the cell, the trace off and on, taking
  turns in blocks of ``BLOCK`` frames until each has rendered ``--seconds``:
  the trace's cost as the blocks' frame times, on against off, each pair
  under the same conditions of the card.

One JSON line per run on standard output, last. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.run import cache_env  # noqa: E402

IN_FLIGHT = 2
STRETCH_AT = 40       # window frame where the first profiled stretch starts
STRETCH = 8           # frames a profiled stretch holds
END_S = 0.6           # the second stretch starts this many seconds before the window's end
HITCH_MS = 100.0      # a render call at least this long is a hitch
BLOCK = 256           # frames a renderer renders in turn in --mode ab


def setup(cell_name: str, seed: int, device, trace: int):
    from benchmark.harness import cell, program

    wl, cfg, scene, traffic, n_setup = cell.inputs(cell_name, seed, device)
    frames = program.Frames(scene, traffic.device_tables(device), traffic)
    renderer = program.make_renderer(scene, cfg, device)
    if trace:
        renderer.trace_frames(trace)
    clock = program.Clock(device)
    program.run_frames(renderer, frames, range(-n_setup, 0), clock, IN_FLIGHT)
    return renderer, frames, clock


def alignment(prof, record, frame_ids) -> dict:
    """Each stamp of ``frame_ids`` against its own stamp kernel in the
    profile (the k-th stamp in time against the k-th stamp kernel of the
    frames, the anchors' left out): how far, in us, the stamp lies outside
    the kernel's interval, taken onto the profile's clock by the anchors
    inside it (``profile_offsets``: ``fitted``) and as read (``nominal``);
    and the host's ``launch`` spans against the profile's
    ``cudaGraphLaunch`` calls (the call's start after the span's)."""
    from renderer_tpu_torch.utils import profiling

    path = os.path.join(tempfile.mkdtemp(), "stretch.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    os.remove(path)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name", "").startswith(profiling.ANCHOR_RANGE)]
    in_anchor = {e["args"].get("correlation") for e in events if e.get("cat") == "cuda_runtime"
                 and any(lo <= e["ts"] <= hi for lo, hi in ranges)}
    kernels = sorted((base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3) for e in events
                     if e.get("cat") == "kernel" and "stamp_kernel" in e.get("name", "")
                     and e.get("args", {}).get("correlation") not in in_anchor)
    stamps = sorted({t for f in frame_ids for span in record["device"][0].get(f, {}).values()
                     for t in span})  # a boundary between two spans is one stamp
    offsets = profiling.profile_offsets(doc, record)
    out = {"stamps": len(stamps), "stamp_kernels": len(kernels), "anchors_in_profile":
           len(offsets["host"])}
    per_launch = {}
    for e in events:
        if e.get("cat") == "kernel" and "stamp_kernel" in e.get("name", ""):
            c = e.get("args", {}).get("correlation")
            per_launch[c] = per_launch.get(c, 0) + 1
    detail = {"stamp_kernels_per_launch": sorted(per_launch.values()),
              "offsets": {k: [[t, o - t] for t, o in v] for k, v in offsets.items()}}
    if kernels and len(kernels) == len(stamps):
        fitted = profiling.to_profile(stamps, offsets.get(record["shards"][0], []))
        for name, ts in (("nominal", stamps), ("fitted", fitted)):
            errs = [max(0.0, lo - t, t - hi) * 1e-3 for t, (lo, hi) in zip(ts, kernels)]
            out[name] = {"max_us": max(errs), "median_us": statistics.median(errs)}
            detail[name] = [round((t - lo) * 1e-3, 2) for t, (lo, hi) in zip(ts, kernels)]
        out["kernel_us"] = statistics.median((hi - lo) * 1e-3 for lo, hi in kernels)
    out["detail"] = detail
    graph = sorted(base + e["ts"] * 1e3 for e in events
                   if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaGraphLaunch")
    spans = sorted(b for f, name, b, e in record["host"] if name == "launch" and f in frame_ids)
    if graph and len(graph) == len(spans):
        lead = [(g - t) * 1e-3 for g, t in
                zip(graph, profiling.to_profile(spans, offsets["host"]).tolist())]
        out["launch_call_after_span_us"] = [min(lead), statistics.median(lead), max(lead)]
    return out


def run_on(cell_name: str, seed: int, seconds: float, out_dir: str, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import program
    from renderer_tpu_torch.utils import profiling

    capacity = 1 << 13
    t0 = time.perf_counter()
    renderer, frames, clock = setup(cell_name, seed, device, capacity)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)  # the profiler's own start-up, before the window
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    stretches, open_ = [], []
    state = {"start": None}

    def on_frame(i, k):
        now = time.perf_counter()
        if state["start"] is None:
            state["start"] = now
        if open_ and i == open_[0][1] + STRETCH:
            close(i)
        late = now - state["start"] >= seconds - END_S and len(stretches) + len(open_) == 1
        if not open_ and (i == STRETCH_AT or late):
            if i > 0:
                clock.wait(marks["marks"][i - 1])
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            renderer.frame_trace.anchor()
            open_.append((prof, i))

    def close(i):
        prof, first = open_.pop()
        clock.wait(marks["marks"][i - 1])
        renderer.frame_trace.anchor()
        prof.stop()
        stretches.append((prof, first, i))

    marks = {}
    since = renderer.frame_trace.counters()
    res = program.run_frames(renderer, frames, iter(range(1 << 30)), clock, IN_FLIGHT,
                             seconds=seconds, on_frame=on_frame, marks_out=marks)
    if open_:
        close(res["frames"])
    torch.cuda.synchronize(device)
    record = renderer.frame_trace.read()
    n = res["frames"]
    first = record["counters"]["frames"] - n  # the window's first frame id
    skip = {i for _, a, b in stretches for i in range(a, b + 1)}
    window = [first + i for i in range(n) if i not in skip]
    summary = profiling.summary(record, window, since)
    comp = [clock.between_ms(res["start"], m) for m in res["marks"]]
    intervals = [b - a for a, b in zip([0.0] + comp, comp)]
    calls = [c * 1e3 for c in res["calls_s"]]
    hitches = []
    for i, c in enumerate(calls):
        if c >= HITCH_MS:
            f = first + i
            hitches.append({"frame": i, "call_ms": c, "host": [
                [name, (e - b) * 1e-6] for g, name, b, e in record["host"] if g == f]})
    align = [dict(alignment(prof, record, [first + i for i in range(a, b)]), first_frame=a)
             for prof, a, b in stretches]
    details = [a.pop("detail") for a in align]
    names = sorted({nm for f in window for per in record["device"] for nm in per.get(f, {})})
    per_frame = {"interval_ms": intervals, "call_ms": calls, "skip": sorted(skip),
                 "span_ms": {nm: [] for nm in names}, "gap_ms": [], "host_ms": {}}
    prev = None
    for i in range(n):
        spans = record["device"][0].get(first + i, {})
        bounds = profiling.frame_bounds(record, first + i)
        per_frame["gap_ms"].append(None if prev is None or bounds is None
                                   else (bounds[0] - prev) * 1e-6)
        prev = bounds[1] if bounds else None
        for nm in names:
            s = spans.get(nm)
            per_frame["span_ms"][nm].append(None if s is None else round((s[1] - s[0]) * 1e-6, 5))
    for g, name, b, e in record["host"]:
        if g >= first:
            per_frame["host_ms"].setdefault(name, {})[g - first] = round((e - b) * 1e-6, 5)
    sub = [sum(record["device"][0][f][s][1] - record["device"][0][f][s][0]
               for s in ("shadow.lights", "shadow.signature", "shadow.slots", "shadow.stack"))
           / (record["device"][0][f]["shadow_pass"][1] - record["device"][0][f]["shadow_pass"][0])
           for f in window if "shadow_pass" in record["device"][0].get(f, {})]
    line = {"cell": cell_name, "seed": seed, "mode": "on", "frames": n,
            "frame_ms": res["wall_s"] * 1e3 / n, "setup_s": setup_s,
            "metrics": profiling.metrics(record, window, since),
            "host_ms": summary["host_ms"], "device_ms": summary["device_ms"],
            "cover_pct_min": summary["cover_pct"],
            "shadow_subspans_share": [min(sub), max(sub)] if sub else None,
            "alignment": align, "hitches": hitches, "drift_ppm": record["drift_ppm"],
            "counters": record["counters"],
            "card": torch.cuda.get_device_name(device)}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{cell_name}.{seed}.json"), "w") as f:
        json.dump({"line": line, "per_frame": per_frame, "alignment": details}, f)
    return line


def run_ab(cell_name: str, seed: int, seconds: float, device) -> dict:
    import torch

    from benchmark.harness import program

    both = {"off": setup(cell_name, seed, device, 0), "on": setup(cell_name, seed, device, 1 << 13)}
    ks = {name: 0 for name in both}
    blocks = {name: [] for name in both}
    spent = {name: 0.0 for name in both}
    while min(spent.values()) < seconds:
        for name, (renderer, frames, clock) in both.items():
            res = program.run_frames(renderer, frames, range(ks[name], ks[name] + BLOCK), clock,
                                     IN_FLIGHT)
            ks[name] += BLOCK
            spent[name] += res["wall_s"]
            blocks[name].append(res["wall_s"] * 1e3 / res["frames"])
    torch.cuda.synchronize(device)
    pairs = [b - a for a, b in zip(blocks["off"], blocks["on"])]
    off, on = statistics.median(blocks["off"]), statistics.median(blocks["on"])
    q = statistics.quantiles(pairs, n=4) if len(pairs) > 1 else [pairs[0]] * 3
    return {"cell": cell_name, "seed": seed, "mode": "ab", "blocks": len(pairs),
            "frame_ms_off": off, "frame_ms_on": on, "cost_pct": 100.0 * (on - off) / off,
            "paired_ms_quartiles": q, "paired_cost_pct": 100.0 * q[1] / off,
            "blocks_off": blocks["off"], "blocks_on": blocks["on"],
            "card": torch.cuda.get_device_name(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--mode", choices=("on", "ab"), default="on")
    ap.add_argument("--out", default=os.path.join(ROOT, "frame_trace_out"))
    args = ap.parse_args(argv)
    cache_env()
    import torch

    if not torch.cuda.is_available():
        print("frame_trace_cells: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode == "on":
            line = run_on(args.workload, seed, args.seconds, args.out, device)
        else:
            line = run_ab(args.workload, seed, args.seconds, device)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
