"""Compare checkouts of this repository on one NVIDIA GPU, in turns.

    python3 chip_ab.py REFERENCE TREE [TREE ...] [--rounds 10]

Each argument is the root of a checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory). For every
round the script starts one process per checkout, in the given order on
even rounds and in reverse on odd ones, so that a drift of the host's
speed within the call falls on every checkout alike. Each process imports
the port (renderer_tpu_torch) from its checkout only, builds its kernels
and prints one JSON line with what chip_smoke.py measures at the bench
(sponza_like_scene(10000), orbit angle 0.3, 1920x1088, 131072 triangles):

- raster_ms: the raster kernel at the bench soup, CUDA events over 20
  calls; raster_device_us: its device time per call from torch.profiler;
- base_ms, rt_ms, shadowed_cb_ms: the base, the rt (rt_scale 2) and the
  shadowed static checkerboard+fix orbit (the shadows switch, cached
  512x512 atlas, bench.py's headline shading mode), host clock over 30
  frames after one warm-up; a checkout whose port has no shadows switch
  has no shadowed_cb metrics;
- base_busy_ms, rt_busy_ms, shadowed_cb_busy_ms: device busy time per
  frame over a window of 10 frames traced with device activity only;
- base_graph_ms, base_graph_busy_ms, shadowed_cb_graph_ms,
  shadowed_cb_graph_busy_ms: the same for the replayed frame (one CUDA
  graph per frame, runtime/program.py), where the checkout's Renderer has
  programs; the metrics above are then of its eager frame
  (``Renderer(replay=False)``), as in a checkout without programs.

Then, per checkout and metric, the runs and their median, and against the
first checkout the difference per round, its median and the rounds in
which the checkout read higher. Needs one card; imports no jax.
"""

import argparse
import dataclasses
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1088
N_INSTANCES = 10000
TRI_CAPACITY = 1 << 17
FRAMES = 30
PROFILE_FRAMES = 10
METRICS = ("raster_ms", "raster_device_us", "base_ms", "base_busy_ms", "rt_ms", "rt_busy_ms",
           "shadowed_cb_ms", "shadowed_cb_busy_ms", "base_graph_ms", "base_graph_busy_ms",
           "shadowed_cb_graph_ms", "shadowed_cb_graph_busy_ms")


def measure(tree: str) -> dict:
    """The metrics of the module docstring for the port in `tree`."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from renderer_tpu_torch.mathx import orbit_camera
    from renderer_tpu_torch.models import sponza_like_scene
    from renderer_tpu_torch.ops import cuda_build, geometry, occlusion_cuda as oc, raster_cuda as rc
    from renderer_tpu_torch.passes.pipeline import PipelineConfig
    from renderer_tpu_torch.runtime import Renderer

    if not rc.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"renderer_tpu_torch came from {rc.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build_all([rc.LIBRARY, oc.LIBRARY])

    def device_ms(fn, calls: int) -> float:
        """Device busy ms per call of fn (profiler, device activity only)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.key.startswith("forward.")
                   ) / 1e3 / calls

    def frame(renderer, k: int):
        return renderer.render(orbit_camera(0.3 + 0.01 * k, WIDTH / HEIGHT, dev))

    scene = sponza_like_scene(N_INSTANCES, device=dev)
    prepared = geometry.prepare_frame_columns(scene, orbit_camera(0.3, WIDTH / HEIGHT, dev))
    soup, _ = geometry.build_draw_stream(scene, prepared, 2 * TRI_CAPACITY, TRI_CAPACITY,
                                         WIDTH, HEIGHT)
    args = rc.raster_inputs(soup.clip, soup.valid, WIDTH, HEIGHT)
    kernel = lambda: rc.raster_kernel(*args, False)  # noqa: E731
    kernel()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        kernel()
    end.record()
    torch.cuda.synchronize()
    out = {"tree": tree, "raster_ms": start.elapsed_time(end) / 20,
           "raster_device_us": 1e3 * device_ms(kernel, 100)}

    cfg = PipelineConfig(width=WIDTH, height=HEIGHT, tri_capacity=TRI_CAPACITY,
                         enable_normal_maps=True, aa="edge", trilinear=False)
    tiers = [("base", cfg, {}), ("rt", dataclasses.replace(cfg, rt_scale=2), dict(rt=True))]
    if "shade_rate" in {f.name for f in dataclasses.fields(PipelineConfig)}:
        tiers.append(("shadowed_cb", dataclasses.replace(cfg, shade_rate="checkerboard"),
                      dict(shadows=True)))
    programs = "replay" in inspect.signature(Renderer).parameters
    kinds = [(name, c, switches, {"replay": False} if programs else {})
             for name, c, switches in tiers]
    if programs:
        kinds += [(f"{name}_graph", c, switches, {"replay": True})
                  for name, c, switches in tiers if name != "rt"]
    for name, c, switches, kw in kinds:
        renderer = Renderer(scene, c, device=dev, **kw)
        renderer.set_config(**switches)
        renderer.apply_config_now()
        frame(renderer, 0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(FRAMES):
            frame(renderer, k)
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / FRAMES
        window = iter(range(PROFILE_FRAMES + 1))
        out[f"{name}_busy_ms"] = device_ms(lambda: frame(renderer, next(window)), PROFILE_FRAMES)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="checkout roots; the first is the reference")
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--one", action="store_true", help="measure the one tree given and exit")
    opts = parser.parse_args()
    if opts.one:
        print(json.dumps(measure(opts.trees[0])), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = {t: [] for t in opts.trees}
    for r in range(opts.rounds):
        for tree in opts.trees if r % 2 == 0 else reversed(opts.trees):
            line = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                                  stdout=subprocess.PIPE, text=True, check=True).stdout.splitlines()[-1]
            print(f"round {r} {line}", flush=True)
            runs[tree].append(json.loads(line))
    ref = opts.trees[0]
    summary = {}
    for tree, rs in runs.items():
        summary[tree] = s = {}
        for m in METRICS:
            vals = [x[m] for x in rs if m in x]
            if not vals:
                continue
            s[m] = {"runs": vals, "median": statistics.median(vals)}
            if tree != ref and all(m in y for y in runs[ref]):
                diff = [x[m] - y[m] for x, y in zip(rs, runs[ref])]
                s[m].update(diff_median=statistics.median(diff),
                            rounds_higher=sum(d > 0 for d in diff), rounds=len(diff))
        print(f"{tree}: " + "; ".join(
            f"{m} median {v['median']:.4f}" + (f", minus {ref} per round median "
                                               f"{v['diff_median']:+.4f}, higher in "
                                               f"{v['rounds_higher']} of {v['rounds']}"
                                               if "diff_median" in v else "")
            for m, v in s.items()), flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
