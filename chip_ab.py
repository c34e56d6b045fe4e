"""Compare checkouts of this repository on one NVIDIA GPU, in turns, on
what no benchmark cell measures.

    python3 chip_ab.py REFERENCE TREE [TREE ...] [--rounds 10] [--kernels]

Each argument is the root of a checkout (for example the parent commit,
unpacked with `git archive` into a git-ignored directory). For every
round the script starts one process per checkout, in the given order on
even rounds and in reverse on odd ones, so that a drift of the host's
speed within the call falls on every checkout alike. Each process imports
the port (renderer_tpu_torch) from its checkout only, builds its kernels
and prints one JSON line:

- raster_ms: the raster kernel at the bench soup (sponza_like_scene(10000),
  orbit angle 0.3, 1920x1088, 131072 triangles), CUDA events over 20
  calls; raster_device_us: its device time per call from torch.profiler;
- scan_camera_ms, scan_bench_ms: kernel 5 (the count-bounded scan raster)
  per call inside a captured graph of 100 calls (chip_smoke's
  ``graph_ms_per_call``), at the camera soup of the JAX demo's mixed
  scene at 512x512 (tri_capacity 16384, angle 0.5) and at the plain bench
  frame's camera soup; scan_reference_ms: so at the mixed frame's
  reference view (128x128); scan_sun_ms, scan_faces_ms: so at the sun slot
  of the mixed frame's shadow atlas with its point light in slot 1
  (512x512), and the six cube faces' calls (256x128) summed; rt_brute_ms:
  kernel 6 (the brute-force rt) so at the mixed scene's rt soup (rt_scale
  2), each soup recorded from the checkout's own eager plain frame;
- plain_graph_ms (not with --kernels): the plain configuration's replayed
  bench frame (``tile_raster=False``: kernel 5 rasterizes it), host clock
  over 30 frames after one warm-up.

The benchmark (benchmark/run.py) measures the tile paths' frames in its
cells. Then, per checkout and metric, the runs and their median, and
against the first checkout the difference per round, its median and the
rounds in which the checkout read higher. Needs one card; imports no jax.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1088
N_INSTANCES = 10000
TRI_CAPACITY = 1 << 17
FRAMES = 30
METRICS = ("raster_ms", "raster_device_us", "scan_camera_ms", "scan_bench_ms",
           "scan_reference_ms", "scan_sun_ms", "scan_faces_ms", "rt_brute_ms", "plain_graph_ms")
DEMO_SIZE, DEMO_CAPACITY = 512, 16384  # the JAX demo's mixed scene, as chip_smoke phase 36
POINT_SLOT = 1  # the shadow slot chip_smoke phase 36 gives the mixed scene's point light


def measure(tree: str, frames: bool = True) -> dict:
    """The metrics of the module docstring for the port in `tree` (without
    `frames`, the kernel metrics only)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from renderer_tpu_torch.demo import build_scene, make_camera
    from renderer_tpu_torch.mathx import orbit_camera
    from renderer_tpu_torch.models import sponza_like_scene
    from renderer_tpu_torch.ops import cuda_build, geometry, occlusion_cuda as oc
    from renderer_tpu_torch.ops import raster_cuda as rc, raster_scan as rs, rt as brute
    from renderer_tpu_torch.ops import shadow as tshadow
    from renderer_tpu_torch.passes import pipeline
    from renderer_tpu_torch.passes.pipeline import PipelineConfig
    from renderer_tpu_torch.runtime import Renderer

    if not rc.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"renderer_tpu_torch came from {rc.__file__}, not from {tree}")
    # chip_smoke.py's timers and recorder, from beside this script (the port
    # stays the checkout's, whose package is imported above)
    sys.path.insert(0, HERE)
    from chip_smoke import Recorder, cuda_ms, device_us_by_kernel, graph_ms_per_call

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build_all([rc.LIBRARY, oc.LIBRARY, rs.LIBRARY, brute.LIBRARY])

    def calls_of(module, name: str, render) -> list:
        """The (args, kwargs, result) of each call of module.name in render()."""
        with Recorder(module, name) as rec:
            render()
        return rec.calls

    def scan_ms(call) -> float:
        (clip, valid, w, h), kw, _ = call
        inp = rs.scan_inputs(clip, valid, w, h, kw.get("cull_backface", True))
        tb = min(128, clip.shape[0])
        return graph_ms_per_call(lambda: rs.scan_raster_kernel(inp, kw.get("count"), w, h, tb,
                                                               kw.get("with_bary", True)))

    scene = sponza_like_scene(N_INSTANCES, device=dev)
    prepared = geometry.prepare_frame_columns(scene, orbit_camera(0.3, WIDTH / HEIGHT, dev))
    soup, _ = geometry.build_draw_stream(scene, prepared, 2 * TRI_CAPACITY, TRI_CAPACITY,
                                         WIDTH, HEIGHT)
    args = rc.raster_inputs(soup.clip, soup.valid, WIDTH, HEIGHT)
    kernel = lambda: rc.raster_kernel(*args, False)  # noqa: E731
    out = {"tree": tree, "raster_ms": cuda_ms(kernel, 20),
           "raster_device_us": sum(device_us_by_kernel(kernel, 100).values())}

    cfg = PipelineConfig(width=WIDTH, height=HEIGHT, tri_capacity=TRI_CAPACITY,
                         enable_normal_maps=True, aa="edge", trilinear=False)
    plain_cfg = dataclasses.replace(cfg, tile_raster=False)
    mixed, mixed_cam = build_scene("mixed", dev), make_camera("mixed", 0.5, dev)
    demo_cfg = PipelineConfig(width=DEMO_SIZE, height=DEMO_SIZE, tri_capacity=DEMO_CAPACITY,
                              tile_raster=False)

    def soups(scene_, cfg_, cam, module=pipeline, **switches) -> list:
        """The scan raster calls of one eager plain frame."""
        r = Renderer(scene_, cfg_, device=dev, replay=False)
        r.set_config(**switches)
        r.apply_config_now()
        return calls_of(module, "rasterize_scan", lambda: r.render(cam))

    out["scan_camera_ms"] = scan_ms(soups(mixed, demo_cfg, mixed_cam)[0])
    out["scan_bench_ms"] = scan_ms(soups(scene, plain_cfg, orbit_camera(0.3, WIDTH / HEIGHT,
                                                                      dev))[0])
    out["scan_reference_ms"] = scan_ms(soups(mixed, demo_cfg, mixed_cam,
                                             reference_image=True)[1])
    lit = build_scene("mixed", dev)
    lit.lights.shadow_slot[0] = POINT_SLOT
    sun, *faces = soups(lit, demo_cfg, mixed_cam, tshadow, shadows=True)
    out["scan_sun_ms"] = scan_ms(sun)
    out["scan_faces_ms"] = sum(scan_ms(face) for face in faces)
    rt_r = Renderer(mixed, dataclasses.replace(demo_cfg, rt_scale=2), device=dev, replay=False)
    rt_r.set_config(rt=True)
    rt_r.apply_config_now()
    (world, normal, direction, tri, tri_valid, count), _, _ = calls_of(
        brute, "ray_shadow_directional", lambda: rt_r.render(mixed_cam))[0]
    b_inp = brute.brute_inputs(world, normal, direction, tri, tri_valid)
    out["rt_brute_ms"] = graph_ms_per_call(lambda: brute.rt_brute_kernel(b_inp, count,
                                                                         world.shape[2]))
    if not frames:
        return out
    renderer = Renderer(scene, plain_cfg, device=dev)
    renderer.render(orbit_camera(0.3, WIDTH / HEIGHT, dev))  # warm-up and capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(FRAMES):
        renderer.render(orbit_camera(0.3 + 0.01 * k, WIDTH / HEIGHT, dev))
    torch.cuda.synchronize()
    out["plain_graph_ms"] = (time.perf_counter() - t0) * 1e3 / FRAMES
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="checkout roots; the first is the reference")
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--one", action="store_true", help="measure the one tree given and exit")
    parser.add_argument("--kernels", action="store_true", help="the kernel metrics only")
    opts = parser.parse_args()
    if opts.one:
        print(json.dumps(measure(opts.trees[0], frames=not opts.kernels)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    runs = {t: [] for t in opts.trees}
    for r in range(opts.rounds):
        for tree in opts.trees if r % 2 == 0 else reversed(opts.trees):
            line = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]
                                  + ["--kernels"] * opts.kernels,
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
