"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA device, the
CUDA toolkit (nvcc) and g++. It imports neither jax nor the JAX package
(renderer_tpu). Phases, one line each; any failure raises and the exit
code is non-zero:

1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
   TF32 off for matmuls and cuDNN;
2. build the raster kernel from renderer_tpu_torch/csrc/raster.cu;
3. raster kernel against its plain PyTorch version on the test cases of
   tests/torch_raster_cases.py (bit-identical; the CPU tests hold the plain
   version to the float64 numpy reference rasterizer);
4. the bench frame's own soup (sponza_like_scene(10000), orbit angle 0.3,
   1920x1088, 131072 triangles): kernel against plain version, timed;
5. the main path: Renderer over the bench orbit, 1 warm-up frame and 30
   timed frames; per-pass times, the raster kernel's launch count, image
   checks, the last frame written to renderer_tpu_torch/_build/;
6. one frame of the main path with the kernel against the same frame with
   the plain raster version swapped in;
7. torch.profiler over the main path: the device's busy and idle share of
   one traced window (device activity only), then device and host time per
   pass in a second window that also traces the host.

Then one JSON line per kernel and, last, the JSON result line.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from renderer_tpu_torch.mathx import orbit_camera  # noqa: E402
from renderer_tpu_torch.models import sponza_like_scene  # noqa: E402
from renderer_tpu_torch.ops import geometry  # noqa: E402
from renderer_tpu_torch.ops import raster_cuda as rc  # noqa: E402
from renderer_tpu_torch.passes.pipeline import PipelineConfig  # noqa: E402
from renderer_tpu_torch.runtime import Renderer  # noqa: E402
from renderer_tpu_torch.utils.image import psnr, write_png  # noqa: E402
from torch_raster_cases import CASES  # noqa: E402

WIDTH, HEIGHT = 1920, 1088
N_INSTANCES = 10000
TRI_CAPACITY = 1 << 17
FRAMES = 30
PROFILE_FRAMES = 10
PSNR_GATE_DB = 60.0  # main path, kernel vs plain raster (display-clamped)
DEPTH_TOL = 1e-6  # kernel vs plain version (they should agree bit for bit)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of fn() over iters launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want) -> float:
    """Kernel vs plain outputs (depth, tri_id, b0, b1): tri_id identical,
    the rest within DEPTH_TOL. Returns the max abs float difference."""
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"tri_id differs on {(got[1] != want[1]).sum().item()} pixels")
    err = max((got[i] - want[i]).abs().max().item() for i in (0, 2, 3))
    if err > DEPTH_TOL:
        raise AssertionError(f"kernel vs plain float error {err}")
    return err


def traced_window(renderer, dev, activities):
    """Render PROFILE_FRAMES orbit frames under torch.profiler. Returns the
    profile and the window's host-clock ms per frame."""
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(PROFILE_FRAMES):
            renderer.render(orbit_camera(0.3 + 0.01 * k, WIDTH / HEIGHT, dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_FRAMES
    return prof, wall_ms


def profile_main_path(renderer, dev, card: str) -> None:
    """Device busy time against wall time in one traced window, and per-pass
    device and host time in a second window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    prof, wall_ms = traced_window(renderer, dev, [ProfilerActivity.CUDA])
    device_ops = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.key.startswith("forward.")]
    busy_ms = sum(e.self_device_time_total for e in device_ops) / 1e3 / PROFILE_FRAMES
    ops = sum(e.count for e in device_ops) / PROFILE_FRAMES
    if busy_ms > 0:
        share = (f"device busy {busy_ms:.3f} ms/frame in a {wall_ms:.3f} ms/frame traced window "
                 f"= idle {100.0 * (1.0 - busy_ms / wall_ms):.1f}%, {ops:.0f} device ops/frame")
    else:
        share = "device time not measured (the profiler saw no device activity)"
    prof, wall_ms = traced_window(renderer, dev, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    passes = {e.key[len("forward."):]: (e.device_time_total / 1e3 / PROFILE_FRAMES,
                                        e.cpu_time_total / 1e3 / PROFILE_FRAMES)
              for e in prof.key_averages()
              if e.key.startswith("forward.") and e.device_type == DeviceType.CPU}
    per_pass = ", ".join(f"{k} {d:.3f}/{h:.3f}" for k, (d, h) in passes.items())
    phase("profile", f"{PROFILE_FRAMES} frames ({card}): {share}; host+device traced window "
                     f"{wall_ms:.3f} ms/frame, per pass device/host ms/frame: {per_pass}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. card identity -------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("card", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | TF32 off (matmul, cuDNN)")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    rc.raster_kernel.load()
    ptxas = [ln.strip() for ln in rc.raster_kernel.build_log.splitlines() if "registers" in ln]
    phase("build", f"raster.cu loaded in {time.perf_counter() - t0:.2f} s; {' '.join(ptxas)}")

    # 3. kernel vs plain on the test cases --------------------------------------
    worst = 0.0
    for name, (build, w, h, cull) in sorted(CASES.items()):
        clip, valid = build()
        args = rc.raster_inputs(torch.from_numpy(clip).to(dev), torch.from_numpy(valid).to(dev),
                                w, h, cull)
        for with_bary in (True, False):
            worst = max(worst, compare(rc.raster_kernel(*args, with_bary),
                                       rc.raster_tiles_plain(*args, with_bary)))
    phase("cases", f"{len(CASES)} cases x bary on/off: tri_id identical, max float err {worst:.1e}")

    # 4. the bench frame's soup ---------------------------------------------
    t0 = time.perf_counter()
    scene = sponza_like_scene(N_INSTANCES, device=dev)
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    prepared = geometry.prepare_frame_columns(scene, orbit_camera(0.3, WIDTH / HEIGHT, dev))
    soup, _ = geometry.build_draw_stream(scene, prepared, 2 * TRI_CAPACITY, TRI_CAPACITY,
                                         WIDTH, HEIGHT)
    args = rc.raster_inputs(soup.clip, soup.valid, WIDTH, HEIGHT)
    counts = args[3]
    kernel_ms = cuda_ms(lambda: rc.raster_kernel(*args, False), 20)
    full_ms = cuda_ms(lambda: rc.rasterize_cuda(soup.clip, soup.valid, WIDTH, HEIGHT,
                                                with_bary=False), 10)
    got = rc.raster_kernel(*args, False)
    t0 = time.perf_counter()
    want = rc.raster_tiles_plain(*args, False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bench_err = compare(got, want)
    phase("bench_soup", f"scene built in {t_scene:.1f} s; {int(soup.count)} triangles; bins "
                        f"mean {counts.float().mean().item():.1f} max {int(counts.max())} blocks/tile; "
                        f"kernel {kernel_ms:.3f} ms, setup+binning+kernel {full_ms:.3f} ms, "
                        f"plain {plain_ms:.1f} ms; tri_id identical, max float err {bench_err:.1e} "
                        f"({card})")

    # 5. main path ------------------------------------------------------------
    cfg = PipelineConfig(width=WIDTH, height=HEIGHT, tri_capacity=TRI_CAPACITY,
                         enable_normal_maps=True, aa="edge", trilinear=False)
    renderer = Renderer(scene, cfg, outputs=("image", "vis", "soup"), device=dev)
    rc.raster_kernel.launches = 0
    out = renderer.render(orbit_camera(0.3, WIDTH / HEIGHT, dev))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(FRAMES):
        out = renderer.render(orbit_camera(0.3 + 0.01 * k, WIDTH / HEIGHT, dev))
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    launches = rc.raster_kernel.launches
    frames = FRAMES + 1
    if launches != frames:
        raise AssertionError(f"raster kernel launched {launches} times for {frames} frames")
    visible = int(out["soup"].count)
    img = out["image"].cpu().numpy()
    coverage = float((out["vis"].tri_id >= 0).float().mean())
    brightness = float(np.clip(img, 0.0, 1.0).mean())
    if not np.isfinite(img).all() or img.shape != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"image not finite or wrong shape {img.shape}")
    if coverage <= 0.30 or brightness <= 0.05:
        raise AssertionError(f"coverage {coverage:.3f} or brightness {brightness:.3f} too low")
    os.makedirs(rc.BUILD_DIR, exist_ok=True)
    write_png(os.path.join(rc.BUILD_DIR, "chip_smoke_frame.png"), np.clip(img, 0.0, 1.0))
    passes = renderer.pass_timings(orbit_camera(0.3 + 0.01 * (FRAMES - 1), WIDTH / HEIGHT, dev))
    phase("main_path", f"{frame_ms:.2f} ms/frame = {1e3 / frame_ms:.2f} FPS over {FRAMES} frames "
                       f"({card}); {visible} visible triangles; raster launches {launches} = "
                       f"frames {frames}; coverage {coverage:.3f}, mean {brightness:.3f}; pass ms "
                       + json.dumps({k: round(v, 3) for k, v in passes.items()}))

    # 6. main path, kernel vs plain raster ------------------------------------
    cam = orbit_camera(0.3, WIDTH / HEIGHT, dev)
    ref_out = Renderer(scene, cfg, device=dev).render(cam)
    kernel = rc.raster_kernel
    rc.raster_kernel = rc.raster_tiles_plain  # the plain version on CUDA tensors
    try:
        plain_out = Renderer(scene, cfg, device=dev).render(cam)
    finally:
        rc.raster_kernel = kernel
    if not torch.equal(ref_out["vis"].tri_id, plain_out["vis"].tri_id):
        raise AssertionError("main path tri_id differs between kernel and plain raster")
    frame_psnr = psnr(np.clip(ref_out["image"].cpu().numpy(), 0, 1),
                      np.clip(plain_out["image"].cpu().numpy(), 0, 1))
    if frame_psnr < PSNR_GATE_DB:
        raise AssertionError(f"main path PSNR kernel vs plain {frame_psnr:.1f} dB")
    phase("main_vs_plain", f"tri_id identical; display-clamped PSNR "
                           f"{'inf' if math.isinf(frame_psnr) else f'{frame_psnr:.1f}'} dB")

    # 7. profile ----------------------------------------------------------------
    profile_main_path(renderer, dev, card)

    print(json.dumps({"kernels": [{
        "name": "raster_tiles", "route": "cuda",
        "source": "renderer_tpu_torch/csrc/raster.cu",
        "replaces": "renderer_tpu/ops/raster_pallas.py:373",
        "launches": launches, "max_abs_err": bench_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
