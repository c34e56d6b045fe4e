"""Headline benchmark of the PyTorch + CUDA port: bench.py's Sponza-class
instanced scene at 1080p, on one NVIDIA GPU.

    python3 bench_torch.py                  # on the card, at bench.py's size
    python3 bench_torch.py --device cpu --instances 64 --width 128 --height 64 --frames 2 \\
        --bands 2 --shadow-size 128 --tri-capacity 2048 --band-capacity 2048  # tiny, CPU

Run from the root of the repository. Prints ONE JSON line, the last line
of its output, with the keys and rules of ``bench.result_line``
(``result_line`` below is the port's own copy, held to bench.py's by
tests/test_torch_bench.py); the metric is
``sponza_like_10000inst_1920x1088_fps_gpu``. It imports neither jax nor
the JAX package, nor bench.py.

What it times, as bench.py does: ``sponza_like_scene(10000)`` at
1920x1088, ``tri_capacity`` 131072, PBR with normal maps, edge AA,
bilinear; 30 frames of the orbit at angles 0.3 + 0.01k after one warm-up
frame (on the card the Renderer's default: the warm-up frame captures the
plan's CUDA graph and every timed frame is one replay, runtime/program.py), host clock with ``torch.cuda.synchronize()`` on both sides of the
timed loop (the counterpart of bench.py's one host fetch at each end), in
five tiers: base exact and checkerboard+fix, shadowed static exact and
checkerboard+fix, and shadowed dynamic (checkerboard+fix, shadow update
budget 1, 16 bands of caster capacity 131072, instance 1 moved every
frame, shadow_slots x bands + 1 warm-up frames). Then the minimum over the
three gate poses of display-clamped PSNR, checkerboard+fix against exact,
per tier (the 40 dB gate), shadow updates per frame from the Renderer's
cache over 8 more frames, the headline promotion, and the PSNR against
the committed goldens in assets/golden (read, never written).

On the card the frame takes kernel 1's tile raster, the counterpart of
bench.py's ``use_pallas=(platform == "tpu")``; on the CPU, which only a
test asks for (``--device cpu``), the plain configuration's scan raster,
which is what bench.py takes off a TPU. Nothing falls back to the CPU: a
run without a card fails unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

from renderer_tpu_torch.mathx import orbit_camera
from renderer_tpu_torch.models import sponza_like_scene
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.utils.image import read_png

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1088  # 1080p padded to the 16-row tile size
N_INSTANCES = 10000
TRI_CAPACITY = 1 << 17  # post-cull capacity (expansion capacity is 2x this)
FRAMES = 30
TARGET_FPS = 60.0
GATE_DB = 40.0
SHADOW_PROGRESSIVE = 16  # bands per directional slot, dynamic tier
SHADOW_BAND_CAPACITY = 131072  # casters per band render, dynamic tier
PROMOTE_SHADOWED_FPS = 30.0  # the dynamic shadowed tier becomes the headline past this
MOVER_INSTANCE = 1  # first non-floor instance: the scripted dynamic caster
UPDATE_FRAMES = 8  # frames over which shadow updates per frame are counted
GOLDEN_DIR = os.path.join(ROOT, "assets", "golden")


def gate_angles(frames: int) -> tuple:
    """The PSNR gate poses, spread over the timed orbit of ``frames``."""
    return (0.3, 0.3 + 0.005 * frames, 0.3 + 0.01 * (frames - 1))


GATE_ANGLES = gate_angles(FRAMES)


def make_camera(angle: float, aspect: float = WIDTH / HEIGHT, device=None):
    """The bench orbit's camera at ``angle`` (bench.make_camera's float32
    host formula), on ``device``."""
    return orbit_camera(angle, aspect, device)


def mover_tables(scene, ks, device) -> torch.Tensor:
    """(len(ks), N, 3) instance translations, one table per frame k of
    ``ks``: the scripted caster (instance MOVER_INSTANCE) at its frame-k
    position (bench._mover_scene), made on the host and copied once before
    any frame, so that no frame copies a table."""
    base = scene.instances.translation.cpu().numpy()
    tables = np.repeat(base[None], len(ks), axis=0)
    for i, k in enumerate(ks):
        tables[i, MOVER_INSTANCE] = (4.0 * math.sin(0.7 * k), 1.5 + 0.5 * math.sin(1.3 * k),
                                     4.0 * math.cos(0.7 * k))
    return torch.from_numpy(tables).to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure_mode(scene, cfg, device, shadows: bool, dynamic: bool = False, warmup: int = 1,
                  frames: int = FRAMES):
    """Timed orbit and gate-pose frames of one (config, shadows) mode.

    Returns (s per frame, {angle: display-clamped (H, W, 3) frame}), or
    with ``dynamic`` (s per frame, shadow updates per frame): the scripted
    caster moves every frame, so the cached atlas updates every frame."""
    renderer = Renderer(scene, cfg, outputs=("image",), device=device)
    if shadows:
        renderer.set_config(shadows=True)
        renderer.apply_config_now()
    aspect = cfg.width / cfg.height
    tables = mover_tables(scene, range(-warmup, frames + UPDATE_FRAMES), device) if dynamic else None

    def scene_at(k):
        if not dynamic:
            return None
        return scene._replace(instances=scene.instances._replace(translation=tables[k + warmup]))

    for w in range(warmup):  # converge the progressive atlas units
        renderer.render(make_camera(0.3, aspect, device), scene=scene_at(w - warmup))
    _sync(device)
    t0 = time.perf_counter()
    for k in range(frames):
        renderer.render(make_camera(0.3 + 0.01 * k, aspect, device), scene=scene_at(k))
    _sync(device)
    dt = (time.perf_counter() - t0) / frames

    if dynamic:
        updates = None
        if cfg.shadow_cache:
            # dirty units re-rendered per frame, from the cache signature
            # (outside the timed loop)
            sig_prev = renderer.state["shadow_cache"][1].clone()
            changed = []
            for k in range(frames, frames + UPDATE_FRAMES):
                renderer.render(make_camera(0.3 + 0.01 * k, aspect, device), scene=scene_at(k))
                sig = renderer.state["shadow_cache"][1]
                changed.append(int((sig != sig_prev).reshape(-1, sig.shape[-1]).any(dim=-1).sum()))
                sig_prev = sig.clone()
            updates = float(np.mean(changed))
        return dt, updates
    shots = {}
    for a in gate_angles(frames):
        img = renderer.render(make_camera(a, aspect, device))["image"]
        shots[a] = np.clip(img.cpu().numpy(), 0.0, 1.0)
    return dt, shots


def psnr_min(frames_a, frames_b) -> float:
    """MIN display-clamped PSNR across the gate poses."""
    worst = float("inf")
    for a in frames_a:
        mse = float(np.mean(np.square(frames_a[a] - frames_b[a])))
        worst = min(worst, 10.0 * math.log10(1.0 / max(mse, 1e-12)))
    return worst


def psnr_vs_golden(frames) -> float:
    """MIN PSNR of this run's shadowed frames against the committed golden
    set (shadowed_pose{i}.png at the gate poses, read with the port's PNG
    reader); -1.0 when a golden is missing or its shape differs."""
    worst = float("inf")
    for i, a in enumerate(frames):
        path = os.path.join(GOLDEN_DIR, f"shadowed_pose{i}.png")
        if not os.path.exists(path):
            return -1.0
        ref = read_png(path).astype(np.float32) / 255.0
        img = frames[a]
        if ref.shape != img.shape:
            return -1.0
        mse = float(np.mean(np.square(ref - img)))
        worst = min(worst, 10.0 * math.log10(1.0 / max(mse, 1e-12)))
    return worst


def result_line(platform, tri_count, dt, cb_dt, cb_psnr,
                sh_dt=None, sh_cb_dt=None, sh_psnr=None,
                dyn_dt=None, dyn_updates=None, golden_psnr=None, *,
                n_instances=N_INSTANCES, width=WIDTH, height=HEIGHT,
                bands=SHADOW_PROGRESSIVE, band_capacity=SHADOW_BAND_CAPACITY):
    """The JSON line, with bench.result_line's keys and rules.

    Within each tier the reported mode is checkerboard+fix when its
    min-over-poses PSNR against this run's exact frame passes the 40 dB
    gate, else the exact path; both modes' numbers are always present.
    Once the dynamic shadowed tier passes 30 FPS and the shadowed gate it
    becomes the headline ``value`` (``headline_tier``). The keyword
    arguments name the run's size in the metric and the dynamic tier's
    bands and capacity; their defaults are bench.py's."""
    fps = 1.0 / dt
    gate_ok = cb_psnr >= GATE_DB
    head_fps = (1.0 / cb_dt) if gate_ok else fps
    head_dt = cb_dt if gate_ok else dt
    out = {
        "metric": f"sponza_like_{n_instances}inst_{width}x{height}_fps_{platform}",
        "value": round(head_fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(head_fps / TARGET_FPS, 3),
        "mtris_per_sec": round(tri_count * head_fps / 1e6, 1),
        "visible_triangles": int(tri_count),
        "frame_ms": round(head_dt * 1e3, 2),
        "headline_tier": "base",
        "headline_mode": "checkerboard+fix" if gate_ok else "full",
        "shade_rate": "checkerboard+fix" if gate_ok else "full",
        "features": "normal_maps+edge_aa",
        "psnr_basis": "vs_exact_same_config_min_over_3_poses",
        "exact_path_fps": round(fps, 2),
        "exact_path_frame_ms": round(dt * 1e3, 2),
        "checkerboard_fix_fps": round(1.0 / cb_dt, 2),
        "checkerboard_fix_frame_ms": round(cb_dt * 1e3, 2),
        "checkerboard_fix_psnr_db_min": round(cb_psnr, 1),
    }
    sh_gate = False
    if sh_dt is not None:
        sh_gate = sh_psnr >= GATE_DB
        out.update({
            "shadowed_fps": round((1.0 / sh_cb_dt) if sh_gate else (1.0 / sh_dt), 2),
            "shadowed_frame_ms": round((sh_cb_dt if sh_gate else sh_dt) * 1e3, 2),
            "shadowed_mode": "checkerboard+fix" if sh_gate else "full",
            "shadowed_exact_fps": round(1.0 / sh_dt, 2),
            "shadowed_checkerboard_fix_fps": round(1.0 / sh_cb_dt, 2),
            "shadowed_psnr_db_min": round(sh_psnr, 1),
            # the static orbit's cache converges to no per-frame atlas work
            "shadowed_shadow_updates_per_frame": 0.0,
        })
    if dyn_dt is not None:
        dyn_fps = 1.0 / dyn_dt
        out.update({
            "shadowed_dynamic_fps": round(dyn_fps, 2),
            "shadowed_dynamic_frame_ms": round(dyn_dt * 1e3, 2),
            "shadow_updates_per_frame": (
                round(dyn_updates, 2) if dyn_updates is not None else None
            ),
            "shadow_progressive_bands": bands,
            "shadow_caster_capacity": band_capacity,
        })
        if sh_gate and dyn_fps >= PROMOTE_SHADOWED_FPS:
            out.update({
                "value": round(dyn_fps, 2),
                "vs_baseline": round(dyn_fps / TARGET_FPS, 3),
                "frame_ms": round(dyn_dt * 1e3, 2),
                "mtris_per_sec": round(tri_count * dyn_fps / 1e6, 1),
                "headline_tier": "shadowed_dynamic",
            })
    if golden_psnr is not None and golden_psnr > 0:
        out["psnr_vs_golden_db"] = round(golden_psnr, 1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--instances", type=int, default=N_INSTANCES)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--frames", type=int, default=FRAMES, help="timed frames per tier")
    ap.add_argument("--bands", type=int, default=SHADOW_PROGRESSIVE,
                    help="bands per directional slot in the dynamic tier")
    ap.add_argument("--shadow-size", type=int, default=PipelineConfig.shadow_size,
                    help="shadow atlas slot resolution (default the Renderer's)")
    ap.add_argument("--tri-capacity", type=int, default=TRI_CAPACITY,
                    help="triangles kept after the cull")
    ap.add_argument("--band-capacity", type=int, default=SHADOW_BAND_CAPACITY,
                    help="casters per band render in the dynamic tier")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (torch.cuda.is_available() is False); "
              "--device cpu runs the plain configuration on the CPU", file=sys.stderr)
        return 1
    platform = "gpu" if device.type == "cuda" else device.type
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    scene = sponza_like_scene(args.instances, device=device)
    cfg = PipelineConfig(
        width=args.width,
        height=args.height,
        tri_capacity=args.tri_capacity,
        tile_raster=device.type == "cuda",
        shading="pbr",
        enable_normal_maps=True,  # the scene carries normal maps
        aa="edge",                # the production AA tier, always on
        trilinear=False,          # bilinear + nearest mip
        shadow_size=args.shadow_size,
    )
    cfg_cb = dataclasses.replace(cfg, shade_rate="checkerboard", shade_fix=True)
    aspect = args.width / args.height

    # visible triangles for Mtris/s, averaged over the timed orbit's camera
    # range, one host read per probe frame outside any timed loop. bench.py
    # also counts tile bin-list overflows here; the port's bin lists have
    # no cap, so nothing can overflow and nothing is counted.
    probe = Renderer(scene, cfg, outputs=("soup",), device=device)
    counts = [int(probe.render(make_camera(0.3 + 0.01 * k, aspect, device))["soup"].count)
              for k in range(0, args.frames, max(1, args.frames // 5))]
    tri_count = float(np.mean(counts))
    del probe

    def measure(c, **kw):
        return _measure_mode(scene, c, device, frames=args.frames, **kw)

    # base tier (no shadows)
    dt_exact, frames_exact = measure(cfg, shadows=False)
    dt_cb, frames_cb = measure(cfg_cb, shadows=False)
    psnr_base = psnr_min(frames_exact, frames_cb)
    # shadowed static tier (the converged cache)
    dt_sh_exact, frames_sh_exact = measure(cfg, shadows=True)
    dt_sh_cb, frames_sh_cb = measure(cfg_cb, shadows=True)
    psnr_sh = psnr_min(frames_sh_exact, frames_sh_cb)
    # shadowed dynamic tier: one scripted moving caster, budget-1 band updates
    cfg_dyn = dataclasses.replace(cfg_cb, shadow_update_budget=1, shadow_progressive=args.bands,
                                  shadow_tri_capacity=args.band_capacity)
    n_units = cfg_dyn.shadow_slots * args.bands
    dt_dyn, dyn_updates = measure(cfg_dyn, shadows=True, dynamic=True, warmup=n_units + 1)
    golden_psnr = psnr_vs_golden(frames_sh_cb if psnr_sh >= GATE_DB else frames_sh_exact)

    print(json.dumps(result_line(
        platform, tri_count, dt_exact, dt_cb, psnr_base, dt_sh_exact, dt_sh_cb, psnr_sh,
        dyn_dt=dt_dyn, dyn_updates=dyn_updates, golden_psnr=golden_psnr,
        n_instances=args.instances, width=args.width, height=args.height, bands=args.bands,
        band_capacity=args.band_capacity)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
