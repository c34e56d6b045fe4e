"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --split-cards 2 4

Run from the root of the repository, on a machine with a CUDA device, the
CUDA toolkit (nvcc) and g++. It imports neither jax nor the JAX package
(renderer_tpu). Phases, one line each; any failure raises and the exit
code is non-zero:

1. card identity (nvidia-smi name and power limit, torch and CUDA versions);
   TF32 off for matmuls and cuDNN;
2. build every kernel from renderer_tpu_torch/csrc/ (raster.cu,
   occlusion.cu, probe.cu, scan_raster.cu, rt_brute.cu, shade.cu, and
   graph_cond.cu, the conditional nodes of the captured frames; one nvcc each, started
   together), with ptxas's registers and spills;
3. raster kernel against its plain PyTorch version on the test cases of
   tests/torch_raster_cases.py (bit-identical; the CPU tests hold the plain
   version to the float64 numpy reference rasterizer);
4. occlusion kernel against its plain version on the cases of
   tests/torch_occlusion_cases.py, at the default segment length and at
   one-block segments (identical planes; the CPU tests hold the plain
   version to JAX and a float64 brute force);
5. the two kernels on no path (add_one, transpose) against x + 1 and
   x.T.contiguous(), timed at (8, 128) and (262144, 36) in turns (add_one
   over 7 rounds, the median kept), and add_one's launch path piece by
   piece (host us per call over 10^4 calls, the kernel's device time from
   torch.profiler) beside x + 1;
6. the bench frame's own soup (sponza_like_scene(10000), orbit angle 0.3,
   1920x1088, 131072 triangles): raster kernel against plain version, timed;
   its work counted from its inputs (mask bits per tile, triangles per
   pixel region, the (pixel, triangle) pairs inside the padded bboxes that
   set its bound, beside the mask-bit count of the earlier bound), and the
   kernel timed with the bin lists of the heaviest tile alone, of the ten
   heaviest, and of none;
7. the main path: Renderer over the bench orbit, 1 warm-up frame and 30
   timed frames; the raster kernel's launch count, image checks, the last
   frame written to renderer_tpu_torch/_build/; then per-pass device times
   from the frame trace over 8 more replayed frames (trace on, a capture
   left out; trace off, a capture without the stamps);
8. one frame of the main path with the raster kernel against the same
   frame with the plain raster version swapped in;
9. torch.profiler over the main path: the device's busy time in one traced
   window (device activity only) and its idle share against as many
   untraced frames, then device and host time per pass in a second window
   of eager frames that also traces the host (a pass's device time
   is that of the work launched inside its range, matched through the
   profiler's correlation ids, kernels launched through ctypes included);
10. the rt path's occlusion inputs at the bench camera (slot 0, the sun)
    for rt_scale 2, 1 and 4: kernel against plain version, bin lists, caster
    total against capacity, kernel / setup+binning+kernel / plain times,
    the kernel's share of its bound, its work items, the hit casters it
    stages against the casters listed, and its time per segment length;
11. the rt main path (the rt switch, rt_scale 2, 4 shadow slots): 1
    warm-up and 30 timed frames, occlusion launches = frames x traced
    slots, image checks, darker than the rt-off frame; PNG to _build/;
    per-pass device times as in phase 7;
12. one rt frame with the occlusion kernel against the same frame with its
    plain version swapped in: identical planes and images;
13. the profile of phase 9 over the rt main path;
14. the shadow atlas's raster views at the bench camera (slot 0, the sun, a
    512x512 slot and its 512x32 band of most casters): caster demand
    against capacity, bin-list entries, kernel against plain version (depth
    and ids identical), the kernel's time and its bound;
15. bench.py's timed tiers besides phase 7's: base checkerboard+fix,
    shadowed static exact and checkerboard+fix, and shadowed dynamic
    (checkerboard+fix, budget 1, 16 bands, one scripted moving caster, 65
    warm-up frames): ms/frame, launches (the raster kernel once per frame
    and once per atlas view), shadow updates per frame from the Renderer's
    state over 8 more frames (0 on the static tier, in (0, 1] on the
    dynamic one); the shadowed frame's PNG to _build/;
16. image quality: the minimum over bench.py's gate poses of display-clamped
    PSNR, checkerboard+fix against exact, base and shadowed; the mode
    bench.result_line would report; PSNR against the committed goldens
    (printed, not enforced, as in bench.py);
17. the shadowed checkerboard frame with aa none: its shaded lattice and
    every pixel the fix changed equal the exact frame bit for bit;
18. the shadowed checkerboard+fix frame with the plain raster in both the
    camera and the atlas pass: image identical;
19. the profile of phase 9 over the shadowed checkerboard+fix frame;
20. the city canyon (city_scene(20), scripts/prof_scale.py's street walk
    of 20 frames after one warm-up, PBR without normal maps, edge AA,
    bilinear): frustum culling at tri_capacity 2^18 and occlusion culling
    at 2^16 (or the smallest power of two whose expansion holds the
    steady demand): per frame the expansion demand and soup.count,
    ms/frame, and the profile of phase 9 over each;
21. held pose: one pose of the walk rendered twice with occlusion culling
    against once without, at a capacity that holds its demand: the same
    visible (instance, library triangle) on >= 99.9% of pixels and
    display-clamped PSNR >= 50 dB; the raster kernel at that occluded
    soup against its plain version, timed, with its bound;
22. freeze culling on the bench frame: frozen after one culled frame, the
    frozen frame at the freeze pose has the unfrozen frame's tri_id and
    PSNR >= 50 dB against it; soup.count constant over the orbit,
    ms/frame, the profile of phase 9;
23. the debug-AABB view on the bench frame: 12 box triangles per visible
    instance, the raster kernel with barycentrics at that unsorted soup
    against its plain version on a band of rows, timed, with its bound;
    ms/frame;
24. cluster culling on the bench frame: coverage identical to the frame
    without it and the image within 2e-6 (the JAX package's gate), the
    share of clusters culled, ms/frame in turns against the plain frame;
25. the bench frame with skinning on (the pose pass over the vertex pool,
    nothing skinned, so the whole cull takes the per-corner path): the
    pose pass's device ms and peak memory, ms/frame, the raster kernel at
    the per-corner soup against its plain version (depth and ids
    identical), the frame with the plain raster swapped in (image
    identical), the profile of phase 9;
26. the skinned scene (skinned_scene) at 1920x1088 over 30 frames of its
    1 s clip: the pose moves and the image changes on every frame;
27. the quarter shade rate with its fix at the bench: ms/frame, the
    profile, the minimum over the gate poses of PSNR against exact, and
    with aa none the shaded (even, even) lattice and every fixed pixel
    equal to the exact frame bit for bit;
28. SSAA 2 with aa none at the bench (3840x2176 inside): ms/frame, the
    profile, the raster kernel at that frame's soup against its plain
    version on a band of rows;
29. Lambert shading at the bench: ms/frame, the profile;
30. the demo (python -m renderer_tpu_torch.demo) in subprocesses, started
    together: every scene (colonnade included), glb:assets/colonnade.glb,
    and --hud, --reference-image, --ssaa 2, --shade-rate quarter, --shadows
    --rt, --dump-graphs and --watch; each exits 0, writes its PNG under
    renderer_tpu_torch/_build/ and renders its frames after the first under
    --check-sync (no blocking sync);
31. the committed assets/colonnade.glb through load_gltf against its twin
    colonnade_scene(): every table equal (five rotations within the one ulp
    of the node-matrix round trip), one pose of the demo's orbit rendered
    from each (away from those five instances tri_id identical and the
    image within 1e-6; over the frame the visible triangle equal on
    >= 99.9% of pixels and PSNR >= 50 dB), the orbit's 30 frames after a
    warm-up with the profile of phase 9, the frame with the plain raster
    swapped in (identical), kernel 1 at the colonnade soup;
32. streaming into the live bench scene (2^18 vertices and triangles, 256
    meshes, texture slots): a SceneStreamer with a page-locked Arena and
    budget 8 takes colonnade.glb by path, 23 of its instances by callables,
    a uv_sphere(64, 96) chunked past CHUNK_VERTS and four 512x512 textures,
    every pump and frame under sync-debug "error"; uploads and chunks per
    frame, ms/frame over 10 poses of the orbit against the same poses
    without a streamer, in turns;
    each streamed mesh's vertex, index and tri_rec rows and each texture
    layer read back equal to the host's, streamed instances on screen, no
    arena block live after close(), the plain raster swapped in
    (identical), kernel 1 at the streamed soup;
33. AutoCapacityRenderer over the city walk of phase 20 (three laps,
    check_every 2, the default ladder): tier, demand and count at each
    check, the host ms of each blocking check, no frame of the last lap
    above its tier's expansion capacity, the last lap's ms/frame against
    phase 20's fixed 2^18 frustum walk;
34. the bench frame with 32 projectile slots stepped before each frame
    under sync-debug "error", the camera controller driving 30 frames, the
    streamed renderer checkpointed and loaded into a fresh one (the next
    frame identical), and the HUD's fps, arena and streaming lines;
35. a KernelReloader on the bench renderer: one watched ops module and
    csrc/raster.cu touched, contents unchanged: poll() swaps, the frame
    after equals the frame before, kernel 1 counts on in the same
    CudaKernel; the reload's host ms;
36. the plain configuration (PipelineConfig(tile_raster=False): the scan
    rasterizer, raster barycentrics, brute-force rt) on the JAX demo's
    scenes (box, spheres, mixed, textured, skinned) at 512x512 and
    tri_capacity 16384, 3 orbit frames each, and on textured and mixed one
    shadowed, one rt and one checkerboard+fix frame: every frame under
    sync-debug "error", ms/frame and device busy of one more traced frame
    beside its soup.count, the shadowed frame against the scene's
    unshadowed one, the same frames on the CPU path (device "cpu") against
    the card's (visible triangle equal on >= 99.9% of pixels, PSNR >= 50
    dB, >= 40 for rt, shadowed and skinned), the launches of each run
    counted from 0 (kernel 5 once per frame and per atlas view, kernel 6
    once per rt frame and traced slot, kernels 1-4 never), the textured
    frame against the tile frame (the JAX package's
    tests/test_pipeline.py:117 gate); render_forward on mixed against its
    CPU path; the bench rt frame at rt_scale 2 and 4 against 1 (the
    minimum over the gate poses of PSNR, reported against the 40 dB gate,
    not enforced); mixed with its point light in a shadow slot through
    kernel 2 (each cube face against the plain version, the frame with the
    plain walk swapped in identical); the brute-force lit plane against
    the grid's at rt_scale 1 on mixed, as a PSNR; and the demo with
    --scan-raster --rt (exit 0, its PNG written);
37. kernel 5, the count-bounded scan raster (csrc/scan_raster.cu), against
    its plain version bit for bit (depth, tri_id, barycentrics): on the
    raster cases with and without the backface cull at counts 0, 1, 127,
    128, 129 and the capacity, on the edge cases of its design
    (tests/torch_plain_kernel_cases.py) at their counts, and at the
    camera, reference-view and atlas soups (the sun's slot, the point
    light's cube faces) of phase 36's mixed frame and the plain bench
    frame's camera soup (1920x1088, orbit angle 0.3; its plain version run
    once on the whole image) at their own counts, where the bounded result
    also equals the unbounded one; the launches of a plain and a tile frame
    with the reference view; per soup the design's sizes (region, warps per
    area, cell, list capacity), the kernel's time, the plain version's and
    the bound (the pairs inside the walked triangles' bboxes);
38. kernel 6, the count-bounded brute-force rt (csrc/rt_brute.cu), with its
    design's sizes, against its plain version on the edge cases of its
    design and at phase 36's mixed rt soup, rt_scale 2 and 1, at counts 0,
    129 and the frame's (identical planes), timed beside its bound (the
    pairs the early exit leaves); kernels 5 and 6 are timed per
    call inside a captured graph of 100 calls (the kernels line's ms), by
    CUDA events around single calls and by the profiler; at the main
    path's soup also by a graph of one call, and under the profiler in a
    replay of the graph of 100 and over 100 eager calls (device events
    seen, their mean, first start to last end);
39. bench_torch.py in a subprocess: exit 0, its last line one JSON object
    with bench.result_line's keys and a _gpu metric, printed;
40. the split frame (renderer_tpu_torch/parallel) over make_mesh([card] * 2),
    two shards of 1920x544 rows on the one card, in bench.py's base exact,
    base checkerboard+fix, shadowed static checkerboard+fix and rt tiers,
    each through four Renderers: the eager single and split frames
    (replay=False) and the replayed ones (the default: a captured graph
    per shard and stretch between collectives for the split frame). Per
    tier: the replayed split frame against the eager split frame (outputs
    and state) and the replayed single frame (image and visibility
    buffer) bit for bit over 3 frames, the first its capture; the eager
    split frame against the eager single one (covered mask equal, max abs
    difference <= 2e-6, the JAX package's gate; and whether tri_id is
    equal too); ms/frame of the four in turns (3 frames a turn eager, 10
    replayed), each under sync-debug "error"; device busy of each over 2
    traced frames (per card) and idle against its untraced ms (the busiest
    card's); the replayed split
    program's capture seconds, pool and graph replays per frame; the
    launches per frame of each path, counted from 0 (each split path's
    twice its single path's: each shard rasterizes its rows and makes the
    atlas whole); kernel 1 at shard 1's
    rows (y0 = 544) of the gathered soup (its valid mask segmented by
    shard) and of the same soup in the cull's order (the frame's), and
    kernel 2 at shard 1's receivers, against their plain versions bit for
    bit, and kernel 1's rows equal to shard 1's visibility buffer;
41. one CUDA graph replay per frame (runtime/program.py): for every
    captured tier at the bench frame (GRAPH_TIERS) and the plain
    configuration's 512x512 orbit of the JAX demo's scenes, an eager and a
    replayed Renderer in lockstep (image, visibility buffer and state
    equal bit for bit), ms/frame of both in turns, their device busy and
    idle (against the untraced ms), the program's capture seconds and
    pool ([graph_<tier>]); then
    the shadow pass's device time at no update with and without
    conditional nodes, and a fresh base path's launches ([graph]);
42. the reference's shadow envelope (scripts/prof_shadow_amort.py and
    prof_shadow_envelope.py on the port): the bench scene with 16
    directional lights (models.shadow_envelope_lights), 16 slots of
    4096x4096 in 16 bands of 4096x256, budget 1, two shaded lights,
    checkerboard+fix. A replayed Renderer over 256 unit frames and 2 more
    (one unit a frame, then none; the ms of the first 8 and the last 4; no
    NaN signature), 20 steady frames (ms, kernel 1 for the camera only,
    busy and idle over a traced window, the atlas copies' bytes and device
    ms, capture, pool, state), light 7 moved (the next 16 frames render
    exactly its slot's 16 bands) and orbiting for 20 frames (at most one
    band a frame), the shadow pass at no update and the signatures' ms, the
    profile of phase 9 with shade's device ms against phase 19's
    ([envelope], [envelope_profile]); an eager and a replayed Renderer in
    lockstep over 4 frames and a moved-light frame (image, vis, state bit
    for bit); the cold envelope (render_shadow_atlas_per_light over the 16
    whole slots at 2^16 casters a slot: ms over 5 calls, 16 launches a
    call, coverage, caster demand per slot); kernel 1 against its plain
    version bit for bit at the band of most casters and at its rows of the
    whole slot's view, each timed in a graph of 100 calls beside its bound;
    the phase's peak allocated memory ([envelope_cold]).
43. kernel 7, the shading core (ops/pbr.py shade_samples_kernel,
    csrc/shade.cu), run after phase 38, at the benchmark's configurations
    (SHADE_CONFIGS: sponza10k_1080p and envelope16x4096, their scene and
    pipeline written out): every call of one eager frame (the checkerboard
    lattice, the fix's batch) against its plain version bit for bit, timed
    in a graph of 100 calls, by events and on the device beside its bound
    (shade_bound) and the plain version's time in a graph; the device ops
    of the frame's shade_pbr call: the ATen ops it dispatches equal those
    of the same call with the core's results given but kernel 7's
    wrapper's allocation and view (no op of the plain core is left), one
    replay's device ops by name under the profiler, both calls' times in
    a graph; launches per replayed frame ([shade]).

Every Renderer on the card replays one captured graph per
frame after its switch set's first frame (the capture), so the timed
paths above are replayed; a frame whose kernel calls are recorded, or
that runs with a plain version swapped in, is rendered eagerly
(``Renderer(replay=False)``), and the per-pass windows of the profile
phases render eager frames (a replay runs no pass's range).

Every main path runs with every kernel's launch count set to 0 just
before it and read just after (the raster kernel once per frame and per
atlas view, the occlusion kernel once per rt frame and traced slot, on
the plain paths kernels 5 and 6 in their stead, kernel 7 as often per
frame as ``shades`` says of the path's configuration, the kernels of no
path never). Then a line of each path kernel's launches per path, each
phase's host seconds, the run's total seconds, one JSON
line listing every kernel, the card's name and power limit, and, last,
the JSON result line.

With ``--split-cards N [N ...]`` the script runs phases 1 and 2 and then
phase 40 only, once for each N over ``make_mesh`` of the first N cards
(one shard per card, its line ``[split_<N>_cards]``), and needs N cards.
"""

import argparse
import bisect
import ctypes
import dataclasses
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from renderer_tpu_torch.demo import build_scene as build_demo_scene  # noqa: E402
from renderer_tpu_torch.demo import make_camera as make_demo_camera, no_blocking_sync  # noqa: E402
from renderer_tpu_torch.mathx import Camera, orbit_camera, quat_from_axis_angle, quat_mul  # noqa: E402
from renderer_tpu_torch.models import (  # noqa: E402
    city_scene, colonnade_scene, shadow_envelope_lights, skinned_scene, sponza_like_scene)
from renderer_tpu_torch.models.scenes import _colonnade_lights, colonnade_spec  # noqa: E402
from renderer_tpu_torch.ops import control, cuda_build, geometry, occlusion_cuda as oc  # noqa: E402
from renderer_tpu_torch.ops import probe_cuda, raster_cuda as rc, rt_grid as trt  # noqa: E402
from renderer_tpu_torch.ops import raster_scan as rs, rt as brute  # noqa: E402
from renderer_tpu_torch.ops import shadow as tshadow  # noqa: E402
from renderer_tpu_torch.ops import pbr as tpbr  # noqa: E402
from renderer_tpu_torch.ops.pbr import fix_capacity, quarter_fix_capacity  # noqa: E402
from renderer_tpu_torch.ops.skin import pose_scene  # noqa: E402
from renderer_tpu_torch.ops.shadow import directional_light_matrices  # noqa: E402
from renderer_tpu_torch.passes import pipeline as pipeline_module  # noqa: E402
from renderer_tpu_torch.passes.pipeline import PipelineConfig  # noqa: E402
from renderer_tpu_torch.runtime import AutoCapacityRenderer, KernelReloader, Renderer  # noqa: E402
from renderer_tpu_torch.runtime.allocator import Arena  # noqa: E402
from renderer_tpu_torch.runtime.camera_controller import CameraState, InputFrame  # noqa: E402
from renderer_tpu_torch.runtime.camera_controller import step as controller_step  # noqa: E402
from renderer_tpu_torch.runtime.camera_controller import to_camera  # noqa: E402
from renderer_tpu_torch.runtime.checkpoint import load_renderer, save_renderer  # noqa: E402
from renderer_tpu_torch.runtime.frame import light_casts  # noqa: E402
from renderer_tpu_torch.runtime.gameplay import ProjectileSystem  # noqa: E402
from renderer_tpu_torch.runtime.hud import format_hud  # noqa: E402
from renderer_tpu_torch.ops.overlay import hud_overlay  # noqa: E402
from renderer_tpu_torch.runtime.streaming import CHUNK_VERTS, SceneStreamer  # noqa: E402
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives  # noqa: E402
from renderer_tpu_torch.scene.gltf import load_gltf  # noqa: E402
from renderer_tpu_torch.utils import tree  # noqa: E402
from renderer_tpu_torch.utils.compile_cache import enable_persistent_cache  # noqa: E402
from renderer_tpu_torch.utils.image import psnr, read_png, resize_bilinear_u8, write_png  # noqa: E402
from renderer_tpu_torch.utils.profiling import FrameStats, span_ms  # noqa: E402
from torch_occlusion_cases import CASES as OCCLUSION_CASES  # noqa: E402
from torch_plain_kernel_cases import BRUTE_CASES, RASTER_CASES  # noqa: E402
from torch_raster_cases import CASES  # noqa: E402

WIDTH, HEIGHT = 1920, 1088
N_INSTANCES = 10000
TRI_CAPACITY = 1 << 17
FRAMES = 30
PROFILE_FRAMES = 3  # per traced window; the profiler's processing, not the frames, takes the time
PASS_FRAMES = 8  # replayed frames under the frame trace, for the main paths' per-pass ms
PSNR_GATE_DB = 60.0  # main path, kernel vs plain version (display-clamped)
DEPTH_TOL = 1e-6  # raster kernel vs plain version (they should agree bit for bit)
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_PAIR = 25  # FP32 operations per (pixel or receiver, triangle) pair tested
# pixel regions (width, height) whose triangles phase 6 counts: the 32x4 strip
# a warp covered when one CTA walked a whole tile's mask, and the kernel's
# 8x8 region
REGION_SHAPES = ((32, 4), (8, 8))
REC_BYTES_READ = (rc.R_TL + 3) * 4  # record columns 0..21: all a pixel's test reads
HOT_TILES = 10  # phase 6 times the kernel on the heaviest tile alone and on these many
LAUNCH_CALLS = 10_000  # calls per piece of the launch-path breakdown
PROBE_ROUNDS = 7  # rounds of add_one, its plain version and x + 1, timed in turns
SEGMENT_SWEEP = (1, 8, 16, 32, 64)  # occlusion segment lengths timed in phase 10
RT_SCALES = (2, 1, 4)  # phase 10's receiver grids
# bench.py's shadowed tiers and quality gate (bench.py:43-59, 102, 257-265)
GATE_ANGLES = (0.3, 0.3 + 0.005 * FRAMES, 0.3 + 0.01 * (FRAMES - 1))
GATE_DB = 40.0
SHADOW_PROGRESSIVE = 16  # bands per directional slot, dynamic tier
SHADOW_BAND_CAPACITY = 131072  # casters per band render, dynamic tier
MOVER_INSTANCE = 1  # the dynamic tier's scripted moving caster
UPDATE_FRAMES = 8  # frames over which shadow updates per frame are counted
# scripts/prof_scale.py's city: the grid, the walk's frames, the capacities it
# pairs with frustum and with occlusion culling
CITY_GRID = 20
CITY_FRAMES = 20
CITY_CAPACITY = 1 << 18
CITY_OCC_CAPACITY = 1 << 16
DEBUG_BAND_ROWS = 16  # rows of the box soup on which the plain raster is compared
SSAA = 2
SSAA_BAND_ROWS = 64  # rows of the SSAA frame on which the plain raster is compared
SKIN_FRAMES = 30  # frames of the skinned scene's 1 s clip
DEMO_SIZE = 512
DEMO_TIMEOUT_S = 300
DEMO_RUNS = {  # name -> demo arguments besides --size, --out, --frames, --check-sync
    **{scene: ("--scene", scene) for scene in ("box", "spheres", "mixed", "textured", "skinned",
                                               "city")},
    "hud": ("--scene", "textured", "--hud"),
    "reference_image": ("--scene", "textured", "--reference-image"),
    "ssaa2": ("--scene", "mixed", "--ssaa", "2"),
    "quarter": ("--scene", "textured", "--shade-rate", "quarter"),
    "shadows_rt": ("--scene", "mixed", "--shadows", "--rt"),
    "dump_graphs": ("--scene", "box", "--dump-graphs"),
    "colonnade": ("--scene", "colonnade"),
    "glb": ("--scene", "glb:assets/colonnade.glb"),
    "watch": ("--scene", "box", "--watch"),
}
# phase 36, the plain configuration: the JAX demo's scenes, size and capacity
PLAIN_SCENES = ("box", "spheres", "mixed", "textured", "skinned")
PLAIN_CAPACITY = 16384
PLAIN_FRAMES = 3  # orbit frames per scene after a warm-up
PLAIN_SWITCH_SCENES = ("textured", "mixed")
PLAIN_SWITCHES = {  # name -> (config changes, runtime switches), one frame each
    "shadows": ({}, dict(shadows=True)),
    "rt": ({}, dict(rt=True)),
    "checkerboard_fix": (dict(shade_rate="checkerboard"), {}),
}
PLAIN_DB = 50.0  # the CPU path against the card (PERF.md section 2)
PLAIN_DB_LOOSE = 40.0  # rt, shadowed and skinned frames
PLAIN_DEMO = ("--scene", "textured", "--scan-raster", "--rt")
POINT_SLOT = 1  # the shadow slot phase 36 gives the mixed scene's point light
BRUTE_SCENE = "mixed"
SCAN_COUNTS = (0, 1, 127, 128, 129)  # phase 37's counts on the raster cases, and the capacity
BRUTE_COUNTS = (0, 129)  # phase 38's counts, and the frame's own
SCAN_BYTES_PER_TRI = 80  # the setup kernel 5 reads per walked triangle (ScanInputs)
BRUTE_BYTES_PER_TRI = 53  # the setup kernel 6 reads per walked triangle (BruteInputs)
BENCH_TIMEOUT_S = 600
# bench.result_line's keys with every tier given (bench.py:361-398); the
# golden key is present when the goldens' shape matches the frame
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "mtris_per_sec", "visible_triangles", "frame_ms",
    "headline_tier", "headline_mode", "shade_rate", "features", "psnr_basis", "exact_path_fps",
    "exact_path_frame_ms", "checkerboard_fix_fps", "checkerboard_fix_frame_ms",
    "checkerboard_fix_psnr_db_min", "shadowed_fps", "shadowed_frame_ms", "shadowed_mode",
    "shadowed_exact_fps", "shadowed_checkerboard_fix_fps", "shadowed_psnr_db_min",
    "shadowed_shadow_updates_per_frame", "shadowed_dynamic_fps", "shadowed_dynamic_frame_ms",
    "shadow_updates_per_frame", "shadow_progressive_bands", "shadow_caster_capacity")
BENCH_GOLDEN_KEY = "psnr_vs_golden_db"
# phase 40: the split frame over two shards of the card, in bench.py's tiers
GRAPH_CALLS = 100  # calls per captured graph (graph_ms_per_call: kernels 5 and 6)
SHADE_FRAMES = 8  # replayed frames over which phase 43 counts kernel 7's launches
SHADE_PLAIN_CALLS = 3  # plain calls per captured graph in phase 43
SHADE_PASS_CALLS = 10  # shade_pbr calls per captured graph in phase 43
SHADE_WRAPPER_OPS = {"empty", "permute"}  # ATen ops of shade_samples_kernel: its output, vp_inv's .T
# FP32 operations of the plain formulas per covered sample, kernel 7's bound
# (phase 43): the unprojection, attributes, geometric normal, view vector and
# ambient (123); barycentrics from the records (18); a base-colour tap set
# (wrap, lod, four taps of three channels and their weights) with sRGB and
# the base factor (67); the normal map's frame, tap set, mapped normal and
# Toksvig (139); trilinear's second tap set (56 each); a live light's
# direction, attenuation and GGX + Lambert (136); a shadow-map lookup with
# its offset, projection, bias and 2x2 PCF (100)
SHADE_OPS = dict(base=123, records=18, albedo=67, normal_map=139, trilinear=56, light=136,
                 shadow=100)
SHADE_SAMPLE_BYTES = 20  # depth and id read, the colour written
SHADE_RECORD_BYTES = 180  # the 45 record columns read, once per distinct triangle
GRAPH_CALL_REPLAYS = 10  # replays of it timed
SPLIT_SHARDS = 2
SPLIT_TIERS = {  # name -> (config changes, switches)
    "base_exact": ({}, {}),
    "base_checkerboard_fix": (dict(shade_rate="checkerboard"), {}),
    "shadowed_static_checkerboard_fix": (dict(shade_rate="checkerboard"), dict(shadows=True)),
    "rt": ({}, dict(rt=True)),
}
SPLIT_FRAMES = 10  # timed replayed frames per tier, path and turn
SPLIT_EAGER_FRAMES = 3  # timed eager frames per tier, path and turn
SPLIT_CHECK_FRAMES = 3  # lockstep frames, the replayed split against the eager split and single
SPLIT_PROFILE_FRAMES = 2  # frames per traced window
SPLIT_ATOL = 2e-6  # split against single-shard image (tests/test_parallel.py's gate)
# phase 39: bench_torch's base exact tier in a fresh process, before and
# after one traced window of torch.profiler (host and device activity)
PROFILED_BENCH = """
import torch
from torch.profiler import ProfilerActivity, profile
import bench_torch as b
from renderer_tpu_torch.models import sponza_like_scene
from renderer_tpu_torch.passes.pipeline import PipelineConfig
dev = torch.device("cuda")
scene = sponza_like_scene(b.N_INSTANCES, device=dev)
cfg = PipelineConfig(width=b.WIDTH, height=b.HEIGHT, tri_capacity=b.TRI_CAPACITY,
                     enable_normal_maps=True, aa="edge", trilinear=False)
before = b._measure_mode(scene, cfg, dev, shadows=False)[0]
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    b._measure_mode(scene, cfg, dev, shadows=False, frames=5)
after = b._measure_mode(scene, cfg, dev, shadows=False)[0]
print(before * 1e3, after * 1e3)
"""
# phase 41: replay against eager per captured tier (name -> (config changes,
# switches)); the shadowed dynamic tier takes cfg_dyn, freeze its switch
# after a culled frame, hud an overlay per frame
GRAPH_TIERS = {
    "base_exact": ({}, {}),
    "base_checkerboard_fix": (dict(shade_rate="checkerboard"), {}),
    "quarter_fix": (dict(shade_rate="quarter"), {}),
    "ssaa2": (dict(ssaa=SSAA, aa="none"), {}),
    "lambert": (dict(shading="lambert", aa="none"), {}),
    "skinned": (dict(skinning=True), {}),
    "rt_scale1": (dict(rt_scale=1), dict(rt=True)),
    "rt_scale2": ({}, dict(rt=True)),
    "rt_scale4": (dict(rt_scale=4), dict(rt=True)),
    "shadowed_static_exact": ({}, dict(shadows=True)),
    "shadowed_static_checkerboard_fix": (dict(shade_rate="checkerboard"), dict(shadows=True)),
    "shadowed_dynamic": ({}, dict(shadows=True)),
    "freeze": ({}, dict(freeze_culling=True)),
    "debug_aabbs": ({}, dict(debug_aabbs=True)),
    "occlusion": ({}, dict(occlusion_culling=True)),
    "cluster_cull": (dict(cluster_cull=True), {}),
    "reference_image": ({}, dict(reference_image=True)),
    "hud": ({}, dict(hud=True)),
    "plain_bench": (dict(tile_raster=False), {}),
}
GRAPH_CHECK_FRAMES = 3  # lockstep frames, eager against replayed (the first captures)
GRAPH_FRAMES = 5  # frames per timed turn
GRAPH_PROFILE_FRAMES = 2  # frames per traced window
GRAPH_SHADOW_REPLAYS = 20  # replays per timed turn of the cut plans
# phase 42: the reference's shadow envelope (shadow_mapping.rs:22-24), as the
# JAX package runs it (scripts/prof_shadow_amort.py:37-160,
# scripts/prof_shadow_envelope.py:27-76)
ENVELOPE_SLOTS = 16
ENVELOPE_SIZE = 4096
ENVELOPE_BANDS = 16  # bands of 4096x256
ENVELOPE_LIMITS = dict(max_instances=16384, max_vertices=1 << 16, max_triangles=1 << 16,
                       max_materials=64, max_lights=ENVELOPE_SLOTS)
ENVELOPE_LIGHT = 7  # the light that moves, then orbits
# phase 43: the benchmark's configurations (benchmark/configs/), written out:
# name -> (scene limits, envelope lights (0: the scene's own), pipeline options
# beside the main path's); each renders with shadows on
SHADE_CONFIGS = {
    "sponza10k_1080p": (None, 0, dict(shadow_slots=4, shadow_size=512,
                                      shadow_tri_capacity=TRI_CAPACITY)),
    "envelope16x4096": (ENVELOPE_LIMITS, ENVELOPE_SLOTS,
                        dict(shade_light_slots=2, shadow_slots=ENVELOPE_SLOTS,
                             shadow_size=ENVELOPE_SIZE, shadow_tri_capacity=0)),
}
SHADE_OPTIONS = dict(shade_rate="checkerboard", shade_fix=True, shadow_cache=True,
                     shadow_update_budget=1, shadow_progressive=16)
ENVELOPE_MOVED = (0.1, -1.0, 0.6)
ENVELOPE_STEADY = 20  # timed frames with every unit clean
ENVELOPE_ORBIT = 20  # frames with light 7 moving every frame
ENVELOPE_LOCKSTEP = 4  # eager against replayed frames, then one moved-light frame
ENVELOPE_COLD_CAPACITY = 1 << 16  # casters per slot of the cold envelope
ENVELOPE_COLD_CALLS = 5
ENVELOPE_COLD_ANGLE = 0.35
ENVELOPE_SIG_CALLS = 10  # signature calls per captured graph
# kernel 8's FP32 multiplies, adds and compares (|x| is an operand modifier):
SIGNATURE_PLANE_OPS = 13  # a box against one plane: dist, rr, dist + rr < 0
SIGNATURE_SLOT_OPS = 45 + 3 * 36  # a (live slot, instance): the world box, three profiles
SIGNATURE_FOLD_OPS = 2 * 3  # a (unit, instance): vis x profile added, per component
SIGNATURE_PLANE_ORDER = (2, 3, 0, 1, 4, 5)  # the order kernel 8 tests a frustum's planes in
SIGNATURE_BITS = 20  # instances a signature component spells, one bit each (exact in float32)
SIGNATURE_INSTANCE_BYTES = 64 + 4 + 1 + 36  # model row, mesh id, alive, 9 fold weights
ASSET = os.path.join(ROOT, "assets", "colonnade.glb")
COLONNADE_CAPACITY = 1 << 16  # expansion 2^17 holds the asset's 36k triangles
COLONNADE_FRAMES = 30
STREAM_LIMITS = dict(max_instances=16384, max_vertices=1 << 18, max_triangles=1 << 18,
                     max_meshes=256, max_materials=64, max_lights=4, max_textures=64)
STREAM_BUDGET = 8
STREAM_FRAMES = 10  # bench poses per turn; the uploads land in the first four
STREAM_TEXTURES = 4  # 512x512 images, resized to the atlas's 256
STREAM_ARENA_BYTES = 64 << 20
STREAM_GLB_INSTANCES = 23  # colonnade_spec instances 1..23, streamed by callables
AUTOCAP_CHECK_EVERY = 2
AUTOCAP_LAPS = 3  # the city walk's CITY_FRAMES poses, three times
PROJECTILES = 32
CONTROLLER_FRAMES = 30
RELOAD_MODULE = "renderer_tpu_torch.ops.shading"  # a watched ops module touched in phase 35
GOLDEN_DIR = os.path.join(ROOT, "assets", "golden")
# every kernel wrapper's launcher (launches are counted there), checked path by path
KERNELS = (rc.RASTER_TILES, oc.OCCLUSION_TILES, probe_cuda.ADD_ONE, probe_cuda.TRANSPOSE,
           rs.SCAN_RASTER, brute.RT_BRUTE, tpbr.SHADE, tshadow.SIGNATURE)


PHASE_SECONDS = {}  # phase -> host seconds from the previous phase's line to its own
PASS_PROFILES = {}  # profile phase -> its per-pass device ms per frame (profile_main_path)
_phase_clock = [time.perf_counter()]


def phase(name: str, msg: str) -> None:
    now = time.perf_counter()
    PHASE_SECONDS[name] = round(now - _phase_clock[0], 2)
    _phase_clock[0] = now
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


def captured(fn, calls: int):
    """A CUDA graph of ``calls`` calls of fn, after one warm-up; the calls'
    launches are not counted as launches."""
    fn()
    before = {k: k.launches for k in KERNELS}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=control.own_stream(torch.cuda.current_device(),
                                                           "timing")):
        for _ in range(calls):
            fn()
    for k, n in before.items():
        k.launches = n
    return graph


def graph_ms_per_call(fn, calls: int = GRAPH_CALLS, replays: int = GRAPH_CALL_REPLAYS) -> float:
    """Device ms per call of fn: CUDA events around ``replays`` replays of
    one captured CUDA graph of ``calls`` calls, over their count. No
    wrapper's host path lies in it (a replay calls none), unlike
    ``cuda_ms``."""
    graph = captured(fn, calls)
    ms = cuda_ms(graph.replay, replays) / calls
    graph.reset()
    return ms


def device_events(run, calls: int) -> tuple:
    """The device events (kernels, memsets, copies) of run() under
    torch.profiler: their number, mean ms, and the span from the first
    one's start to the last one's end over ``calls``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if not events:
        return 0, math.nan, math.nan
    span = max(e.end_ns() for e in events) - min(e.start_ns() for e in events)
    return (len(events), sum(e.duration_ns() for e in events) / len(events) / 1e6,
            span / 1e6 / calls)


def call_readings(fn, calls: int = GRAPH_CALLS) -> str:
    """What sets fn's time a call (phases 37-38): a graph of one call
    replayed ``calls`` times (CUDA events, ms a replay), and under
    torch.profiler one replay of a graph of ``calls`` calls and ``calls``
    eager calls, each as ``device_events`` reads it."""
    graph = captured(fn, calls)
    in_replay = device_events(graph.replay, calls)
    graph.reset()
    one = captured(fn, 1)
    one_ms = cuda_ms(one.replay, calls)
    one.reset()
    eager = device_events(lambda: [fn() for _ in range(calls)], calls)
    return (f"a graph of 1 call {one_ms:.5f} ms a replay; profiled, one replay of a graph of "
            f"{calls} calls: {in_replay[0]} device events, {in_replay[1]:.5f} ms each, first "
            f"start to last end {in_replay[2]:.5f} ms a call; {calls} eager calls: "
            f"{eager[0]} device events, {eager[1]:.5f} ms each, first start to last end "
            f"{eager[2]:.5f} ms a call")


def host_us_per_call(fn, calls: int = LAUNCH_CALLS) -> float:
    """Host-clock us per call of fn over `calls` calls, after one warm-up,
    synchronized on both sides."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def device_us_by_kernel(fn, calls: int = 1000) -> dict:
    """Device us per call of fn, by kernel (or memset), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0][-40:]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / calls
    return out


def us_line(times: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in times.items())


def launch_breakdown(x) -> str:
    """add_one's launch path on x, piece by piece: host us per call of each
    step of the wrapper (and of the other public routes to the current
    stream, and of a ctypes call that releases the GIL), the whole wrapper
    and x + 1, and the device time of each from the profiler."""
    kernel = probe_cuda.ADD_ONE
    pyfn = kernel.load()
    cdll = getattr(ctypes.CDLL(probe_cuda.LIBRARY.path), kernel.symbol)
    cdll.restype, cdll.argtypes = ctypes.c_int, kernel.argtypes
    y = torch.empty_like(x)
    idx, xp, yp, n = x.get_device(), x.data_ptr(), y.data_ptr(), x.numel()
    stream = torch.accelerator.current_stream(idx).native_handle
    if stream != torch.cuda.current_stream(idx).cuda_stream:
        raise AssertionError("torch.accelerator and torch.cuda disagree on the current stream")

    count = [0]

    def rc_check_and_count(rc=0):
        if rc:
            raise RuntimeError(rc)
        count[0] += 1

    pieces = {
        "empty python call": lambda: None,
        "check_inputs": lambda: cuda_build.check_inputs("add_one", (x, torch.float32, None)),
        "torch.empty_like (used)": lambda: torch.empty_like(x),
        "torch.empty": lambda: torch.empty((8, 128), dtype=torch.float32, device=x.device),
        "torch.accelerator.current_stream(index).native_handle (used)":
            lambda: torch.accelerator.current_stream(idx).native_handle,
        "torch.cuda.current_stream(device).cuda_stream (former)":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "torch.cuda.current_stream(index).cuda_stream": lambda: torch.cuda.current_stream(idx).cuda_stream,
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "2 data_ptr, numel": lambda: (x.data_ptr(), y.data_ptr(), x.numel()),
        "ctypes call, PyDLL: GIL held (used)": lambda: pyfn(xp, yp, n, stream),
        "ctypes call, CDLL: GIL released (former)": lambda: cdll(xp, yp, n, stream),
        "rc check + count": rc_check_and_count,
        "add_one": lambda: probe_cuda.add_one(x),
        "x + 1": lambda: x + 1,
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # private, timed as the floor only
        pieces["torch._C._cuda_getCurrentRawStream(index) (private, not used)"] = lambda: raw(idx)
    host = {name: host_us_per_call(fn) for name, fn in pieces.items()}
    dev_add = device_us_by_kernel(lambda: probe_cuda.add_one(x))
    dev_x1 = device_us_by_kernel(lambda: x + 1)
    return (f"host us/call over {LAUNCH_CALLS}: {us_line(host)}; device us/call (profiler): "
            f"add_one: {us_line(dev_add)}; x + 1: {us_line(dev_x1)}")


def host_ms(fn) -> float:
    """Host-clock ms of one call, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(n_bytes: float, n_ops: float):
    """(least ms the card could take, what bounds it) for the work."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want) -> float:
    """Raster kernel vs plain outputs (depth, tri_id, b0, b1): tri_id
    identical, the rest within DEPTH_TOL. Returns the max abs float
    difference."""
    if not torch.equal(got[1], want[1]):
        raise AssertionError(f"tri_id differs on {(got[1] != want[1]).sum().item()} pixels")
    err = max((got[i] - want[i]).abs().max().item() for i in (0, 2, 3))
    if err > DEPTH_TOL:
        raise AssertionError(f"kernel vs plain float error {err}")
    return err


def centre_span(lo, hi, origin, n):
    """The pixel centres origin + c + 0.5 (0 <= c < n) inside [lo, hi]:
    (first c, last c), empty when first > last. float64, exact."""
    return (torch.ceil(lo - origin - 0.5).clamp(min=0),
            torch.floor(hi - origin - 0.5).clamp(max=n - 1))


def raster_work(args):
    """What the raster kernel's inputs ask of it, counted on the device from
    the listed blocks' mask bits: per tile the mask bits; per region shape
    of REGION_SHAPES, per region the triangles (mask bit set) whose padded
    bbox overlaps the box of the region's pixel centres; the (pixel,
    triangle) pairs whose pixel centre lies inside the padded bbox; the
    triangles with a mask bit in some listed block. Returns (bits per
    tile, {shape: triangles per region}, pixel pairs, listed triangles)."""
    rec, masks, block_list, block_count, _, width, _, y0 = args
    dev = rec.device
    n_tiles = masks.shape[0]
    tiles = torch.arange(n_tiles, device=dev)
    x0 = ((tiles % (width // rc.TILE_W)) * rc.TILE_W).double()[:, None]
    ya = ((tiles // (width // rc.TILE_W)) * rc.TILE_H + y0).double()[:, None]
    k = torch.arange(rc.BLOCK, device=dev)
    bits_per_tile = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    per_region = {(rw, rh): torch.zeros((n_tiles, rc.TILE_H // rh, rc.TILE_W // rw),
                                        dtype=torch.int64, device=dev) for rw, rh in REGION_SHAPES}
    pixel_pairs = 0
    listed = torch.zeros(rec.shape[0], dtype=torch.bool, device=dev)
    for i in range(int(block_count.max()) if n_tiles else 0):
        live = block_count > i
        blk = torch.where(live, block_list[:, i], 0).long()
        bit = (((torch.where(live, masks[tiles, blk], 0)[:, None] >> k) & 1) != 0)
        xmin, xmax, ymin, ymax = (rec[blk[:, None] * rc.BLOCK + k, rc.R_BB:rc.R_BB + 4]
                                  .double().unbind(-1))  # (n_tiles, 64) each
        bits_per_tile += bit.sum(dim=1)
        listed[(blk[:, None] * rc.BLOCK + k)[bit]] = True
        (cx0, cx1), (cy0, cy1) = (centre_span(xmin, xmax, x0, rc.TILE_W),
                                  centre_span(ymin, ymax, ya, rc.TILE_H))
        inside = (cx1 - cx0 + 1).clamp(min=0) * (cy1 - cy0 + 1).clamp(min=0)
        pixel_pairs += int(torch.where(bit, inside, 0).sum())
        for (rw, rh), count in per_region.items():
            lo_x = x0[:, :, None] + torch.arange(0, rc.TILE_W, rw, device=dev) + 0.5
            lo_y = ya[:, :, None] + torch.arange(0, rc.TILE_H, rh, device=dev) + 0.5
            hit_x = (xmin[..., None] <= lo_x + (rw - 1)) & (xmax[..., None] >= lo_x)
            hit_y = (ymin[..., None] <= lo_y + (rh - 1)) & (ymax[..., None] >= lo_y)
            count += (bit[:, :, None, None] & hit_y[..., None] & hit_x[:, :, None, :]).sum(dim=1)
    return (bits_per_tile, {s: c.flatten() for s, c in per_region.items()}, pixel_pairs,
            int(listed.sum()))


def spread(v) -> str:
    v = v.double()
    return (f"mean {v.mean().item():.1f} median {v.median().item():.0f} p99 "
            f"{torch.quantile(v, 0.99).item():.0f} max {int(v.max())}")


def raster_bound(args, pixel_pairs, listed_tris):
    """Bytes: the columns the kernel reads of each triangle with a mask bit
    in a listed block, the listed mask words and list entries, the counts
    and flags, four output planes. Operations: the (pixel, triangle) pairs
    of the listed mask bits whose pixel centre lies inside the triangle's
    padded bbox. Both counts come from raster_work."""
    _, masks, _, block_count, _, width, height, _ = args
    n_tiles, n_blocks = masks.shape
    n_bytes = (listed_tris * REC_BYTES_READ + int(block_count.sum()) * 12 + n_tiles * 4
               + n_blocks * 4 + 4 * width * height * 4)
    return bound(n_bytes, pixel_pairs * OPS_PER_PAIR)


def with_lists_of(args, tiles):
    """The raster inputs with every tile's bin list emptied except those of
    `tiles` (a valid input: the other tiles render empty)."""
    count = torch.zeros_like(args[3])
    count[tiles] = args[3][tiles]
    return (*args[:3], count, *args[4:])


def occlusion_bound(args):
    """Bytes: 16 per receiver (lx, ly, ld in, occ out), the records, the
    list entries, counts and tile bboxes. Operations: (live receiver, live
    caster overlapping the tile's receiver bbox) pairs of the listed
    blocks, ~25 FP32 operations each, no early exit counted. Returns
    (bound, pairs, hit casters: those pairs' casters summed over tiles)."""
    rec, block_list, block_count, tile_bbox, lx, ly, ld = args
    n_tiles = block_list.shape[0]
    live = oc._tile_rows(torch.isfinite(ld)).sum(dim=1)
    recb = rec.reshape(-1, rc.BLOCK, oc.REC)
    hits = torch.zeros(n_tiles, dtype=torch.int64, device=rec.device)
    for i in range(int(block_count.max()) if n_tiles else 0):
        hit = oc.caster_hits(recb[block_list[:, i].long()], tile_bbox)
        hits += torch.where(block_count > i, hit.sum(dim=1), 0)
    pairs = int((hits * live).sum())
    n_bytes = 16 * lx.numel() + rec.numel() * 4 + int(block_count.sum()) * 4 + n_tiles * 20
    return bound(n_bytes, pairs * OPS_PER_PAIR), pairs, int(hits.sum())


def bench_camera(k, dev):
    """Frame k of the bench orbit."""
    return orbit_camera(0.3 + 0.01 * k, WIDTH / HEIGHT, dev)


def traced_window(renderer, dev, activities, cam_at=bench_camera, frames: int = PROFILE_FRAMES,
                  eager: bool = False):
    """Render ``frames`` frames (frame k at ``cam_at(k, dev)``) under
    torch.profiler; with ``eager``, eager frames of the renderer's plan that
    do not advance its state (a replay runs no pass's range). Returns the
    profile and the window's host-clock ms per frame."""
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        synchronize_cards()
        t0 = time.perf_counter()
        for k in range(frames):
            if eager:
                renderer._run(commit=False, camera=cam_at(k, dev), time_s=0.0, overlay=None)
            else:
                renderer.render(cam_at(k, dev))
        synchronize_cards()
        wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    return prof, wall_ms


def traced_busy(prof, frames: int) -> tuple:
    """A traced window's device ops (the ``forward.`` ranges left out) and
    their device busy ms per frame."""
    from torch.autograd import DeviceType

    device_ops = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.key.startswith("forward.")]
    return device_ops, sum(e.self_device_time_total for e in device_ops) / 1e3 / frames


def busy_by_card(prof, frames: int) -> dict:
    """A traced window's device busy ms per frame on each card (device
    index -> ms), the ``forward.`` ranges left out."""
    from torch.autograd import DeviceType

    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("forward."):
            busy[e.device_index] = busy.get(e.device_index, 0.0) + e.time_range.elapsed_us()
    return {i: us / 1e3 / frames for i, us in sorted(busy.items())}


def pass_device_ms(events, n_frames: int):
    """Per pass, the device ms per frame of the work its range launched, and
    the ms per frame of device work that no pass launched. A device event
    (kernel, memset, copy) belongs to the pass whose ``forward.<pass>``
    range holds the host call that launched it: the CUDA runtime or driver
    call with the event's correlation id (kernels launched through ctypes
    included), or else the PyTorch op the event is linked to."""
    from torch.autograd import DeviceType

    ranges = sorted((e.time_range.start, e.time_range.end, e.name[len("forward."):])
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith("forward."))
    starts = [r[0] for r in ranges]
    runtime_at, op_at = {}, {}
    for e in events:
        if e.device_type == DeviceType.CPU and not e.name.startswith("forward."):
            (runtime_at if e.name.startswith("cu") else op_at)[e.id] = e.time_range.start
    per_pass = {r[2]: 0.0 for r in ranges}
    other = 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith("forward."):
            continue
        t = runtime_at.get(e.id, op_at.get(getattr(e, "linked_correlation_id", None)))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        ms = e.time_range.elapsed_us() / 1e3 / n_frames
        if i >= 0 and t <= ranges[i][1]:
            per_pass[ranges[i][2]] += ms
        else:
            other += ms
    return per_pass, other


def profile_main_path(name, renderer, dev, card: str, cam_at=bench_camera) -> dict:
    """Device busy time of the renderer's frames (replays) in one traced
    window, against their wall time in an untraced window of as many frames
    (the traced window's own wall holds the profiler's start); and per-pass
    device and host time in a second traced window of eager frames of its
    plan that also traces the host. A pass's device time is that of the
    work launched inside its range (pass_device_ms); the passes and the
    unattributed rest add up to the second window's device busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    wall_ms = frames_ms(renderer, PROFILE_FRAMES, lambda r, k: r.render(cam_at(k, dev)))
    prof, _ = traced_window(renderer, dev, [ProfilerActivity.CUDA], cam_at)
    device_ops, busy_ms = traced_busy(prof, PROFILE_FRAMES)
    ops = sum(e.count for e in device_ops) / PROFILE_FRAMES
    top = sorted(device_ops, key=lambda e: -e.self_device_time_total)[:4]
    if busy_ms > 0:
        share = (f"device busy {busy_ms:.3f} ms/frame, {wall_ms:.3f} ms/frame untraced "
                 f"= idle {100.0 * (1.0 - busy_ms / wall_ms):.1f}%, {ops:.0f} device ops/frame; "
                 "longest: " + ", ".join(
                     f"{e.key[:48]} {e.self_device_time_total / 1e3 / PROFILE_FRAMES:.3f} ms/frame"
                     for e in top))
    else:
        share = "device time not measured (the profiler saw no device activity)"
    prof, wall_ms = traced_window(renderer, dev, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                  cam_at, eager=True)
    host = {e.key[len("forward."):]: e.cpu_time_total / 1e3 / PROFILE_FRAMES
            for e in prof.key_averages()
            if e.key.startswith("forward.") and e.device_type == DeviceType.CPU}
    per_pass, other = pass_device_ms(prof.events(), PROFILE_FRAMES)
    busy2 = sum(per_pass.values()) + other
    phase(name, f"{PROFILE_FRAMES} frames ({card}): {share}; host+device traced window of "
                f"eager frames {wall_ms:.3f} ms/frame, per pass device/host ms/frame (device: the work "
                "launched inside the pass's range): "
                + ", ".join(f"{k} {d:.3f}/{host.get(k, 0.0):.3f}" for k, d in per_pass.items())
                + f"; passes sum to {sum(per_pass.values()):.3f} + {other:.3f} launched outside "
                f"any pass = {busy2:.3f} ms/frame of device time")
    PASS_PROFILES[name] = per_pass
    return per_pass


def run_orbit(renderer, dev, scene_at=lambda k: None, warmup: int = 1, cam_at=bench_camera,
              frames: int = None):
    """``warmup`` frames at the first pose, then ``frames`` (FRAMES) timed
    frames at ``cam_at(k, dev)`` (the bench orbit); frame k renders
    ``scene_at(k)`` (None: the renderer's scene), the warm-up frames
    k = -warmup..-1. Returns (ms per timed frame, last outputs)."""
    frames = frames or FRAMES
    for w in range(warmup):
        renderer.render(cam_at(0, dev), scene=scene_at(w - warmup))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(frames):
        out = renderer.render(cam_at(k, dev), scene=scene_at(k))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / frames, out


def replayed_pass_ms(renderer, dev, frames: int = PASS_FRAMES) -> dict:
    """Mean device ms of each pass over ``frames`` replayed frames of the
    bench orbit, from the renderer's frame trace: turned on (the programs
    captured again with the stamps, in a warm-up frame left out), read and
    turned off, then one frame that captures the programs without the
    stamps, so that what is timed next replays the untraced graphs."""
    renderer.trace_frames(frames + 1)
    run_orbit(renderer, dev, frames=frames)
    record = renderer.frame_trace.read()
    renderer.trace_frames(0)
    renderer.render(bench_camera(0, dev))
    synchronize_cards()
    return span_ms(record, record["frames"][1:])


def check_image(out):
    """Finite, the right shape, enough coverage and light. Returns
    (image (H, W, 3) numpy, coverage, mean brightness)."""
    img = out["image"].cpu().numpy()
    coverage = float((out["vis"].tri_id >= 0).float().mean())
    brightness = float(np.clip(img, 0.0, 1.0).mean())
    if not np.isfinite(img).all() or img.shape != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"image not finite or wrong shape {img.shape}")
    if coverage <= 0.30 or brightness <= 0.05:
        raise AssertionError(f"coverage {coverage:.3f} or brightness {brightness:.3f} too low")
    return img, coverage, brightness


class Recorder:
    """Wraps ``module.name`` while active: keeps each call's positional
    arguments, keyword arguments and result, made by an eager frame (a
    program's first frame or a ``Renderer(replay=False)`` one; a replay
    calls nothing, and a call inside a capture computes nothing and is not
    kept)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self._orig = getattr(self.module, self.name)

        def record(*args, **kwargs):
            out = self._orig(*args, **kwargs)
            if not torch.cuda.is_current_stream_capturing():
                self.calls.append((args, kwargs, out))
            return out

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


def mover_tables(scene, ks, dev):
    """(len(ks), N, 3) instance translations on the card, one table per
    frame k of ``ks``: bench.py's scripted caster (instance MOVER_INSTANCE)
    at its frame-k position (bench.py:105-120), made once before the timed
    frames so that no frame copies a table to the card."""
    base = scene.instances.translation.cpu().numpy()
    tables = np.repeat(base[None], len(ks), axis=0)
    for i, k in enumerate(ks):
        tables[i, MOVER_INSTANCE] = (4.0 * math.sin(0.7 * k), 1.5 + 0.5 * math.sin(1.3 * k),
                                     4.0 * math.cos(0.7 * k))
    return torch.from_numpy(tables).to(dev)


def atlas_views(slots) -> list:
    """Kernel 1's launches per slot when the slot renders: a directional
    slot (or band) one view, a point slot six cube faces, none without a
    light."""
    return [0 if sl is None else (1 if sl[1] else 6) for sl in slots]


def shadow_updates(renderer, dev, scene_at, slots):
    """Units of the cached atlas re-rendered per frame over UPDATE_FRAMES
    frames after the timed ones, counted from ``Renderer.state`` as
    bench.py:157-170 counts them (a unit whose signature changed: the
    units the frame selected). Each of these frames must launch kernel 1
    once for the camera and once per view of each slot with a selected
    unit, with conditional nodes (``control.cond``), else of every slot:
    the launches counted, replays and conditional bodies included."""
    cond_on = control.conditional_nodes()[0]
    views = atlas_views(slots)
    sig_prev = renderer.state["shadow_cache"][1].clone()
    changed = []
    for k in range(FRAMES, FRAMES + UPDATE_FRAMES):
        before = rc.RASTER_TILES.launches
        renderer.render(orbit_camera(0.3 + 0.01 * k, WIDTH / HEIGHT, dev), scene=scene_at(k))
        sig = renderer.state["shadow_cache"][1]
        unit = (sig != sig_prev).any(dim=-1)  # (slots,) or (slots, bands)
        changed.append(int(unit.sum()))
        slot_on = unit.reshape(len(slots), -1).any(dim=-1).tolist()
        want = 1 + sum(v for v, on in zip(views, slot_on) if on or not cond_on)
        got = rc.RASTER_TILES.launches - before
        if got != want:
            raise AssertionError(f"frame {k}: kernel 1 launched {got} times, want {want} (slots "
                                 f"selected {slot_on}, conditional nodes {cond_on})")
        sig_prev = sig.clone()
    return statistics.mean(changed)


def gate_frames(renderer, dev) -> dict:
    """Display-clamped (H, W, 3) numpy frames at the gate poses."""
    return {a: np.clip(renderer.render(orbit_camera(a, WIDTH / HEIGHT, dev))["image"].cpu().numpy(),
                       0.0, 1.0) for a in GATE_ANGLES}


def psnr_min(frames_a, frames_b) -> float:
    """The minimum over the gate poses of the PSNR between two frame sets."""
    return min(psnr(frames_a[a], frames_b[a]) for a in frames_a)


def psnr_vs_golden(frames) -> float:
    """The minimum over the gate poses of the PSNR against the committed
    golden frames, -1 where their shape differs (bench.psnr_vs_golden, read
    with the port's read_png)."""
    worst = math.inf
    for i, a in enumerate(GATE_ANGLES):
        ref = read_png(os.path.join(GOLDEN_DIR, f"shadowed_pose{i}.png")) / 255.0
        if ref.shape != frames[a].shape:
            return -1.0
        worst = min(worst, psnr(ref, frames[a]))
    return worst


def fmt_db(v: float) -> str:
    return "inf" if math.isinf(v) else f"{v:.2f}"


def shadow_phases(scene, prepared, cfg, renderer, frame_ms, path_launches, dev, card) -> dict:
    """Phases 14-19: the shadow atlas's raster, bench.py's checkerboard and
    shadowed tiers, image quality, the checkerboard's exactness, the plain
    raster in the shadowed frame and its profile. ``renderer`` is the base
    frame's (phase 7), ``frame_ms`` its ms per frame; each tier's raster
    launches go into ``path_launches``. Returns each tier's ms/frame."""
    # 14. the shadow atlas's raster at the bench camera (slot 0, the sun) -------
    size, k_bands = cfg.shadow_size, SHADOW_PROGRESSIVE
    slots = trt.slot_lights(renderer.atlas_casts, cfg.shadow_slots)
    mats_cube = tshadow.light_matrices_cube(scene.lights, prepared.scene_min, prepared.scene_max)

    def atlas_view(band=None):
        """Render slot 0 whole (band None) or one band of it; returns (caster
        demand, the raster call's (clip, valid, width, height))."""
        sel = prev = None
        if band is not None:
            sel = torch.zeros((1, k_bands), dtype=torch.bool, device=dev)
            sel[0, band] = True
            prev = torch.ones((1, size, size), dtype=torch.float32, device=dev)
        with Recorder(tshadow, "expand_clip_only") as ex, Recorder(tshadow, "rasterize_cuda") as ras:
            tshadow.render_shadow_atlas_per_light(
                scene, mats_cube, prepared.model, prepared.lod, slots[:1], size, cfg.caster_capacity,
                selected=sel, atlas_prev=prev, scene_min=prepared.scene_min,
                scene_max=prepared.scene_max, progressive=1 if band is None else k_bands)
        _, visible, lod_pick, _, _ = ex.calls[0][0]
        mesh_id = scene.instances.mesh_id.long()
        demand = int(torch.where(visible, scene.meshes.lod_tri_count[mesh_id, lod_pick], 0).sum())
        return demand, ras.calls[0][0]

    slot_demand, slot_call = atlas_view()
    band_demands = [atlas_view(b) for b in range(k_bands)]
    worst = max(range(k_bands), key=lambda b: band_demands[b][0])
    atlas_lines = []
    for what, demand, (clip, valid, w, h) in (("slot", slot_demand, slot_call),
                                              (f"band {worst}", *band_demands[worst])):
        a_args = rc.raster_inputs(clip, valid, w, h, cull_backface=False)
        got = rc.raster_kernel(*a_args, False)
        want = [None]
        p_ms = host_ms(lambda: want.__setitem__(0, rc.raster_tiles_plain(*a_args, False)))
        if not (torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[0][1])):
            raise AssertionError(f"atlas {what}: depth or ids differ between kernel and plain")
        a_ms = cuda_ms(lambda: rc.raster_kernel(*a_args, False), 20)
        _, _, pairs, listed = raster_work(a_args)
        a_bound, a_by = raster_bound(a_args, pairs, listed)
        atlas_lines.append(
            f"{what} {w}x{h}: casters wanted {demand} against capacity {cfg.caster_capacity} "
            f"({'truncated' if demand > cfg.caster_capacity else 'not truncated'}), "
            f"{int(valid.sum())} "
            f"expanded, {int(a_args[3].sum())} bin-list entries over {a_args[3].numel()} tiles; "
            f"kernel {a_ms:.4f} ms, plain {p_ms:.1f} ms, depth and ids identical; {pairs} pixel "
            f"pairs, {listed} triangles listed: bound {a_bound:.4f} ms by {a_by} = "
            f"{100 * a_bound / a_ms:.1f}% of the kernel's time")
    phase("atlas", "; ".join(atlas_lines) + f"; band demands {[d for d, _ in band_demands]} ({card})")

    # 15. bench.py's timed tiers: checkerboard+fix, shadowed static, dynamic ----
    cfg_cb = dataclasses.replace(cfg, shade_rate="checkerboard", shade_fix=True)
    cfg_dyn = dataclasses.replace(cfg_cb, shadow_update_budget=1,
                                  shadow_progressive=SHADOW_PROGRESSIVE,
                                  shadow_tri_capacity=SHADOW_BAND_CAPACITY)
    views = sum(atlas_views(slots))  # atlas views per frame that renders every slot
    cond_on = control.conditional_nodes()[0]
    tier_ms, tier_launches, tier_renderers = {"base_exact": frame_ms}, {}, {"base_exact": renderer}
    warmup = cfg_dyn.shadow_slots * SHADOW_PROGRESSIVE + 1
    tables = mover_tables(scene, range(-warmup, FRAMES + UPDATE_FRAMES), dev)

    def moved_scene(k):
        return scene._replace(instances=scene.instances._replace(translation=tables[k + warmup]))

    def static_scene(k):
        return None

    for tier, c, shadows, scene_at, n_warm in (
            ("base_checkerboard", cfg_cb, False, static_scene, 1),
            ("shadowed_exact", cfg, True, static_scene, 1),
            ("shadowed_checkerboard", cfg_cb, True, static_scene, 1),
            ("shadowed_dynamic", cfg_dyn, True, moved_scene, warmup)):
        r = Renderer(scene, c, outputs=("image", "vis"), device=dev)
        r.set_config(shadows=shadows)
        r.apply_config_now()
        for kernel in KERNELS:
            kernel.launches = 0
        tier_ms[tier], out = run_orbit(r, dev, scene_at, n_warm)
        tier_launches[tier] = {kn.symbol: kn.launches for kn in KERNELS}
        # the first frame (eager, before the capture) renders every view; a
        # replay renders a slot's views only where the cache selected it
        # (static: never), with conditional nodes
        n = FRAMES + n_warm
        want = {kn.symbol: 0 for kn in KERNELS}
        want[rc.RASTER_TILES.symbol] = n + (0 if not shadows else views if cond_on else n * views)
        want[tpbr.SHADE.symbol] = n * shades(c, r.config)
        want[tshadow.SIGNATURE.symbol] = n * signatures(c, r.config)
        got = dict(tier_launches[tier])
        if scene_at is moved_scene:  # data-dependent: bounded here, exact in shadow_updates
            lo, hi = n + views, n * (1 + views)
            if lo <= got[rc.RASTER_TILES.symbol] <= hi:
                want[rc.RASTER_TILES.symbol] = got[rc.RASTER_TILES.symbol]
        if got != want:
            raise AssertionError(f"{tier}: launches {got}, want {want}")
        check_image(out)
        if shadows:
            updates = shadow_updates(r, dev, scene_at, slots)
            ok = updates == 0 if scene_at is static_scene else 0 < updates <= 1
            if not ok:
                raise AssertionError(f"{tier}: {updates} shadow updates per frame")
            tier_launches[tier]["shadow_updates_per_frame"] = updates
        tier_renderers[tier] = r
    path_launches.update({t: n[rc.RASTER_TILES.symbol] for t, n in tier_launches.items()})
    write_png(os.path.join(enable_persistent_cache(), "chip_smoke_shadowed_frame.png"),
              np.clip(out["image"].cpu().numpy(), 0.0, 1.0))
    phase("tiers", "; ".join(
        f"{t} {ms:.2f} ms/frame = {1e3 / ms:.2f} FPS" + (
            f" (launches {tier_launches[t]})" if t in tier_launches else "")
        for t, ms in tier_ms.items())
          + f"; {FRAMES} timed frames after 1 warm-up ({warmup} for the dynamic tier) ({card})")

    # 16. image quality: checkerboard+fix against exact, and the goldens -------
    frames = {t: gate_frames(r, dev) for t, r in tier_renderers.items() if t != "shadowed_dynamic"}
    psnr_base = psnr_min(frames["base_exact"], frames["base_checkerboard"])
    psnr_sh = psnr_min(frames["shadowed_exact"], frames["shadowed_checkerboard"])
    golden = psnr_vs_golden(frames["shadowed_checkerboard" if psnr_sh >= GATE_DB
                                   else "shadowed_exact"])
    phase("quality", f"min over the gate poses {GATE_ANGLES} of display-clamped PSNR, "
                     f"checkerboard+fix against exact: base {fmt_db(psnr_base)} dB, shadowed "
                     f"{fmt_db(psnr_sh)} dB (gate {GATE_DB} dB, not enforced); bench.result_line "
                     f"would report base {'checkerboard+fix' if psnr_base >= GATE_DB else 'full'}, "
                     f"shadowed {'checkerboard+fix' if psnr_sh >= GATE_DB else 'full'}; "
                     f"psnr_vs_golden_db {fmt_db(golden)} (assets/golden, read with read_png)")

    # 17. bit-exactness of the checkerboard frame, aa none -----------------------
    cfg_plain_aa = dataclasses.replace(cfg, aa="none")
    gate_cam = orbit_camera(GATE_ANGLES[0], WIDTH / HEIGHT, dev)
    bit = {}
    for name, c in (("exact", cfg_plain_aa),
                    ("cb", dataclasses.replace(cfg_plain_aa, shade_rate="checkerboard",
                                               shade_fix=False)),
                    ("cb_fix", dataclasses.replace(cfg_plain_aa, shade_rate="checkerboard"))):
        r = Renderer(scene, c, device=dev)
        r.set_config(shadows=True)
        r.apply_config_now()
        bit[name] = r.render(gate_cam)["image"]
    yy = torch.arange(HEIGHT, device=dev)[:, None]
    xx = torch.arange(WIDTH, device=dev)[None, :]
    lattice = (xx + yy) % 2 == 0
    changed = (bit["cb_fix"] != bit["cb"]).any(dim=-1)
    if not torch.equal(bit["cb"][lattice], bit["exact"][lattice]):
        raise AssertionError("checkerboard: the shaded lattice differs from the exact frame")
    if not torch.equal(bit["cb_fix"][changed], bit["exact"][changed]) or changed[lattice].any():
        raise AssertionError("checkerboard: a pixel the fix re-shaded differs from the exact frame")
    phase("cb_exact", f"shadowed, aa none, pose {GATE_ANGLES[0]}: the {int(lattice.sum())} shaded "
                      f"lattice pixels and the {int(changed.sum())} pixels the fix changed equal "
                      f"the exact frame bit for bit (fix capacity "
                      f"{fix_capacity(HEIGHT * WIDTH // 2)})")

    # 18. the shadowed checkerboard frame with the plain raster in both passes ---
    def shadowed_cb_image():
        r = Renderer(scene, cfg_cb, device=dev, replay=False)  # one frame, no capture
        r.set_config(shadows=True)
        r.apply_config_now()
        return r.render(gate_cam)["image"]

    ref_img = shadowed_cb_image()
    kernel_fn = rc.raster_kernel
    rc.raster_kernel = rc.raster_tiles_plain  # the plain version on CUDA tensors
    try:
        plain_img = shadowed_cb_image()
    finally:
        rc.raster_kernel = kernel_fn
    if not torch.equal(ref_img, plain_img):
        raise AssertionError("shadowed checkerboard frame differs between kernel and plain raster")
    phase("shadowed_vs_plain", "shadowed checkerboard+fix frame with the plain raster in the "
                               "camera and atlas passes: image identical")

    # 19. profile of the shadowed checkerboard+fix frame -------------------------
    profile_main_path("shadow_profile", tier_renderers["shadowed_checkerboard"], dev, card)
    return tier_ms


def city_camera(k, dev):
    """Frame k of scripts/prof_scale.py's street walk through the city."""
    return Camera.create((0.0, 2.0, 70.0 - 1.5 * k), None, fov_y=0.9, aspect=WIDTH / HEIGHT,
                         near=0.1, far=400.0, device=dev)


def pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def truncation(demands, counts, cap) -> str:
    """Whether frames of these demands and soup counts were cut off by the
    expansion (2 cap) or the soup (cap)."""
    return ("truncated" if max(demands) > 2 * cap or max(counts) >= cap else "not truncated")


def city_counts(renderer, dev):
    """The walk's warm-up frame and CITY_FRAMES frames: per frame the
    expansion demand of the visible set the cull expands (after the
    occlusion test, when on) and soup.count."""
    counts = []
    with Recorder(geometry, "build_draw_stream") as rec:
        for k in range(-1, CITY_FRAMES):
            counts.append(renderer.render(city_camera(max(k, 0), dev))["soup"].count)
    demands = [geometry.expansion_demand(a[0], a[1].visible, a[1].lod) for a, _, _ in rec.calls]
    return [int(d) for d in demands], [int(c) for c in counts]


def visible_identity(out):
    """(H, W) int64 instance * 2^32 + library triangle, -1 where empty."""
    tri = out["vis"].tri_id.long()
    safe = tri.clamp(min=0)
    soup = out["soup"]
    return torch.where(tri >= 0, (soup.instance[safe] << 32) + soup.tri_idx[safe], -1)


def kernel_at_soup(name, clip, valid, with_bary, card, band_rows=None, size=(WIDTH, HEIGHT),
                   exact=False):
    """Kernel 1 at a main-path soup of a ``size`` (width, height) frame:
    against its plain version (on the whole image, or on ``band_rows`` rows
    from the middle when the plain version would take too long; with
    ``exact`` the floats must be equal too), its time and its bound.
    Returns (line, kernel ms, bound ms, bound by)."""
    width, height = size
    args = rc.raster_inputs(clip, valid, width, height)
    got = rc.raster_kernel(*args, with_bary)
    if band_rows is None:
        want = [None]
        p_ms = host_ms(lambda: want.__setitem__(0, rc.raster_tiles_plain(*args, with_bary)))
        err, where = compare(got, want[0]), "the whole image"
    else:
        y0 = height // 2 - band_rows // 2
        band = rc.raster_inputs(clip, valid, width, band_rows, y0=y0, full_height=height)
        want = [None]
        p_ms = host_ms(lambda: want.__setitem__(0, rc.raster_tiles_plain(*band, with_bary)))
        err = compare(rc.raster_kernel(*band, with_bary), want[0])
        if not all(torch.equal(b, g[y0:y0 + band_rows])
                   for b, g in zip(rc.raster_kernel(*band, with_bary), got)):
            raise AssertionError(f"{name}: the kernel's row band differs from its whole image")
        where = f"rows {y0}..{y0 + band_rows - 1} ({band_rows * width // (rc.TILE_H * rc.TILE_W)} tiles)"
    if exact and err != 0.0:
        raise AssertionError(f"{name}: kernel and plain floats differ by {err}")
    k_ms = cuda_ms(lambda: rc.raster_kernel(*args, with_bary), 10)
    _, _, pairs, listed = raster_work(args)
    r_bound, r_by = raster_bound(args, pairs, listed)
    counts = args[3]
    return (f"{name}: {int(valid.sum())} valid triangles, bins mean "
            f"{counts.float().mean().item():.1f} max {int(counts.max())} blocks/tile; kernel "
            f"(bary {'on' if with_bary else 'off'}) {k_ms:.4f} ms; against the plain version on "
            f"{where}: tri_id identical, max float err {err:.1e}, plain {p_ms:.1f} ms; {pairs} "
            f"pixel pairs, {listed} triangles listed: bound {r_bound:.4f} ms by {r_by} = "
            f"{100 * r_bound / k_ms:.1f}% of the kernel's time ({card})", k_ms, r_bound, r_by)


def shades(cfg, switches=None) -> int:
    """Kernel 7's launches per frame of ``cfg`` under the runtime switches
    (a dict or a RuntimeConfig): none for Lambert or the debug view, 2 for
    a checkerboard or quarter frame with its fix (the fix is skipped under
    rt), else 1, each per shard of a split frame; 1 more for the reference
    view."""
    sw = dict(vars(switches) if hasattr(switches, "__dict__") else switches or {})
    if sw.get("debug_aabbs") or cfg.shading == "lambert":
        per_shard = 0
    else:
        per_shard = 2 if cfg.shade_rate != "full" and cfg.shade_fix and not sw.get("rt") else 1
    reference = sw.get("reference_image") and not sw.get("hud") and not sw.get("debug_aabbs")
    return per_shard * cfg.spmd_devices + int(bool(reference))


def signatures(cfg, switches=None) -> int:
    """Kernel 8's launches per frame of ``cfg`` under the runtime switches
    (a dict or a RuntimeConfig): one per shard of a frame with the cached
    atlas (the shadows switch and ``shadow_cache``, rt or not; not the
    debug view), else none."""
    sw = dict(vars(switches) if hasattr(switches, "__dict__") else switches or {})
    cached = sw.get("shadows") and cfg.shadow_cache and not sw.get("debug_aabbs")
    return cfg.spmd_devices if cached else 0


def launches_of(run, want: int, what: str, shade: int, sigs: int = 0):
    """Run ``run()`` with every kernel's count at 0; the raster kernel must
    launch ``want`` times, kernel 7 ``shade`` times, kernel 8 ``sigs``
    times and no other kernel at all. Returns run()'s result."""
    for kernel in KERNELS:
        kernel.launches = 0
    result = run()
    got = {kn.symbol: kn.launches for kn in KERNELS}
    expect = {kn.symbol: 0 for kn in KERNELS}
    expect[rc.RASTER_TILES.symbol] = want
    expect[tpbr.SHADE.symbol] = shade
    expect[tshadow.SIGNATURE.symbol] = sigs
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, want {expect}")
    return result


def culling_phases(scene, prepared, cfg, renderer, camera_kernel_ms, path_launches, dev,
                   card):
    """Phases 20-24: the culling switches. The city canyon with and without
    occlusion culling, the held-pose check, freeze culling, the debug-AABB
    view and cluster culling on the bench frame. ``renderer`` is the base
    frame's (phase 7), ``camera_kernel_ms`` kernel 1's time at its soup;
    each path's raster launches go into ``path_launches``. Returns the
    city scene, its config and the frustum walk's ms/frame."""
    # 20. the city canyon: frustum culling at 2^18, occlusion culling at 2^16 -----
    t0 = time.perf_counter()
    city = city_scene(CITY_GRID, device=dev)
    torch.cuda.synchronize()
    t_city = time.perf_counter() - t0
    cfg_city = PipelineConfig(width=WIDTH, height=HEIGHT, tri_capacity=CITY_CAPACITY,
                              enable_normal_maps=False, aa="edge", trilinear=False)

    def city_renderer(capacity, occlusion, replay=None):
        r = Renderer(city, dataclasses.replace(cfg_city, tri_capacity=capacity),
                     outputs=("image", "vis", "soup"), device=dev, replay=replay)
        r.set_config(occlusion_culling=occlusion)
        r.apply_config_now()
        return r

    runs = {}
    for mode, cap, occ in (("frustum", CITY_CAPACITY, False), ("occlusion", CITY_OCC_CAPACITY, True)):
        tried = []
        while True:
            demand, count = city_counts(city_renderer(cap, occ, replay=False), dev)
            # the steady frames (after the warm-up) expand and keep all they ask for
            if not occ or (max(demand[1:]) <= 2 * cap and max(count[1:]) < cap):
                break
            tried.append(f"capacity {cap} truncates the steady frames (demand per frame {demand}, "
                         f"soup.count {count})")
            cap *= 2  # the smallest power of two that holds the steady frames
        line = "; ".join(tried + [f"capacity {cap} (expansion {2 * cap})"])
        r = city_renderer(cap, occ)
        ms, out = launches_of(lambda: run_orbit(r, dev, cam_at=city_camera, frames=CITY_FRAMES),
                              CITY_FRAMES + 1, f"city {mode}",
                              (CITY_FRAMES + 1) * shades(r.cfg, r.config))
        path_launches[f"city_{mode}"] = CITY_FRAMES + 1
        check_image(out)
        runs[mode] = dict(cap=cap, demand=demand, count=count, ms=ms, renderer=r, line=line)
        phase(f"city_{mode}", f"city_scene({CITY_GRID}) built in {t_city:.1f} s, "
                              f"{int(city.instances.count)} instances, street walk of "
                              f"{CITY_FRAMES} frames after 1 warm-up; {line}; expansion demand "
                              f"per frame (warm-up first) {demand}; soup.count per frame {count}; "
                              f"warm-up frame {truncation(demand[:1], count[:1], cap)}, steady "
                              f"frames {truncation(demand[1:], count[1:], cap)}; "
                              f"{ms:.2f} ms/frame = {1e3 / ms:.2f} FPS ({card})")
    for mode, run in runs.items():
        profile_main_path(f"city_{mode}_profile", run["renderer"], dev, card, cam_at=city_camera)

    # 21. held pose: the second occluded frame against the unoccluded one --------
    # both at a capacity that holds the pose's frustum demand, so that the
    # first occluded frame (no previous depth) is complete
    held = city_camera(CITY_FRAMES // 2, dev)
    held_prep = geometry.prepare_frame_columns(city, held)
    frustum_demand = int(geometry.expansion_demand(city, held_prep.visible, held_prep.lod))
    cap_ref = max(CITY_CAPACITY, pow2_at_least(-(-frustum_demand // 2)))
    r_occ = city_renderer(cap_ref, True, replay=False)  # its second frame is recorded
    r_occ.render(held)
    with Recorder(pipeline_module, "rasterize_cuda") as ras:
        occluded = r_occ.render(held)
    plain = city_renderer(cap_ref, False, replay=False).render(held)
    same = float((visible_identity(occluded) == visible_identity(plain)).float().mean())
    held_psnr = psnr(np.clip(occluded["image"].cpu().numpy(), 0, 1),
                     np.clip(plain["image"].cpu().numpy(), 0, 1))
    if same < 0.999 or held_psnr < 50.0:
        raise AssertionError(f"held pose: visible triangle equal on {100 * same:.3f}% of pixels, "
                             f"PSNR {held_psnr:.2f} dB")
    city_line, *_ = kernel_at_soup("city soup (occlusion on, held pose, second frame)",
                                   ras.calls[0][0][0], ras.calls[0][0][1], False, card)
    phase("city_held", f"pose {CITY_FRAMES // 2} of the walk (frustum demand {frustum_demand}, "
                       f"capacity {cap_ref}) rendered twice with occlusion culling: soup.count "
                       f"{int(occluded['soup'].count)}, against once without: soup.count "
                       f"{int(plain['soup'].count)}; visible "
                       f"(instance, triangle) equal on {100 * same:.4f}% of pixels (gate 99.9%), "
                       f"display-clamped PSNR {fmt_db(held_psnr)} dB (gate 50); " + city_line)

    # 22. freeze culling on the bench frame -----------------------------------------
    cam0 = bench_camera(0, dev)
    r = Renderer(scene, cfg, outputs=("image", "vis", "soup"), device=dev)
    unfrozen = r.render(cam0)
    r.set_config(freeze_culling=True)
    r.apply_config_now()
    frozen = r.render(cam0)
    frozen_psnr = psnr(np.clip(frozen["image"].cpu().numpy(), 0, 1),
                       np.clip(unfrozen["image"].cpu().numpy(), 0, 1))
    if not torch.equal(frozen["vis"].tri_id, unfrozen["vis"].tri_id) or frozen_psnr < 50.0:
        raise AssertionError(f"frozen frame at the freeze pose: tri_id equal "
                             f"{torch.equal(frozen['vis'].tri_id, unfrozen['vis'].tri_id)}, "
                             f"PSNR {frozen_psnr:.2f} dB")
    freeze_ms, out = launches_of(lambda: run_orbit(r, dev), FRAMES + 1, "freeze",
                                 (FRAMES + 1) * shades(r.cfg, r.config))
    path_launches["freeze"] = FRAMES + 1
    counts = {int(unfrozen["soup"].count), int(frozen["soup"].count), int(out["soup"].count)}
    if len(counts) != 1:
        raise AssertionError(f"freeze: soup.count changed {counts}")
    check_image(out)
    phase("freeze", f"frozen at bench pose 0 after one culled frame: tri_id identical to the "
                    f"unfrozen frame, display-clamped PSNR {fmt_db(frozen_psnr)} dB (gate 50); "
                    f"soup.count {counts.pop()} on every frame of the orbit; {freeze_ms:.2f} "
                    f"ms/frame = {1e3 / freeze_ms:.2f} FPS over {FRAMES} frames ({card})")
    profile_main_path("freeze_profile", r, dev, card)

    # 23. the debug-AABB view on the bench frame --------------------------------
    r = Renderer(scene, cfg, outputs=("image", "vis", "soup"), device=dev)
    r.set_config(debug_aabbs=True)
    r.apply_config_now()
    with Recorder(pipeline_module, "rasterize_cuda") as ras:
        boxes = r.render(cam0)
    n_boxes, n_visible = int(boxes["soup"].count), int(prepared.visible.sum())
    if n_boxes != min(12 * n_visible, cfg.tri_capacity):
        raise AssertionError(f"box soup count {n_boxes} against {n_visible} visible instances")
    (clip, valid, *_), kw, _ = ras.calls[0]
    box_line, *_ = kernel_at_soup("box soup", clip, valid, kw["with_bary"], card,
                                  band_rows=DEBUG_BAND_ROWS)
    debug_ms, out = launches_of(lambda: run_orbit(r, dev), FRAMES + 1, "debug_aabbs",
                                (FRAMES + 1) * shades(r.cfg, r.config))
    path_launches["debug_aabbs"] = FRAMES + 1
    check_image(out)
    phase("debug_aabbs", f"{n_boxes} box triangles = 12 x {n_visible} visible instances (capacity "
                         f"{cfg.tri_capacity}), compacted, not sorted; {box_line}; kernel at the "
                         f"camera soup (bary off, phase 6) {camera_kernel_ms:.4f} ms; "
                         f"{debug_ms:.2f} ms/frame = {1e3 / debug_ms:.2f} FPS over {FRAMES} frames")

    # 24. cluster culling on the bench frame -------------------------------------
    cfg_cl = dataclasses.replace(cfg, cluster_cull=True)
    r_cl = Renderer(scene, cfg_cl, outputs=("image", "vis", "soup"), device=dev)
    with Recorder(geometry, "_slot_map_counts") as maps:
        clustered = r_cl.render(cam0)
    listed, kept = int(maps.calls[0][0][0].sum()), int((maps.calls[1][0][0] > 0).sum())
    flat = Renderer(scene, cfg, outputs=("image", "vis", "soup"), device=dev).render(cam0)
    img_err = (clustered["image"] - flat["image"]).abs().max().item()
    if not torch.equal(clustered["vis"].tri_id >= 0, flat["vis"].tri_id >= 0) or img_err > 2e-6:
        raise AssertionError(f"cluster cull: coverage differs or image error {img_err}")
    demand = int(geometry.expansion_demand(scene, prepared.visible, prepared.lod))
    turns = {"plain": [], "cluster": []}
    for name in ("plain", "cluster", "cluster", "plain"):
        rr = renderer if name == "plain" else r_cl
        ms, _ = launches_of(lambda: run_orbit(rr, dev), FRAMES + 1, f"cluster cull ({name})",
                            (FRAMES + 1) * shades(rr.cfg, rr.config))
        turns[name].append(ms)
    path_launches["cluster_cull"] = 2 * (FRAMES + 1)
    phase("cluster_cull", f"bench pose 0: {listed} clusters listed, {kept} kept = "
                          f"{100 * (1 - kept / max(1, listed)):.2f}% culled; triangles expanded "
                          f"{int(maps.calls[1][2][2].sum())} of demand {demand} (expansion "
                          f"capacity {cfg.expand_capacity}); soup.count "
                          f"{int(clustered['soup'].count)} against {int(flat['soup'].count)}; "
                          f"coverage identical, image max abs difference {img_err:.1e} (gate 2e-6); "
                          f"ms/frame in turns plain, cluster, cluster, plain: plain "
                          f"{[round(v, 2) for v in turns['plain']]}, cluster "
                          f"{[round(v, 2) for v in turns['cluster']]} ({card})")
    return city, cfg_city, runs["frustum"]["ms"]


def pose_cost(scene, dev):
    """The pose pass alone on ``scene``: (device ms by CUDA events, peak
    bytes allocated above what was live before it)."""
    t = torch.full((), 0.25, device=dev)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    posed = pose_scene(scene, t)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - live
    del posed
    return cuda_ms(lambda: pose_scene(scene, t), 10), peak


def swapped_plain_image(make_image):
    """``make_image()`` with the plain raster version swapped in for kernel 1
    (its Renderer eager: the plain version waits for the card, and a
    capture refuses that)."""
    kernel_fn = rc.raster_kernel
    rc.raster_kernel = rc.raster_tiles_plain  # the plain version on CUDA tensors
    try:
        return make_image()
    finally:
        rc.raster_kernel = kernel_fn


def run_demos(card) -> str:
    """Phase 30: the demo's runs, all started together, each in its own
    process; each must exit 0 and write its PNG. Returns the phase line."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = {}
    for name, args in DEMO_RUNS.items():
        out = os.path.join(enable_persistent_cache(), f"demo_{name}.png")
        if os.path.exists(out):
            os.remove(out)
        cmd = [sys.executable, "-m", "renderer_tpu_torch.demo", "--size", str(DEMO_SIZE),
               "--out", out, "--frames", "3", "--check-sync", *args]
        procs[name] = (out, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    results, failed = [], []
    for name, (out, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=max(1.0, DEMO_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        steady = [line for line in log.splitlines() if line.startswith("steady-state")]
        if proc.returncode != 0 or not os.path.exists(out):
            failed.append(f"{name} (exit {proc.returncode}): {log[-2000:]}")
            continue
        img = read_png(out)
        if img.shape != (DEMO_SIZE, DEMO_SIZE, 3) or img.std() < 2.0:
            failed.append(f"{name}: PNG {img.shape}, std {img.std():.2f}")
        results.append(f"{name} {steady[0].split(': ')[1] if steady else '?'}")
    if failed:
        raise AssertionError("demo runs failed: " + " | ".join(failed))
    return (f"{len(results)} runs at {DEMO_SIZE}x{DEMO_SIZE}, 3 frames after the first, all "
            f"under --check-sync, exit 0, PNGs in "
            f"{os.path.relpath(enable_persistent_cache(), ROOT)}/ "
            f"in {time.perf_counter() - t0:.1f} s: " + "; ".join(results) + f" ({card})")


def tier_phases(scene, cfg, renderer, frame_ms, path_launches, dev, card) -> None:
    """Phases 25-30: skinning with the per-corner cull, the skinned scene
    animated, the quarter shade rate, SSAA, Lambert and the demo.
    ``renderer`` is the base exact frame's (phase 7); each path's raster
    launches go into ``path_launches``."""
    outputs = ("image", "vis", "soup")
    cam0 = bench_camera(0, dev)

    # 25. skinning on at the bench: the pose pass and the per-corner cull ----------
    pose_ms, pose_peak = pose_cost(scene, dev)
    posed = pose_scene(scene, torch.full((), 0.25, device=dev))
    if posed.meshes.tri_rec is not None or not torch.equal(posed.meshes.positions,
                                                          scene.meshes.positions):
        raise AssertionError("pose pass: the bench scene has no skin, its vertices must stay")
    cfg_sk = dataclasses.replace(cfg, skinning=True)
    r_sk = Renderer(scene, cfg_sk, outputs=outputs, device=dev)
    sk_ms, out = launches_of(lambda: run_orbit(r_sk, dev), FRAMES + 1, "skinned",
                             (FRAMES + 1) * shades(r_sk.cfg, r_sk.config))
    path_launches["skinned"] = FRAMES + 1
    check_image(out)
    with Recorder(pipeline_module, "rasterize_cuda") as ras:  # r_sk's frames are replays
        sk_frame = Renderer(scene, cfg_sk, outputs=outputs, device=dev, replay=False).render(cam0)
    flat = renderer.render(cam0)
    (clip, valid, *_), _, _ = ras.calls[0]
    soup_line, *_ = kernel_at_soup("per-corner soup", clip, valid, False, card, exact=True)
    ref = Renderer(scene, cfg_sk, device=dev).render(cam0)["image"]
    plain = swapped_plain_image(lambda: Renderer(scene, cfg_sk, device=dev, replay=False).render(cam0)["image"])
    if not torch.equal(ref, plain):
        raise AssertionError("skinned frame differs between kernel and plain raster")
    same = float((sk_frame["vis"].tri_id == flat["vis"].tri_id).float().mean())
    phase("skinned", f"sponza_like_scene({N_INSTANCES}) with skinning on: pose pass alone "
                     f"{pose_ms:.3f} ms by events, peak {pose_peak / 2**20:.1f} MiB above the "
                     f"live {scene.meshes.positions.shape[0]}-vertex scene; {sk_ms:.2f} ms/frame = "
                     f"{1e3 / sk_ms:.2f} FPS over {FRAMES} frames (base {frame_ms:.2f}); soup.count "
                     f"{int(sk_frame['soup'].count)} per-corner against {int(flat['soup'].count)} "
                     f"from tri_rec, tri_id equal on {100 * same:.4f}% of pixels; {soup_line}; "
                     "the frame with the plain raster swapped in: image identical")
    profile_main_path("skinned_profile", r_sk, dev, card)

    # 26. the skinned scene animated over its clip --------------------------------
    sk_scene = skinned_scene(device=dev)
    # eager: every frame's pose pass is recorded (the bench's skinned tier is
    # replayed in phase 41)
    r_anim = Renderer(sk_scene, PipelineConfig(width=WIDTH, height=HEIGHT, tri_capacity=16384,
                                               skinning=True, aa="edge"), device=dev, replay=False)
    cam = Camera.create((0.0, 1.2, 4.0), fov_y=0.9, aspect=WIDTH / HEIGHT, near=0.1, far=50.0,
                        device=dev)

    def animate():
        return [r_anim.render(cam, time_s=k / SKIN_FRAMES)["image"] for k in range(SKIN_FRAMES)]

    with Recorder(pipeline_module, "pose_scene") as poses:
        images = launches_of(animate, SKIN_FRAMES, "skinned scene",
                             SKIN_FRAMES * shades(r_anim.cfg, r_anim.config))
    path_launches["skinned_scene"] = SKIN_FRAMES
    pos = [c[2].meshes.positions for c in poses.calls]
    moved = min(float((pos[k] - pos[k - 1]).abs().max()) for k in range(1, SKIN_FRAMES))
    changed = min(int((images[k] != images[k - 1]).any(dim=-1).sum()) for k in range(1, SKIN_FRAMES))
    if moved <= 1e-4 or changed == 0 or not all(bool(torch.isfinite(i).all()) for i in images):
        raise AssertionError(f"skinned scene: least vertex move {moved}, least pixels changed "
                             f"{changed} between frames")
    write_png(os.path.join(enable_persistent_cache(), "chip_smoke_skinned_frame.png"),
              np.clip(images[-1].cpu().numpy(), 0.0, 1.0))
    phase("skinned_scene", f"skinned_scene at {WIDTH}x{HEIGHT}, {SKIN_FRAMES} frames over its 1 s "
                           f"clip: between consecutive frames the vertices move at least "
                           f"{moved:.4f} and at least {changed} pixels change")

    # 27. the quarter shade rate with its fix ----------------------------------------
    cfg_q = dataclasses.replace(cfg, shade_rate="quarter")
    r_q = Renderer(scene, cfg_q, outputs=outputs, device=dev)
    q_ms, out = launches_of(lambda: run_orbit(r_q, dev), FRAMES + 1, "quarter",
                            (FRAMES + 1) * shades(r_q.cfg, r_q.config))
    path_launches["quarter"] = FRAMES + 1
    check_image(out)
    q_psnr = psnr_min(gate_frames(renderer, dev), gate_frames(r_q, dev))
    cfg_none = dataclasses.replace(cfg, aa="none")
    gate_cam = orbit_camera(GATE_ANGLES[0], WIDTH / HEIGHT, dev)
    bit = {name: Renderer(scene, c, device=dev).render(gate_cam)["image"] for name, c in (
        ("exact", cfg_none), ("q", dataclasses.replace(cfg_none, shade_rate="quarter",
                                                        shade_fix=False)),
        ("q_fix", dataclasses.replace(cfg_none, shade_rate="quarter")))}
    yy = torch.arange(HEIGHT, device=dev)[:, None]
    xx = torch.arange(WIDTH, device=dev)[None, :]
    lattice = (xx % 2 == 0) & (yy % 2 == 0)
    changed = (bit["q_fix"] != bit["q"]).any(dim=-1)
    if not torch.equal(bit["q"][lattice], bit["exact"][lattice]):
        raise AssertionError("quarter: the shaded lattice differs from the exact frame")
    if not torch.equal(bit["q_fix"][changed], bit["exact"][changed]) or changed[lattice].any():
        raise AssertionError("quarter: a pixel the fix re-shaded differs from the exact frame")
    phase("quarter", f"quarter+fix: {q_ms:.2f} ms/frame = {1e3 / q_ms:.2f} FPS over {FRAMES} "
                     f"frames (base exact {frame_ms:.2f}); min over the gate poses {GATE_ANGLES} "
                     f"of display-clamped PSNR against exact {fmt_db(q_psnr)} dB; aa none, pose "
                     f"{GATE_ANGLES[0]}: the {int(lattice.sum())} shaded lattice pixels and the "
                     f"{int(changed.sum())} pixels the fix changed equal the exact frame bit for "
                     f"bit (fix capacity {quarter_fix_capacity(HEIGHT * WIDTH)}) ({card})")
    profile_main_path("quarter_profile", r_q, dev, card)

    # 28. SSAA 2 with aa none --------------------------------------------------------
    cfg_ss = dataclasses.replace(cfg, ssaa=SSAA, aa="none")
    size_ss = cfg_ss.render_size
    r_ss = Renderer(scene, cfg_ss, outputs=outputs, device=dev)
    ss_ms, out = launches_of(lambda: run_orbit(r_ss, dev), FRAMES + 1, "ssaa",
                             (FRAMES + 1) * shades(r_ss.cfg, r_ss.config))
    path_launches["ssaa2"] = FRAMES + 1
    check_image(out)
    with Recorder(pipeline_module, "rasterize_cuda") as ras:  # r_ss's frames are replays
        Renderer(scene, cfg_ss, outputs=outputs, device=dev, replay=False).render(cam0)
    (clip, valid, *_), _, _ = ras.calls[0]
    ss_line, *_ = kernel_at_soup(f"SSAA {SSAA} soup ({size_ss[0]}x{size_ss[1]})", clip, valid,
                                 False, card, band_rows=SSAA_BAND_ROWS, size=size_ss, exact=True)
    phase("ssaa", f"SSAA {SSAA}, aa none: {ss_ms:.2f} ms/frame = {1e3 / ss_ms:.2f} FPS over "
                  f"{FRAMES} frames; {ss_line}")
    profile_main_path("ssaa_profile", r_ss, dev, card)

    # 29. Lambert --------------------------------------------------------------------
    r_l = Renderer(scene, dataclasses.replace(cfg, shading="lambert", aa="none"), outputs=outputs,
                   device=dev)
    l_ms, out = launches_of(lambda: run_orbit(r_l, dev), FRAMES + 1, "lambert",
                            (FRAMES + 1) * shades(r_l.cfg, r_l.config))
    path_launches["lambert"] = FRAMES + 1
    check_image(out)
    phase("lambert", f"Lambert: {l_ms:.2f} ms/frame = {1e3 / l_ms:.2f} FPS over {FRAMES} frames "
                     f"(base PBR {frame_ms:.2f}) ({card})")
    profile_main_path("lambert_profile", r_l, dev, card)

    # 30. the demo ---------------------------------------------------------------------
    phase("demo", run_demos(card))


def colonnade_camera(k, dev):
    """Frame k of the demo's colonnade orbit (radius 14, height 3, angle
    0.5 + 0.02k, pitch -0.35) at the frame's aspect."""
    angle = 0.5 + 0.02 * k
    rot = quat_mul(quat_from_axis_angle((0.0, 1.0, 0.0), angle, device="cpu"),
                   quat_from_axis_angle((1.0, 0.0, 0.0), -0.35, device="cpu"))
    return Camera.create((14.0 * math.sin(angle), 3.0, 14.0 * math.cos(angle)), rot.numpy(),
                         fov_y=0.9, aspect=WIDTH / HEIGHT, near=0.1, far=100.0, device=dev)


def clone_scene(scene):
    """A copy of every table of ``scene`` on its device."""
    leaves, structure = tree.flatten(scene)
    return tree.unflatten(structure, [t.clone() for t in leaves])


def soup_at(renderer, cam):
    """(clip, valid, with_bary) of kernel 1's call in one frame of ``renderer``."""
    with Recorder(pipeline_module, "rasterize_cuda") as ras:
        renderer.render(cam)
    (clip, valid, *_), kw, _ = ras.calls[0]
    return clip, valid, kw["with_bary"]


def host_records(mesh) -> np.ndarray:
    """A mesh's tri_rec rows as the builder gathers them (unsorted order)."""
    idx = mesh.indices
    t = len(idx)
    return np.concatenate([mesh.positions[idx].reshape(t, 9), mesh.normals[idx].reshape(t, 9),
                           mesh.uvs[idx].reshape(t, 6), mesh.tangents[idx].reshape(t, 12)], axis=1)


def streamed_meshes_match(scene, first_mesh, host_meshes) -> int:
    """Each mesh the streamer added (slots first_mesh..mesh_count-1): its
    vertex rows, index rows (library-global) and tri_rec rows read back
    equal to the host mesh with its vertex positions. Returns the count."""
    lib = scene.meshes
    count = int(lib.mesh_count)
    offs = lib.mesh_vertex_offset.tolist()
    v_counts = lib.mesh_vertex_count.tolist()
    t_offs = lib.lod_index_offset[:, 0].tolist()
    t_counts = lib.lod_tri_count[:, 0].tolist()
    for m in range(first_mesh, count):
        v0, nv, t0, nt = offs[m], v_counts[m], t_offs[m], t_counts[m]
        pos = lib.positions[v0:v0 + nv].cpu().numpy()
        host = next((h for h in host_meshes if len(h.positions) == nv and len(h.indices) == nt
                     and np.array_equal(h.positions, pos)), None)
        if host is None:
            raise AssertionError(f"streamed mesh {m}: vertices match no host mesh")
        for name, table in (("normals", lib.normals), ("uvs", lib.uvs), ("tangents", lib.tangents)):
            if not np.array_equal(table[v0:v0 + nv].cpu().numpy(), getattr(host, name)):
                raise AssertionError(f"streamed mesh {m}: {name} differ")
        if not np.array_equal(lib.indices[t0:t0 + nt].cpu().numpy(), host.indices + v0):
            raise AssertionError(f"streamed mesh {m}: indices differ")
        if not np.array_equal(lib.tri_rec[t0:t0 + nt].cpu().numpy(), host_records(host)):
            raise AssertionError(f"streamed mesh {m}: tri_rec rows differ")
    return count - first_mesh


def runtime_phases(scene, cfg, renderer, frame_ms, city, path_launches, dev, card) -> None:
    """Phases 31-35: the committed glTF asset, streaming into the live bench
    scene, auto-capacity on the city walk, projectiles, the camera
    controller, checkpoints, the HUD's runtime lines and kernel reload.
    ``renderer`` is the base exact frame's (phase 7); ``city`` is phase
    20's (scene, config, frustum ms/frame)."""
    outputs = ("image", "vis", "soup")

    # 31. the committed colonnade.glb against its procedural twin --------------------
    t0 = time.perf_counter()
    b = load_gltf(ASSET, SceneBuilder(SceneLimits()))
    _colonnade_lights(b)
    glb = b.build(device=dev)
    t_load = time.perf_counter() - t0
    twin = colonnade_scene(device=dev)
    rot_rows = 0
    for part in ("meshes", "instances", "materials", "lights", "atlas", "skins"):
        for f, x, y in zip(getattr(glb, part)._fields, getattr(glb, part), getattr(twin, part)):
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y) and not (
                    (part, f) == ("instances", "rotation")
                    and float((x - y).abs().max()) <= 1.2e-7)):
                raise AssertionError(f"colonnade.glb differs from its twin in {part}.{f}")
    same_rot = (glb.instances.rotation == twin.instances.rotation).all(dim=1)
    rot_rows = int((~same_rot[:int(glb.instances.count)]).sum())
    cfg_col = dataclasses.replace(cfg, tri_capacity=COLONNADE_CAPACITY)
    cam = colonnade_camera(0, dev)
    a = Renderer(glb, cfg_col, outputs=outputs, device=dev).render(cam)
    t = Renderer(twin, cfg_col, outputs=outputs, device=dev).render(cam)
    tri = a["vis"].tri_id

    def moved(out):
        """Pixels showing an instance whose rotation the GLB's node matrix
        moved by an ulp."""
        tid = out["vis"].tri_id
        return (tid >= 0) & ~same_rot[out["soup"].instance[tid.clamp(min=0)]]

    # away from those instances, with their 8 neighbours (edge AA blends them)
    near = (moved(a) | moved(t)).float()[None, None]
    exact = torch.nn.functional.max_pool2d(near, 3, 1, 1)[0, 0] == 0
    same_id = float((visible_identity(a) == visible_identity(t)).float().mean())
    err_exact = (a["image"] - t["image"]).abs().amax(dim=-1)[exact].max().item()
    err_all = (a["image"] - t["image"]).abs().max().item()
    col_psnr = psnr(np.clip(a["image"].cpu().numpy(), 0, 1), np.clip(t["image"].cpu().numpy(), 0, 1))
    if (not torch.equal(tri[exact], t["vis"].tri_id[exact]) or err_exact > 1e-6
            or same_id < 0.999 or col_psnr < 50.0):
        raise AssertionError(f"colonnade: away from the moved instances tri_id equal "
                             f"{torch.equal(tri[exact], t['vis'].tri_id[exact])}, image error "
                             f"{err_exact}; visible triangle equal on {100 * same_id:.4f}% of "
                             f"pixels, PSNR {col_psnr:.2f} dB")
    prep = geometry.prepare_frame_columns(glb, cam)
    demand = int(geometry.expansion_demand(glb, prep.visible, prep.lod))
    r_col = Renderer(glb, cfg_col, outputs=outputs, device=dev)
    col_ms, out = launches_of(lambda: run_orbit(r_col, dev, cam_at=colonnade_camera,
                                                frames=COLONNADE_FRAMES),
                              COLONNADE_FRAMES + 1, "colonnade",
                              (COLONNADE_FRAMES + 1) * shades(r_col.cfg, r_col.config))
    path_launches["colonnade"] = COLONNADE_FRAMES + 1
    check_image(out)
    t0 = time.perf_counter()
    plain = swapped_plain_image(lambda: Renderer(glb, cfg_col, device=dev, replay=False).render(cam)["image"])
    if not torch.equal(plain, Renderer(glb, cfg_col, device=dev).render(cam)["image"]):
        raise AssertionError("colonnade frame differs between kernel and plain raster")
    t_swap = time.perf_counter() - t0
    clip, valid, bary = soup_at(Renderer(glb, cfg_col, outputs=outputs, device=dev), cam)
    col_line, col_kms, col_bound, _ = kernel_at_soup("colonnade soup", clip, valid, bary, card,
                                                     band_rows=SSAA_BAND_ROWS, exact=True)
    phase("colonnade", f"assets/colonnade.glb loaded and built in {t_load:.2f} s: "
                       f"{int(glb.instances.count)} instances, {int(glb.meshes.tri_count)} library "
                       f"triangles; every table equals colonnade_scene()'s but the rotation of "
                       f"{rot_rows} instances, within one ulp (the node matrix round trip); the "
                       f"demo pose, on the {int(exact.sum())} pixels away from those instances "
                       f"and their neighbours: tri_id identical, image max abs difference "
                       f"{err_exact:.1e} (gate 1e-6); over the frame: visible triangle equal on "
                       f"{100 * same_id:.4f}% of pixels (gate 99.9%), image max abs difference "
                       f"{err_all:.1e}, display-clamped PSNR {fmt_db(col_psnr)} dB (gate 50); "
                       f"expansion demand "
                       f"{demand} (capacity {2 * COLONNADE_CAPACITY}), soup.count "
                       f"{int(a['soup'].count)}; the demo's orbit: {col_ms:.2f} ms/frame = "
                       f"{1e3 / col_ms:.2f} FPS over {COLONNADE_FRAMES} frames after 1 warm-up; "
                       f"the frame with the plain raster swapped in: image identical "
                       f"({t_swap:.1f} s); {col_line}")
    profile_main_path("colonnade_profile", r_col, dev, card, cam_at=colonnade_camera)

    # 32. streaming into the live bench scene ------------------------------------------
    t0 = time.perf_counter()
    base = sponza_like_scene(N_INSTANCES, limits=SceneLimits(**STREAM_LIMITS),
                             texture_slots=STREAM_TEXTURES + 4, device=dev)
    torch.cuda.synchronize()
    t_base = time.perf_counter() - t0
    first_mesh, first_inst = int(base.meshes.mesh_count), int(base.instances.count)
    glb_meshes = load_gltf(ASSET, SceneBuilder(SceneLimits()))._meshes
    big = primitives.uv_sphere(rings=64, sectors=96)
    if len(big.positions) <= CHUNK_VERTS:
        raise AssertionError("the streamed sphere must be chunked")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (512, 512, 4), dtype=np.uint8) for _ in range(STREAM_TEXTURES)]
    _, spec_instances, _ = colonnade_spec()

    def request_all(streamer):
        streamer.request_mesh(ASSET, translation=(0.0, -0.99, 0.0))  # the floor, by path
        for mesh_idx, _mat, tr, q, sc in spec_instances[1:1 + STREAM_GLB_INSTANCES]:
            streamer.request_mesh(
                lambda i=mesh_idx: load_gltf(ASSET, SceneBuilder(SceneLimits()))._meshes[i],
                translation=tr, rotation=q, scale=sc)
        streamer.request_mesh(big, translation=(0.0, 2.5, 0.0), scale=3.0)
        return [streamer.request_texture(img) for img in images]

    def stream_run(stream: bool):
        live = clone_scene(base)
        r = Renderer(live, cfg, outputs=outputs, device=dev)
        streamer = arena = layers = None
        if stream:
            arena = Arena(STREAM_ARENA_BYTES, device=dev)
            streamer = SceneStreamer(live, budget=STREAM_BUDGET, arena=arena)
            layers = request_all(streamer)
        r.render(bench_camera(0, dev))  # warm-up
        torch.cuda.synchronize()
        per_frame = []
        t0 = time.perf_counter()
        with no_blocking_sync(True):
            for k in range(STREAM_FRAMES):
                if streamer is not None:
                    before = (streamer.stats["uploaded"], streamer.stats["chunks"])
                    streamer.pump()
                    per_frame.append((streamer.stats["uploaded"] - before[0],
                                      streamer.stats["chunks"] - before[1]))
                out = r.render(bench_camera(k, dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / STREAM_FRAMES
        return dict(ms=ms, out=out, renderer=r, scene=live, streamer=streamer, arena=arena,
                    layers=layers, per_frame=per_frame)

    n_requests = 1 + STREAM_GLB_INSTANCES + 1 + STREAM_TEXTURES
    turns = {}
    for mode in ("plain", "stream", "stream", "plain"):
        run = launches_of(lambda: stream_run(mode == "stream"), STREAM_FRAMES + 1,
                          f"streaming ({mode})", (STREAM_FRAMES + 1) * shades(cfg))
        turns.setdefault(mode, []).append(run)
        if mode == "stream" and len(turns["stream"]) == 1:
            run["streamer"].close()
            run["arena"].close()
    path_launches["streaming"] = 4 * (STREAM_FRAMES + 1)
    run = turns["stream"][1]
    streamer, arena, live = run["streamer"], run["arena"], run["scene"]
    deadline = time.perf_counter() + 60.0
    extra_pumps = 0
    with no_blocking_sync(True):  # uploads still decoding when the timed frames ended
        while streamer.stats["uploaded"] < n_requests and time.perf_counter() < deadline:
            streamer.pump()
            extra_pumps += 1
            time.sleep(0.01)
    if streamer.stats["uploaded"] != n_requests:
        raise AssertionError(f"streaming: {streamer.stats} of {n_requests} requests")
    cam_last = bench_camera(STREAM_FRAMES - 1, dev)
    with no_blocking_sync(True):
        last = run["renderer"].render(cam_last)
    n_meshes = streamed_meshes_match(live, first_mesh, glb_meshes + [big])
    for layer, img in zip(run["layers"], images):
        want = resize_bilinear_u8(img, (256, 256)).reshape(-1, 4).astype(np.uint32)
        words = want[:, 0] | (want[:, 1] << 8) | (want[:, 2] << 16) | (want[:, 3] << 24)
        got = live.atlas.packed_u32[layer * 256 * 256:(layer + 1) * 256 * 256].cpu().numpy()
        if not np.array_equal(got.view(np.uint32), words):
            raise AssertionError(f"streamed texture layer {layer} differs from its host texels")
    tri = last["vis"].tri_id
    inst = last["soup"].instance[tri.clamp(min=0)]
    streamed_px = int(((tri >= 0) & (inst >= first_inst)).sum())
    if streamed_px == 0:
        raise AssertionError("streaming: no pixel of the last frame shows a streamed instance")
    streamer.close()
    live_allocs = arena.stats()["live_allocs"]
    if live_allocs:
        raise AssertionError(f"streaming: {live_allocs} arena blocks live after close()")
    t0 = time.perf_counter()
    plain = swapped_plain_image(lambda: Renderer(live, cfg, device=dev, replay=False).render(cam_last)["image"])
    if not torch.equal(plain, Renderer(live, cfg, device=dev).render(cam_last)["image"]):
        raise AssertionError("streamed frame differs between kernel and plain raster")
    t_swap = time.perf_counter() - t0
    clip, valid, bary = soup_at(Renderer(live, cfg, outputs=outputs, device=dev), cam_last)
    st_line, st_kms, st_bound, _ = kernel_at_soup("streamed soup", clip, valid, bary, card,
                                                  band_rows=SSAA_BAND_ROWS, exact=True)
    phase("streaming", f"sponza_like_scene({N_INSTANCES}) with 2^18 vertices and triangles, "
                       f"256 meshes, texture_slots {STREAM_TEXTURES + 4}, built in {t_base:.1f} s; "
                       f"{n_requests} requests (colonnade.glb by path, {STREAM_GLB_INSTANCES} of "
                       f"its instances by callables, uv_sphere(64, 96) of {len(big.positions)} "
                       f"vertices, {STREAM_TEXTURES} 512x512 textures) through a page-locked "
                       f"{STREAM_ARENA_BYTES >> 20} MiB arena, budget {STREAM_BUDGET}; every pump "
                       f"and frame under sync-debug 'error'; (uploads, chunks) per timed frame "
                       f"{run['per_frame']}, {extra_pumps} more pumps until all {n_requests} "
                       f"landed; {n_meshes} streamed meshes read back: vertices, indices and "
                       f"tri_rec rows equal to the host meshes; texture layers {run['layers']} "
                       f"equal the host's resized texels; {streamed_px} pixels of the last frame "
                       f"show streamed instances; arena live blocks after close() {live_allocs}; "
                       f"ms/frame in turns plain, stream, stream, plain: plain "
                       f"{[round(x['ms'], 2) for x in turns['plain']]}, stream "
                       f"{[round(x['ms'], 2) for x in turns['stream']]} ({card}); the frame with "
                       f"the plain raster swapped in: image identical ({t_swap:.1f} s); {st_line}")

    # 33. auto-capacity on the city walk -------------------------------------------------
    city_scene_, cfg_city, frustum_ms = city
    ac = AutoCapacityRenderer(city_scene_, cfg_city, check_every=AUTOCAP_CHECK_EVERY,
                              outputs=outputs, device=dev)
    checks, check_ms = [], []
    demand_fn = ac.demand

    def timed_demand(camera):
        t0 = time.perf_counter()
        d = demand_fn(camera)
        check_ms.append((time.perf_counter() - t0) * 1e3)
        return d

    ac.demand = timed_demand
    n_frames = AUTOCAP_LAPS * CITY_FRAMES
    caps, last_ms = [], None

    def walk():
        nonlocal last_ms
        for k in range(n_frames):
            if k == n_frames - CITY_FRAMES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            caps.append(ac.capacity)
            ac.render(city_camera(k % CITY_FRAMES, dev))
            if (k + 1) % AUTOCAP_CHECK_EVERY == 0:
                checks.append((k, ac.capacity, ac.stats["last_demand"], ac.stats["last_count"]))
        torch.cuda.synchronize()
        last_ms = (time.perf_counter() - t0) * 1e3 / CITY_FRAMES

    launches_of(walk, n_frames, "autocap", n_frames * shades(cfg_city))
    path_launches["autocap"] = n_frames
    over = []
    for k in range(n_frames - CITY_FRAMES, n_frames):
        cam = city_camera(k % CITY_FRAMES, dev)
        p = geometry.prepare_frame_columns(city_scene_, cam)
        d = int(geometry.expansion_demand(city_scene_, p.visible, p.lod))
        if d > 2 * caps[k]:
            over.append((k, d, caps[k]))
    if over:
        raise AssertionError(f"autocap: the last lap's frames exceed their tier: {over}")
    phase("autocap", f"AutoCapacityRenderer over city_scene({CITY_GRID})'s walk, {AUTOCAP_LAPS} laps "
                     f"of {CITY_FRAMES} poses, check_every {AUTOCAP_CHECK_EVERY}, ladder "
                     f"{ac.ladder}: (frame, tier after the check, demand, draw-list count) "
                     f"{checks}; host ms of each blocking check "
                     f"{[round(v, 2) for v in check_ms]}; {ac.stats['tier_switches']} tier switches; "
                     f"the last lap at tiers {sorted(set(caps[-CITY_FRAMES:]))}, no frame's demand "
                     f"above its tier's expansion capacity; last lap {last_ms:.2f} ms/frame against "
                     f"phase 20's fixed 2^18 frustum walk {frustum_ms:.2f} ({card})")

    # 34. projectiles, the camera controller, checkpoints and the HUD ----------------
    proj_scene = clone_scene(scene)
    projectiles = ProjectileSystem(proj_scene, mesh_id=1, material_id=0, capacity=PROJECTILES)
    r_proj = Renderer(proj_scene, cfg, outputs=outputs, device=dev)

    def projectile_run():
        projectiles.step()
        r_proj.render(bench_camera(0, dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_blocking_sync(True):
            for k in range(FRAMES):
                projectiles.step(spawn_pos=(0.0, 1.0, 0.0), spawn_vel=(2.0, 4.0, 0.0))
                out = r_proj.render(bench_camera(k, dev))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / FRAMES, out

    proj_ms, out = launches_of(projectile_run, FRAMES + 1, "projectiles",
                               (FRAMES + 1) * shades(r_proj.cfg, r_proj.config))
    path_launches["projectiles"] = FRAMES + 1
    check_image(out)
    alive = projectiles.alive_count()
    if alive == 0:
        raise AssertionError("projectiles: none alive after the orbit")
    state = CameraState(position=np.array([18 * math.sin(0.3), 6.0, 18 * math.cos(0.3)],
                                          np.float32), yaw=0.3, pitch=-0.3)

    def controller_run():
        nonlocal state
        frames = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CONTROLLER_FRAMES):
            state = controller_step(state, InputFrame(forward=1.0, look_dx=0.01, speed=6.0),
                                    1 / 30)
            frames.append(renderer.render(to_camera(state, fov_y=0.9, aspect=WIDTH / HEIGHT,
                                                    near=0.1, far=200.0, device=dev))["image"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / CONTROLLER_FRAMES, frames

    ctl_ms, frames = launches_of(controller_run, CONTROLLER_FRAMES, "camera controller",
                                 CONTROLLER_FRAMES * shades(renderer.cfg, renderer.config))
    path_launches["camera_controller"] = CONTROLLER_FRAMES
    if not all(bool(torch.isfinite(f).all()) for f in frames) or torch.equal(frames[0], frames[-1]):
        raise AssertionError("camera controller: frames not finite or not moving")
    prefix = os.path.join(enable_persistent_cache(), "chip_smoke_checkpoint")
    r_stream = run["renderer"]
    save_renderer(prefix, r_stream)
    fresh = Renderer(clone_scene(base), cfg, outputs=outputs, device=dev)
    load_renderer(prefix, fresh)
    cam_next = bench_camera(FRAMES, dev)
    a, b = launches_of(lambda: (r_stream.render(cam_next), fresh.render(cam_next)), 2,
                       "checkpoint", shades(r_stream.cfg, r_stream.config)
                       + shades(fresh.cfg, fresh.config))
    if not (torch.equal(a["image"], b["image"]) and torch.equal(a["vis"].tri_id, b["vis"].tri_id)):
        raise AssertionError("checkpoint: the loaded renderer's next frame differs")
    path_launches["checkpoint"] = 2
    ck_bytes = sum(os.path.getsize(prefix + ext) for ext in (".scene.npz", ".state.npz"))
    stats = FrameStats()
    stats.samples = [proj_ms / 1e3] * FRAMES
    text = format_hud(r_stream, frame_stats=stats, arena=arena, streamer=streamer)
    runtime_lines = [ln for ln in text.split("\n") if ln.startswith(("fps", "staging arena",
                                                                       "streaming"))]
    if len(runtime_lines) != 3:
        raise AssertionError(f"HUD: runtime lines missing in {text!r}")
    arena.close()
    phase("runtime_extras", f"bench frame with {PROJECTILES} projectile slots stepped before each "
                            f"frame, under sync-debug 'error': {proj_ms:.2f} ms/frame over "
                            f"{FRAMES} frames (base {frame_ms:.2f}), {alive} alive at the end; the "
                            f"camera controller drove {CONTROLLER_FRAMES} frames at "
                            f"{ctl_ms:.2f} ms/frame; the streamed renderer saved "
                            f"({ck_bytes / 2**20:.1f} MiB of .npz) and loaded into a fresh one: "
                            f"the next frame identical bit for bit; HUD: "
                            + " | ".join(runtime_lines) + f" ({card})")

    # 35. kernel reload on the bench renderer ----------------------------------------------
    reloader = KernelReloader(renderer)
    cam0 = bench_camera(0, dev)
    before = renderer.render(cam0)
    kernel_obj, launches_before = rc.RASTER_TILES, rc.RASTER_TILES.launches
    for path in (importlib.import_module(RELOAD_MODULE).__file__, rc.LIBRARY.source):
        st = os.stat(path)
        os.utime(path, (st.st_atime, st.st_mtime + 1.0))  # contents unchanged
    t0 = time.perf_counter()
    swapped = reloader.poll()
    reload_ms = (time.perf_counter() - t0) * 1e3
    if not swapped or reloader.stats != {"reloads": 1, "failures": 0}:
        raise AssertionError(f"reload: poll {swapped}, stats {reloader.stats}, "
                             f"{reloader.last_error}")
    after = launches_of(lambda: renderer.render(cam0), 1, "reload",
                        shades(renderer.cfg, renderer.config))
    path_launches["reload"] = 1
    if not (torch.equal(before["image"], after["image"])
            and torch.equal(before["vis"].tri_id, after["vis"].tri_id)):
        raise AssertionError("reload: the frame after differs from the frame before")
    if rc.RASTER_TILES is not kernel_obj or KERNELS[0] is not kernel_obj:
        raise AssertionError("reload: kernel 1's CudaKernel object was replaced")
    phase("reload", f"{len(reloader.modules)} modules and {len(reloader.sources)} kernel sources "
                    f"watched; {RELOAD_MODULE} and {os.path.relpath(rc.LIBRARY.source, ROOT)} "
                    f"touched (contents unchanged): poll() True in {reload_ms:.1f} ms of host "
                    f"time, stats {reloader.stats}; the frame after equals the frame before bit "
                    f"for bit; kernel 1's CudaKernel is the same object and counted the frame's "
                    f"launch ({launches_before} launches before the reload) ({card})")


def plain_run(name: str, changes: dict, switches: dict, dev, frames: int, warmup: bool):
    """The plain configuration on ``dev`` with the JAX demo's scene ``name``
    at its size and capacity: a warm-up frame (if ``warmup``), then
    ``frames`` frames of the demo's orbit (angle 0.5 + 0.02k, clip time
    k/60), on the card under sync-debug "error", and on the card one more
    frame traced for its device busy time. Returns (per frame (image,
    visible identity) on the host, ms/frame, busy ms of the traced frame or
    None, the last frame's soup count, frames rendered, the renderer's
    shadow slots)."""
    scene = build_demo_scene(name, dev)
    cfg = PipelineConfig(width=DEMO_SIZE, height=DEMO_SIZE, tri_capacity=PLAIN_CAPACITY,
                         skinning=name == "skinned", tile_raster=False, **changes)
    r = Renderer(scene, cfg, outputs=("image", "vis", "soup"), device=dev)
    r.set_config(**switches)
    r.apply_config_now()

    def frame(k):
        return r.render(make_demo_camera(name, 0.5 + 0.02 * k, dev), time_s=k / 60.0)

    if warmup:
        frame(0)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_blocking_sync(on_card):
        outs = [frame(k) for k in range(frames)]
    if on_card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / frames
    busy = device_busy_ms(lambda: frame(frames)) if on_card else None
    rendered = int(warmup) + frames + int(on_card)
    return ([(o["image"].cpu().numpy(), visible_identity(o).cpu().numpy()) for o in outs], ms,
            busy, int(outs[-1]["soup"].count), rendered,
            trt.slot_lights(r.atlas_casts, r.cfg.shadow_slots))


def plain_launches_wanted(changes: dict, switches: dict, rendered: int, slots) -> dict:
    """Each kernel's launches for ``rendered`` plain frames of the config
    ``changes``: kernel 5 once per frame and per atlas view rendered
    (shadows), kernel 6 once per traced directional slot (rt), kernels 7
    and 8 ``shades`` and ``signatures`` times per frame, no other kernel."""
    views = sum(atlas_views(slots))
    traced = sum(1 for sl in slots if sl is not None and sl[1])
    want = {k.symbol: 0 for k in KERNELS}
    # the atlas's views on the first (eager) frame only: the demo scenes are
    # static, so a replay's conditional nodes skip every slot
    atlas = views * (1 if control.conditional_nodes()[0] else rendered)
    want[rs.SCAN_RASTER.symbol] = rendered + (atlas if switches.get("shadows") else 0)
    want[brute.RT_BRUTE.symbol] = rendered * (traced if switches.get("rt") else 0)
    want[tpbr.SHADE.symbol] = rendered * shades(PipelineConfig(**changes), switches)
    want[tshadow.SIGNATURE.symbol] = rendered * signatures(PipelineConfig(**changes), switches)
    return want


def device_busy_ms(fn) -> float:
    """Device busy ms of one call of ``fn`` (the profiler's CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def held_to_cpu(label: str, card_frames, cpu_frames, db: float) -> str:
    """Each card frame against the same frame on the CPU path: the visible
    triangle equal on >= 99.9% of pixels and display-clamped PSNR >= db.
    Returns the worst of each, formatted."""
    same, worst = 1.0, math.inf
    for (img, ident), (cimg, cident) in zip(card_frames, cpu_frames, strict=True):
        if not np.isfinite(img).all():
            raise AssertionError(f"{label}: image not finite")
        same = min(same, float((ident == cident).mean()))
        worst = min(worst, psnr(np.clip(img, 0, 1), np.clip(cimg, 0, 1)))
    if same < 0.999 or worst < db:
        raise AssertionError(f"{label}: card against CPU path: visible triangle equal on "
                             f"{100 * same:.3f}% of pixels, PSNR {worst:.2f} dB (want >= 99.9%, "
                             f">= {db} dB)")
    return f"CPU path: triangle equal {100 * same:.3f}%, PSNR >= {fmt_db(worst)} dB"


# per kernel of the plain paths (5 and 6), its launches per path of phases 36-37
plain_path_launches = {rs.SCAN_RASTER.symbol: {}, brute.RT_BRUTE.symbol: {}}


def plain_phases(scene, cfg, path_launches, dev, card) -> None:
    """Phase 36: the plain configuration (tile_raster=False) on the card:
    the JAX demo's scenes, their shadowed, rt and checkerboard frames, the
    plain frame against the tile frame, render_forward and the demo; then
    the rt cells the tile configuration left open: rt_scale 2 and 4 against
    1 at the bench, a point-light slot through kernel 2, and the brute-force
    planes against the grid's. Every card run comes first; the demo then
    renders on the card while the same frames render on the CPU path."""
    cpu = torch.device("cpu")
    runs = [(name, "orbit", {}, {}, PLAIN_FRAMES) for name in PLAIN_SCENES]
    runs += [(name, sw, *PLAIN_SWITCHES[sw], 1) for name in PLAIN_SWITCH_SCENES
             for sw in PLAIN_SWITCHES]
    card_runs, launched = [], {k.symbol: 0 for k in KERNELS}
    for name, label, changes, switches, n in runs:
        for k in KERNELS:
            k.launches = 0
        card_runs.append(plain_run(name, changes, switches, dev, n, warmup=True))
        got = {k.symbol: k.launches for k in KERNELS}
        want = plain_launches_wanted(changes, switches, *card_runs[-1][4:])
        if got != want:
            raise AssertionError(f"plain {name} {label}: launches {got}, want {want}")
        launched = {k: launched[k] + v for k, v in got.items()}
        path = "plain_" + label
        for k in (rs.SCAN_RASTER, brute.RT_BRUTE):
            if got[k.symbol]:
                plain_path_launches[k.symbol][path] = (
                    plain_path_launches[k.symbol].get(path, 0) + got[k.symbol])
    path_launches["plain"] = launched[rc.RASTER_TILES.symbol]
    # the textured plain frame against the tile frame (kernel 1), the JAX
    # package's tests/test_pipeline.py:117 gate
    tile = Renderer(build_demo_scene("textured", dev),
                    PipelineConfig(width=DEMO_SIZE, height=DEMO_SIZE, tri_capacity=PLAIN_CAPACITY),
                    device=dev)
    img_tile = tile.render(make_demo_camera("textured", 0.5, dev))["image"].cpu().numpy()
    err = np.abs(img_tile - card_runs[PLAIN_SCENES.index("textured")][0][0][0])
    orbit_ms = {name: run[1] for (name, label, *_), run in zip(runs, card_runs) if label == "orbit"}
    if not ((err < 0.02).mean() > 0.95 and err.mean() < 0.005):
        raise AssertionError(f"plain against tile frame: error < 0.02 on "
                             f"{100 * (err < 0.02).mean():.2f}%, mean {err.mean():.5f}")

    # render_forward on mixed
    from renderer_tpu_torch.passes.forward import render_forward

    def forward(d):
        scene_d, cam_d = build_demo_scene("mixed", d), make_demo_camera("mixed", 0.5, d)
        return lambda: render_forward(scene_d, cam_d, DEMO_SIZE, DEMO_SIZE, PLAIN_CAPACITY)

    fwd = forward(dev)
    for k in KERNELS:
        k.launches = 0
    fwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_blocking_sync(True):
        img, vis = fwd()
    torch.cuda.synchronize()
    f_ms = (time.perf_counter() - t0) * 1e3
    f_busy = device_busy_ms(fwd)
    f_launches = {k.symbol: k.launches for k in KERNELS}
    if f_launches != {k.symbol: 3 if k is rs.SCAN_RASTER else 0 for k in KERNELS}:
        raise AssertionError(f"render_forward, 3 calls: launches {f_launches}")
    plain_path_launches[rs.SCAN_RASTER.symbol]["forward"] = 3

    env = dict(os.environ, PYTHONPATH=ROOT)
    demo_png = os.path.join(enable_persistent_cache(), "demo_plain_rt.png")
    if os.path.exists(demo_png):
        os.remove(demo_png)
    demo_proc = subprocess.Popen(  # on the card while the CPU path renders below
        [sys.executable, "-m", "renderer_tpu_torch.demo", "--size", str(DEMO_SIZE), "--out",
         demo_png, "--frames", "3", "--check-sync", *PLAIN_DEMO],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    for (name, label, changes, switches, n), (frames, ms, busy, count, *_) in zip(runs, card_runs):
        t0 = time.perf_counter()
        # a warm-up only under shadows (the cached atlas): the other frames
        # keep no state between frames
        cpu_frames = plain_run(name, changes, switches, cpu, n, warmup="shadows" in switches)[0]
        cpu_ms = (time.perf_counter() - t0) * 1e3 / n
        loose = name == "skinned" or "shadows" in switches or "rt" in switches
        held = held_to_cpu(f"{name} {label}", frames, cpu_frames,
                           PLAIN_DB_LOOSE if loose else PLAIN_DB)
        against = (f" (orbit frame {orbit_ms[name]:.1f} ms: {ms - orbit_ms[name]:+.1f} ms)"
                   if label != "orbit" else "")
        lines.append(f"{name} {label} ({n} frames): {ms:.1f} ms/frame{against}, busy {busy:.1f} "
                     f"ms/frame (idle {100 * max(0.0, 1 - busy / ms):.1f}%), soup.count {count}, "
                     f"{held} (CPU {cpu_ms:.0f} ms/frame)")
    phase("plain", f"{len(runs)} plain-configuration runs at {DEMO_SIZE}x{DEMO_SIZE}, "
                   f"tri_capacity {PLAIN_CAPACITY}, trilinear, each after a warm-up frame, under "
                   f"sync-debug \"error\"; busy from one more traced frame; kernel launches on the "
                   f"plain paths, each run counted from 0, summed {launched} ({card}): "
          + "; ".join(lines)
          + f"; textured plain against tile frame: error < 0.02 on "
            f"{100 * (err < 0.02).mean():.3f}% of pixels, mean {err.mean():.2e}")
    cimg, cvis = forward(cpu)()
    held = held_to_cpu("render_forward", [(img.cpu().numpy(), vis.tri_id.cpu().numpy())],
                       [(cimg.numpy(), cvis.tri_id.numpy())], PLAIN_DB)
    phase("plain_forward", f"render_forward on mixed at {DEMO_SIZE}x{DEMO_SIZE}: {f_ms:.1f} ms, "
                           f"busy {f_busy:.1f} ms, under sync-debug \"error\", kernel 5 "
                           f"launches 3 for 3 calls (no count, as in JAX), coverage "
                           f"{float((vis.tri_id >= 0).float().mean()):.3f}; {held} ({card})")
    try:
        log, _ = demo_proc.communicate(timeout=DEMO_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        demo_proc.kill()
        log, _ = demo_proc.communicate()
    if demo_proc.returncode != 0 or not os.path.exists(demo_png):
        raise AssertionError(f"demo {' '.join(PLAIN_DEMO)} (exit {demo_proc.returncode}): "
                             f"{log[-2000:]}")
    png = read_png(demo_png)
    if png.shape != (DEMO_SIZE, DEMO_SIZE, 3) or png.std() < 2.0:
        raise AssertionError(f"demo {' '.join(PLAIN_DEMO)}: PNG {png.shape}, std {png.std():.2f}")
    steady = [ln for ln in log.splitlines() if ln.startswith("steady-state")]
    phase("plain_demo", f"python -m renderer_tpu_torch.demo {' '.join(PLAIN_DEMO)} --size "
                        f"{DEMO_SIZE} --frames 3 --check-sync, on the card while the CPU path "
                        f"rendered: exit 0, {os.path.relpath(demo_png, ROOT)} written; "
                        f"{steady[0] if steady else 'no steady-state line'} ({card})")

    # rt_scale 2 and 4 against 1 at the bench (tile configuration, kernel 2) ----
    gate = {}
    for s in (1, 2, 4):
        r = Renderer(scene, dataclasses.replace(cfg, rt_scale=s), device=dev)
        r.set_config(rt=True)
        r.apply_config_now()
        gate[s] = gate_frames(r, dev)
    db2, db4 = psnr_min(gate[2], gate[1]), psnr_min(gate[4], gate[1])
    phase("rt_scales", f"bench rt frame, min over the gate poses "
                       f"{[round(a, 3) for a in GATE_ANGLES]} of display-clamped "
                       f"PSNR against rt_scale 1: rt_scale 2 {fmt_db(db2)} dB, rt_scale 4 "
                       f"{fmt_db(db4)} dB (gate {GATE_DB} dB: "
                       f"{'met' if db2 >= GATE_DB else 'missed'}, "
                       f"{'met' if db4 >= GATE_DB else 'missed'}; reported, not enforced) ({card})")

    # a point-light slot through kernel 2 ---------------------------------------
    pscene = build_demo_scene("mixed", dev)
    pscene.lights.shadow_slot[0] = POINT_SLOT  # the point light casts: six cube faces
    pcfg = PipelineConfig(width=DEMO_SIZE, height=DEMO_SIZE, tri_capacity=PLAIN_CAPACITY)
    pr = Renderer(pscene, pcfg, device=dev, replay=False)  # its second frame is recorded
    pr.set_config(rt=True)
    pr.apply_config_now()
    pcam = make_demo_camera("mixed", 0.5, dev)
    pr.render(pcam)
    oc.OCCLUSION_TILES.launches = 0
    with Recorder(trt, "occlusion_grid") as rec:
        p_img = pr.render(pcam)["image"]
    p_launches = oc.OCCLUSION_TILES.launches
    worst_faces = 0
    for args, _, _ in rec.calls:
        ins = trt.occlusion_inputs(*args)
        got, want = oc.occlusion_kernel(*ins), oc.occlusion_tiles_plain(*ins)
        worst_faces += int((got != want).sum())
    if worst_faces or p_launches != len(rec.calls) or len(rec.calls) != 7:
        raise AssertionError(f"point-light slot: {len(rec.calls)} traces, {p_launches} launches, "
                             f"{worst_faces} receivers differ from the plain version")
    kernel = trt.occlusion_kernel
    trt.occlusion_kernel = oc.occlusion_tiles_plain
    try:
        p_plain = pr.render(pcam)["image"]
    finally:
        trt.occlusion_kernel = kernel
    if not torch.equal(p_img, p_plain):
        raise AssertionError("point-light rt frame differs with the plain occlusion walk")
    p_ms = host_ms(lambda: pr.render(pcam))
    phase("rt_point", f"mixed at {DEMO_SIZE}x{DEMO_SIZE} with its point light in slot "
                      f"{POINT_SLOT} and the sun in slot 0, rt_scale 2: {len(rec.calls)} occlusion "
                      f"walks per frame (1 + 6 cube faces) = kernel 2 launches {p_launches}, each "
                      f"face's plane equal to the plain version's, the frame identical with the "
                      f"plain walk swapped in; {p_ms:.1f} ms/frame ({card})")

    # the brute-force planes against the grid's at rt_scale 1 on mixed ------------
    planes = {}
    for tile_raster in (True, False):
        br = Renderer(build_demo_scene(BRUTE_SCENE, dev),
                      PipelineConfig(width=DEMO_SIZE, height=DEMO_SIZE, tri_capacity=PLAIN_CAPACITY,
                                     rt_scale=1, tile_raster=tile_raster),
                      outputs=("image", "vis"), device=dev)
        br.set_config(rt=True)
        br.apply_config_now()
        fn = "rt_shadow_grid" if tile_raster else "rt_shadow_planes"
        with Recorder(tpbr, fn) as rec:
            out = br.render(make_demo_camera(BRUTE_SCENE, 0.5, dev))
        planes[tile_raster] = (rec.calls[0][2][0], out["vis"].tri_id >= 0,
                               np.clip(out["image"].cpu().numpy(), 0, 1))
    (g_plane, g_cov, g_img), (b_plane, b_cov, b_img) = planes[True], planes[False]
    both = g_cov & b_cov
    differ = float(((g_plane != b_plane) & both).sum()) / max(1, int(both.sum()))
    plane_db = 10 * math.log10(1.0 / differ) if differ > 0 else math.inf
    phase("brute_vs_grid", f"{BRUTE_SCENE} at {DEMO_SIZE}x{DEMO_SIZE}, rt_scale 1, the sun's slot: "
                           f"brute-force and grid lit planes differ on {100 * differ:.3f}% of the "
                           f"pixels both rasters cover = PSNR {fmt_db(plane_db)} dB; images "
                           f"{fmt_db(psnr(g_img, b_img))} dB ({card})")


def scan_bound(inp, count, width: int, height: int, tri_block: int):
    """Kernel 5's least time: bytes, the walked triangles' setup read once
    and the five output planes written once; operations, OPS_PER_PAIR per
    (pixel, triangle) pair of a walked live triangle whose bbox holds the
    pixel centre. Returns (ms, bound by, walked triangles, pairs)."""
    walked = rs.live_blocks(count, inp.adj.shape[0], tri_block) * tri_block
    bb = inp.bb[:walked].double()
    (x0, x1), (y0, y1) = (centre_span(bb[:, 0], bb[:, 1], 0, width),
                          centre_span(bb[:, 2], bb[:, 3], 0, height))
    inside = (x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0)
    pairs = int(torch.where(inp.tri_ok[:walked] & torch.isfinite(inside), inside, 0).sum())
    ms, by = bound(walked * SCAN_BYTES_PER_TRI + 4 + 5 * 4 * width * height,
                   pairs * OPS_PER_PAIR)
    return ms, by, walked, pairs


def brute_bound(inp, count):
    """Kernel 6's least time: bytes, the origins and the walked triangles'
    setup read once and the plane written once; operations, those of the
    (receiver, live triangle) pairs the early exit leaves (the live
    triangles a receiver tests in order up to its first hit, all of them
    for a lit one), each as far as its test needs: u (three products, two
    sums, the constant, f and a compare: 8), then v (8) if u >= 0, u + v
    and its compare (2) if v >= 0 too, and t (8) if u + v <= 1, counted on
    the device. Returns (ms, bound by, walked triangles, pairs, ops)."""
    origin, cvec, consts, f, live = inp
    p, step = origin.shape[1], 1 << 16
    walked = rs.live_blocks(count, cvec.shape[0], brute.BLOCK) * brute.BLOCK
    occluded = torch.zeros(p, dtype=torch.bool, device=origin.device)
    pairs = ops = 0
    order = torch.arange(brute.BLOCK, device=origin.device)
    for b0 in range(0, walked, brute.BLOCK):
        sl = slice(b0, b0 + brute.BLOCK)
        lv, cv, fb = live[sl], cvec[sl], f[sl]
        for p0 in range(0, p, step):
            o = origin[:, p0:p0 + step, None, None]
            s_ = o[0] * cv[..., 0] + o[1] * cv[..., 1] + o[2] * cv[..., 2] - consts[sl]
            u, v, t = s_[..., 0] * fb, s_[..., 1] * fb, s_[..., 2] * fb
            u_ok = u >= 0.0
            uv_ok = u_ok & (v >= 0.0)
            in_tri = uv_ok & (u + v <= 1.0)
            hit = in_tri & (t > brute.EPS) & lv
            has = hit.any(dim=1)
            first = torch.where(has, hit.int().argmax(dim=1), brute.BLOCK - 1)
            occ = occluded[p0:p0 + step]
            tested = lv & (order <= first[:, None]) & ~occ[:, None]
            pairs += int(tested.sum())
            ops += int(torch.where(tested, 8 + 8 * u_ok.int() + 2 * uv_ok.int() + 8 * in_tri.int(),
                                   0).sum())
            occluded[p0:p0 + step] = occ | has
    ms, by = bound(p * 16 + walked * BRUTE_BYTES_PER_TRI + 4, ops)
    return ms, by, walked, pairs, ops


def scan_raster_phase(scene, cfg, dev, card) -> dict:
    """Phase 37: kernel 5 against its plain version on the raster cases,
    the edge cases of its design, at phase 36's mixed soups and at the
    plain bench frame's camera soup; its launches on the reference view;
    its time and bound, and its design's sizes at each soup. Returns its
    kernels-line entry, whose ms is the time per call inside a captured
    graph of GRAPH_CALLS calls."""
    worst_cases = 0
    raster_cases = [(name, build, w, h, cull, (*SCAN_COUNTS, build()[0].shape[0]))
                    for name, (build, w, h, _) in sorted(CASES.items()) for cull in (True, False)]
    raster_cases += [(name, build, w, h, cull, counts)
                     for name, (build, w, h, cull, counts) in sorted(RASTER_CASES.items())]
    for name, build, w, h, cull, counts in raster_cases:
        clip, valid = build()
        t_cap = clip.shape[0]
        inp = rs.scan_inputs(torch.from_numpy(clip).to(dev), torch.from_numpy(valid).to(dev),
                             w, h, cull)
        for count in counts:
            c = torch.tensor(count, dtype=torch.int32, device=dev)
            for with_bary in (True, False):
                got = rs.scan_raster_kernel(inp, c, w, h, min(128, t_cap), with_bary)
                want = rs.scan_raster_plain(inp, count, w, h, min(128, t_cap), with_bary)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"kernel 5 differs from its plain version on {name}, "
                                         f"cull {cull}, count {count}, bary {with_bary}")
                worst_cases += 1

    # the soups of phase 36's mixed frame: camera and reference view, then
    # the atlas's views with the point light in a slot (sun slot + 6 faces)
    def mixed_renderer(tile_raster=False, point=False, **switches):
        scene = build_demo_scene("mixed", dev)
        if point:
            scene.lights.shadow_slot[0] = POINT_SLOT
        r = Renderer(scene, PipelineConfig(width=DEMO_SIZE, height=DEMO_SIZE,
                                           tri_capacity=PLAIN_CAPACITY, tile_raster=tile_raster),
                     outputs=("image", "vis", "soup"), device=dev)
        r.set_config(**switches)
        r.apply_config_now()
        return r

    cam = make_demo_camera("mixed", 0.5, dev)
    soups, launch_lines = [], []
    for label, path, tile_raster, point, switches, module, names in (
            ("plain frame + reference view", "plain_reference", False, False,
             dict(reference_image=True), pipeline_module, ("camera", "reference view")),
            ("tile frame + reference view", "tile_reference", True, False,
             dict(reference_image=True), pipeline_module, ("reference view",)),
            ("plain shadowed frame, point light in a slot", "plain_point_shadows", False, True,
             dict(shadows=True), tshadow, ("sun slot",) + ("cube face",) * 6)):
        r = mixed_renderer(tile_raster, point, **switches)
        for k in KERNELS:
            k.launches = 0
        with Recorder(module, "rasterize_scan") as rec:
            r.render(cam)
        got = {k.symbol: k.launches for k in KERNELS}
        n_scan = len(rec.calls) + (1 if module is tshadow else 0)  # the camera's own call
        want = {k.symbol: 0 for k in KERNELS}
        want[rs.SCAN_RASTER.symbol] = n_scan
        want[rc.RASTER_TILES.symbol] = int(tile_raster)
        want[tpbr.SHADE.symbol] = shades(r.cfg, r.config)
        want[tshadow.SIGNATURE.symbol] = signatures(r.cfg, r.config)
        if got != want:
            raise AssertionError(f"{label}: launches {got}, want {want}")
        if len(rec.calls) != len(names):
            raise AssertionError(f"{label}: {len(rec.calls)} scan raster calls, want {len(names)}")
        plain_path_launches[rs.SCAN_RASTER.symbol][path] = got[rs.SCAN_RASTER.symbol]
        launch_lines.append(f"{label}: kernel 5 launches {got[rs.SCAN_RASTER.symbol]}, kernel 1 "
                            f"{got[rc.RASTER_TILES.symbol]}")
        soups += [(f"{label}, {n} {c[0][2]}x{c[0][3]}", c) for n, c in zip(names, rec.calls)]
    # the plain bench frame's camera soup (orbit angle 0.3)
    r = Renderer(scene, dataclasses.replace(cfg, tile_raster=False),
                 outputs=("image", "vis", "soup"), device=dev, replay=False)
    with Recorder(pipeline_module, "rasterize_scan") as rec:
        r.render(bench_camera(0, dev))
    soups.append((f"plain bench frame, camera {WIDTH}x{HEIGHT}", rec.calls[0]))
    lines, entry = [], None
    for label, (args, kwargs, out) in soups:
        clip, valid, w, h = args
        count = kwargs.get("count")
        with_bary = kwargs.get("with_bary", True)
        inp = rs.scan_inputs(clip, valid, w, h, kwargs.get("cull_backface", True))
        tb = min(128, clip.shape[0])
        got = rs.scan_raster_kernel(inp, count, w, h, tb, with_bary)
        want = [None]
        p_ms = host_ms(lambda: want.__setitem__(0, rs.scan_raster_plain(inp, count, w, h, tb,
                                                                        with_bary)))
        unbounded = rs.scan_raster_kernel(inp, None, w, h, tb, with_bary)
        for a, b, c_, o in zip(got, want[0], unbounded, out):
            if not (torch.equal(a, b) and torch.equal(a, c_) and torch.equal(a, o)):
                raise AssertionError(f"kernel 5 at {label}: kernel, plain version, unbounded "
                                     "walk and the frame's own call differ")
        k_ms = cuda_ms(lambda: rs.scan_raster_kernel(inp, count, w, h, tb, with_bary), 20)
        u_ms = cuda_ms(lambda: rs.scan_raster_kernel(inp, None, w, h, tb, with_bary), 5)
        k_dev = sum(device_us_by_kernel(
            lambda: rs.scan_raster_kernel(inp, count, w, h, tb, with_bary), 20).values()) / 1e3
        u_dev = sum(device_us_by_kernel(
            lambda: rs.scan_raster_kernel(inp, None, w, h, tb, with_bary), 5).values()) / 1e3
        k_graph = graph_ms_per_call(lambda: rs.scan_raster_kernel(inp, count, w, h, tb, with_bary))
        b_ms, b_by, walked, pairs = scan_bound(inp, count, w, h, tb)
        lines.append(f"{label}: count {int(count)}, {walked} triangles walked of "
                     f"{clip.shape[0]}, {pairs} pixel pairs, design "
                     f"{json.dumps(rs.kernel_design(clip.shape[0], w, h))}; kernel in a graph "
                     f"of {GRAPH_CALLS} "
                     f"calls {k_graph:.5f} ms a call, by events / device {k_ms:.4f} / "
                     f"{k_dev:.4f} ms (unbounded walk {u_ms:.4f} / {u_dev:.4f}), plain "
                     f"{p_ms:.1f} ms, bound {b_ms:.5f} ms by {b_by} = "
                     f"{100 * b_ms / k_graph:.1f}% of the graph's time a call, "
                     f"{100 * b_ms / k_ms:.1f}% of the events' time, "
                     + (f"{100 * b_ms / k_dev:.1f}% of the device time" if k_dev > 0 else
                        "the device time not measured (the profiler saw no device event)"))
        if entry is None:  # the plain frame's camera soup: the main path's call
            lines.append("its time a call read otherwise: " + call_readings(
                lambda: rs.scan_raster_kernel(inp, count, w, h, tb, with_bary)))
            entry = dict(name="scan_raster", route="cuda",
                         source="renderer_tpu_torch/csrc/scan_raster.cu",
                         replaces="renderer_tpu/ops/raster_jax.py:183", launches=None,
                         max_abs_err=0.0, ms=k_graph, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)
    phase("scan_raster", f"kernel 5 against its plain version, identical depth, tri_id and "
                         f"barycentrics: {len(CASES)} raster cases x cull on/off x counts "
                         f"{list(SCAN_COUNTS)} and capacity, and {len(RASTER_CASES)} edge cases "
                         f"{sorted(RASTER_CASES)} at their counts, x bary on/off ({worst_cases} "
                         f"calls); "
                         + "; ".join(launch_lines) + "; at each soup, bounded = unbounded = the "
                         "frame's own call: " + "; ".join(lines) + f" ({card})")
    return entry


def rt_brute_phase(dev, card) -> dict:
    """Phase 38: kernel 6 against its plain version on the edge cases of its
    design and at phase 36's mixed rt soup, rt_scale 2 and 1; its time and
    bound. Returns its kernels-line entry (rt_scale 2; ms per call inside a
    captured graph, as in phase 37)."""
    n_edge = 0
    for name, (build, counts) in sorted(BRUTE_CASES.items()):
        world, normal, direction, tri, valid = build()
        inp = brute.brute_inputs(*(torch.from_numpy(a).to(dev)
                                   for a in (world, normal, direction, tri, valid)))
        for c in counts:
            got = brute.rt_brute_kernel(inp, torch.tensor(c, dtype=torch.int32, device=dev),
                                        world.shape[2])
            if not torch.equal(got, brute.rt_brute_plain(inp, c)):
                raise AssertionError(f"kernel 6 differs from its plain version on {name}, "
                                     f"count {c}")
            n_edge += 1
    lines, entry = [], None
    for s in (2, 1):
        r = Renderer(build_demo_scene(BRUTE_SCENE, dev),
                     PipelineConfig(width=DEMO_SIZE, height=DEMO_SIZE, tri_capacity=PLAIN_CAPACITY,
                                    rt_scale=s, tile_raster=False), device=dev)
        r.set_config(rt=True)
        r.apply_config_now()
        with Recorder(brute, "ray_shadow_directional") as rec:
            r.render(make_demo_camera(BRUTE_SCENE, 0.5, dev))
        (world, normal, direction, tri, tri_valid, count), _, out = rec.calls[0]
        inp = brute.brute_inputs(world, normal, direction, tri, tri_valid)
        wd = world.shape[2]
        for c in (*BRUTE_COUNTS, int(count)):
            got = brute.rt_brute_kernel(inp, torch.tensor(c, dtype=torch.int32, device=dev), wd)
            if not torch.equal(got, brute.rt_brute_plain(inp, c)):
                raise AssertionError(f"kernel 6 differs from its plain version at rt_scale {s}, "
                                     f"count {c}")
            if c == 0 and not (got == 1).all():
                raise AssertionError("kernel 6 at count 0: a receiver is not lit")
        got = brute.rt_brute_kernel(inp, count, wd)
        if not torch.equal(got.reshape(out.shape), out):
            raise AssertionError(f"kernel 6 differs from the frame's own call at rt_scale {s}")
        want = [None]
        p_ms = host_ms(lambda: want.__setitem__(0, brute.rt_brute_plain(inp, count)))
        k_ms = cuda_ms(lambda: brute.rt_brute_kernel(inp, count, wd), 20)
        u_ms = cuda_ms(lambda: brute.rt_brute_kernel(inp, None, wd), 5)
        k_dev = sum(device_us_by_kernel(lambda: brute.rt_brute_kernel(inp, count, wd), 20)
                    .values()) / 1e3
        u_dev = sum(device_us_by_kernel(lambda: brute.rt_brute_kernel(inp, None, wd), 5)
                    .values()) / 1e3
        k_graph = graph_ms_per_call(lambda: brute.rt_brute_kernel(inp, count, wd))
        b_ms, b_by, walked, pairs, n_ops = brute_bound(inp, count)
        lines.append(f"rt_scale {s}: {inp.origin.shape[1]} receivers, count {int(count)}, "
                     f"{walked} triangles walked of {tri.shape[0]}, {pairs} pairs left by the "
                     f"early exit ({n_ops} FP32 operations as far as each test needs), "
                     f"{100 * float((got == 0).float().mean()):.1f}% occluded; kernel in a "
                     f"graph of {GRAPH_CALLS} calls {k_graph:.5f} ms a call, by events / device "
                     f"{k_ms:.4f} / {k_dev:.4f} ms (unbounded walk {u_ms:.4f} / {u_dev:.4f}), "
                     f"plain {p_ms:.1f} ms, bound {b_ms:.5f} ms by {b_by} = "
                     f"{100 * b_ms / k_graph:.1f}% of the graph's time a call, "
                     f"{100 * b_ms / k_ms:.1f}% of the events' time, "
                     + (f"{100 * b_ms / k_dev:.1f}% of the device time" if k_dev > 0 else
                        "the device time not measured (the profiler saw no device event)"))
        if entry is None:
            lines.append("its time a call read otherwise: " + call_readings(
                lambda: brute.rt_brute_kernel(inp, count, wd)))
            entry = dict(name="rt_brute", route="cuda",
                         source="renderer_tpu_torch/csrc/rt_brute.cu",
                         replaces="renderer_tpu/ops/rt.py:99", launches=None, max_abs_err=0.0,
                         ms=k_graph, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
    phase("rt_brute", f"kernel 6, design {json.dumps(brute.kernel_design())}, against its "
                      f"plain version: identical planes on {len(BRUTE_CASES)} edge cases "
                      f"{sorted(BRUTE_CASES)} at their counts ({n_edge} calls) and on "
                      f"{BRUTE_SCENE}'s rt soup at {DEMO_SIZE}x{DEMO_SIZE}, counts "
                      f"{list(BRUTE_COUNTS)} and the frame's, count 0 all lit, the frame's own "
                      "call equal; "
                      + "; ".join(lines) + f" ({card})")
    return entry


def shade_bound(frame, vis, samples, bary) -> tuple:
    """Kernel 7's least time for one call (``bound``): SHADE_SAMPLE_BYTES a
    sample (12 more with given barycentrics, 17 more for a list entry) and
    SHADE_RECORD_BYTES per distinct covered triangle, at HBM's rate (texel
    and shadow-map words not counted: they come mostly from L1/L2), and
    SHADE_OPS per covered sample at the FP32 rate. Returns (ms, what bounds
    it, samples, covered, distinct triangles, operations)."""
    _, _, tri = tpbr.sample_pixels(frame, vis, samples)
    n, cov = tri.numel(), int((tri != -1).sum())
    distinct = int(torch.unique(tri[tri != -1]).numel())
    n_bytes = (n * (SHADE_SAMPLE_BYTES + (12 if bary is not None else 0)
                    + (0 if isinstance(samples, tpbr.Lattice) else 17))
               + distinct * SHADE_RECORD_BYTES)
    alive = frame.lights.alive[:frame.n_lights].tolist()
    casts = frame.shadow.light_casts if frame.shadow is not None else ()
    shadowed = sum(1 for li, on in enumerate(alive) if on and li < len(casts)
                   and 0 <= casts[li][0] < frame.shadow.atlas.shape[0])
    tex, nm = frame.enable_textures, frame.enable_textures and frame.enable_normal_maps
    per = (SHADE_OPS["base"] + (SHADE_OPS["records"] if bary is None else 0)
           + (SHADE_OPS["albedo"] if tex else 0) + (SHADE_OPS["normal_map"] if nm else 0)
           + (SHADE_OPS["trilinear"] * (tex + nm) if frame.trilinear else 0)
           + SHADE_OPS["light"] * sum(alive) + SHADE_OPS["shadow"] * shadowed)
    return (*bound(n_bytes, cov * per), n, cov, distinct, cov * per)


def shade_renderer(name: str, cfg, dev, replay=None):
    """A renderer of SHADE_CONFIGS[name] (its scene at seed 0), shadows on."""
    limits, lights, opts = SHADE_CONFIGS[name]
    scene = sponza_like_scene(N_INSTANCES, limits=limits and SceneLimits(**limits), device=dev)
    if lights:
        scene = scene._replace(lights=shadow_envelope_lights(lights, device=dev))
    r = Renderer(scene, dataclasses.replace(cfg, **SHADE_OPTIONS, **opts),
                 outputs=("image", "vis"), device=dev, replay=replay)
    r.set_config(shadows=True)
    r.apply_config_now()
    return r


def shade_pass_ops(args, kw, outs) -> tuple:
    """``shade_pbr(*args, **kw)`` as it runs (kernel 7), and with the shading
    core's results ``outs`` given in the calls' order (no core at all):
    for each, the ATen ops it dispatches by name and count (the ops a
    capture makes the graph's nodes of), the device ops of one replay of
    its captured graph under torch.profiler by name and count, and its ms
    a call by CUDA events in a graph of SHADE_PASS_CALLS calls."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Dispatched(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    def ops(fn):
        with Dispatched() as mode:
            fn()
        graph = captured(fn, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        graph.reset()
        device = Counter({e.key.replace("(anonymous namespace)::", "").split("(")[0][-48:]:
                          e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA})
        return mode.ops, device, graph_ms_per_call(fn, SHADE_PASS_CALLS, 5)

    def given():
        calls = iter(outs)
        kernel = tpbr.shade_samples_kernel
        tpbr.shade_samples_kernel = lambda *_a, **_k: next(calls)
        try:
            return tpbr.shade_pbr(*args, **kw)
        finally:
            tpbr.shade_samples_kernel = kernel

    return ops(lambda: tpbr.shade_pbr(*args, **kw)), ops(given)


def shade_phase(cfg, dev, card) -> dict:
    """Phase 43: kernel 7 on the benchmark's configurations (SHADE_CONFIGS:
    their scene and pipeline, one eager frame at the bench orbit's pose):
    each call of the frame (the checkerboard lattice, the fix's batch)
    against its plain version bit for bit, their times (in a captured graph,
    by events, on the device) beside the bound (``shade_bound``) and the
    plain version's time in a graph; the shade pass's device ops with and
    without the core (``shade_pass_ops``); the launches per replayed frame.
    ``cfg`` is the main path's. Returns its kernels-line entry (sponza's
    lattice call)."""
    kernel, plain = tpbr.shade_samples_kernel, tpbr.shade_samples_plain_at
    lines, entry, per_frame = [], None, {}
    cam = orbit_camera(0.3, WIDTH / HEIGHT, dev)
    for name in SHADE_CONFIGS:
        r = shade_renderer(name, cfg, dev, replay=False)
        with Recorder(pipeline_module, "shade_pbr") as pass_rec, \
                Recorder(tpbr, "shade_samples_kernel") as rec:
            r.render(cam)
        for args, _, out in rec.calls:
            frame, vis, samples, bary, planes = args
            plain_args = (frame, vis, samples, bary,
                          None if planes is None else (lambda *_, p=planes: p))
            if not torch.equal(out, plain(*plain_args)):
                raise AssertionError(f"kernel 7 differs from its plain version at {name}, "
                                     f"{type(samples).__name__}")
            k_graph = graph_ms_per_call(lambda: kernel(*args))
            k_ms = cuda_ms(lambda: kernel(*args), 20)
            k_dev = sum(device_us_by_kernel(lambda: kernel(*args), 20).values()) / 1e3
            p_graph = graph_ms_per_call(lambda: plain(*plain_args), SHADE_PLAIN_CALLS, 3)
            b_ms, b_by, n, cov, distinct, n_ops = shade_bound(frame, vis, samples, bary)
            what = ("lattice " + "x".join(map(str, out.shape[1:]))
                    if isinstance(samples, tpbr.Lattice) else f"fix batch of {n}")
            lines.append(f"{name} {what}: {cov} covered samples, {distinct} distinct triangles, "
                         f"{n_ops} FP32 operations; kernel in a graph of {GRAPH_CALLS} calls "
                         f"{k_graph:.5f} ms a call, by events / device {k_ms:.4f} / "
                         f"{k_dev:.4f} ms; plain in a graph {p_graph:.3f} ms "
                         f"({p_graph / k_graph:.0f}x); bound {b_ms:.5f} ms by {b_by} = "
                         f"{100 * b_ms / k_graph:.1f}% of the graph's time a call")
            if entry is None:
                entry = dict(name="shade", route="cuda", source="renderer_tpu_torch/csrc/shade.cu",
                             replaces="renderer_tpu/ops/pbr.py:shade_pbr (XLA)", launches=None,
                             max_abs_err=0.0, ms=k_graph, plain_ms=p_graph, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
        # the shade pass's device ops and time, with kernel 7 and with the core's results given
        (args, kw, _), = pass_rec.calls
        (aten, device, pass_ms), (aten_rest, device_rest, rest_ms) = shade_pass_ops(
            args, kw, [out for _, _, out in rec.calls])
        extra = aten - aten_rest  # the kernel's wrapper: its output's allocation and views
        if aten_rest - aten or set(extra) - SHADE_WRAPPER_OPS:
            raise AssertionError(f"shade pass at {name}: ATen ops {dict(aten)}, with the core's "
                                 f"results given {dict(aten_rest)}")
        lines.append(f"{name} shade pass: {sum(aten.values())} ATen ops dispatched, by name "
                     f"{json.dumps(dict(aten.most_common()))}, the same as with the core's "
                     f"results given but {json.dumps(dict(extra))} of kernel 7's wrapper; one "
                     f"replay's device ops under the profiler {sum(device.values())}, by name "
                     f"{json.dumps(dict(device.most_common()))} ({sum(device_rest.values())} "
                     f"with the core's results given); in a graph of {SHADE_PASS_CALLS} calls "
                     f"{pass_ms:.4f} ms a call, {rest_ms:.4f} with the core's results given: "
                     f"the core {pass_ms - rest_ms:.4f} ms")
        # launches per replayed frame, from 0 (the first frame captures)
        r = shade_renderer(name, cfg, dev)
        r.render(cam)
        before = tpbr.SHADE.launches
        for i in range(SHADE_FRAMES):
            r.render(orbit_camera(0.3 + 0.01 * (i + 1), WIDTH / HEIGHT, dev))
        torch.cuda.synchronize()
        per_frame[name] = (tpbr.SHADE.launches - before) / SHADE_FRAMES
        if per_frame[name] != len(rec.calls):
            raise AssertionError(f"kernel 7 launched {per_frame[name]} times a replayed frame at "
                                 f"{name}, the eager frame {len(rec.calls)} times")
    entry["launches"] = per_frame
    phase("shade", f"kernel 7, design {json.dumps(tpbr.kernel_design())}, "
                   f"{cuda_build.ptxas_summary(tpbr.LIBRARY)}, identical to its plain version on "
                   "every call of the frame; " + "; ".join(lines)
          + f"; launches per replayed frame {json.dumps(per_frame)}; bound: bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, FP32 operations at {FP32_OPS_PER_S / 1e12:.0f} "
          f"TFLOP/s ({card})")
    return entry


def bench_phase(tier_ms: dict, scene, cfg, dev, card) -> None:
    """Phase 39: bench_torch.py in a subprocess, its JSON line checked and
    printed beside phase 7's and 15's ms/frame, and its base exact tier
    measured in this process too, as it is and with the garbage
    collector's objects frozen (this process holds far more objects than
    a fresh one), and in a fresh process before and after one window of
    torch.profiler (which this process has run before its tiers)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not out:
        raise AssertionError(f"bench_torch.py exit {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(out[-1])
    keys = set(line) - {BENCH_GOLDEN_KEY}
    if keys != set(BENCH_KEYS) or not line["metric"].endswith("_gpu"):
        raise AssertionError(f"bench_torch.py line: keys {sorted(set(line) ^ set(BENCH_KEYS))} "
                             f"differ from bench.result_line's, metric {line['metric']}")
    if line["metric"] != f"sponza_like_{N_INSTANCES}inst_{WIDTH}x{HEIGHT}_fps_gpu":
        raise AssertionError(f"bench_torch.py metric {line['metric']}")
    pairs = {"exact_path_frame_ms": "base_exact", "checkerboard_fix_frame_ms": "base_checkerboard",
             "shadowed_dynamic_frame_ms": "shadowed_dynamic"}
    against = {k: f"{line[k]} against {tier_ms[t]:.2f}" for k, t in pairs.items()}
    against["shadowed exact / cb+fix fps"] = (
        f"{line['shadowed_exact_fps']} / {line['shadowed_checkerboard_fix_fps']} against "
        f"{1e3 / tier_ms['shadowed_exact']:.2f} / {1e3 / tier_ms['shadowed_checkerboard']:.2f}")
    import gc

    import bench_torch

    here = {"as is": bench_torch._measure_mode(scene, cfg, dev, shadows=False)[0] * 1e3}
    n_objects = len(gc.get_objects())
    gc.collect()
    gc.freeze()
    try:
        here["gc frozen"] = bench_torch._measure_mode(scene, cfg, dev, shadows=False)[0] * 1e3
    finally:
        gc.unfreeze()
    against["base exact in this process"] = (
        f"{here['as is']:.2f} ms/frame, {here['gc frozen']:.2f} with the collector's "
        f"{n_objects} objects frozen")
    traced = subprocess.run([sys.executable, "-c", PROFILED_BENCH], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                            timeout=BENCH_TIMEOUT_S)
    if traced.returncode != 0:
        raise AssertionError(f"profiled bench process exit {traced.returncode}: "
                             f"{traced.stderr[-3000:]}")
    before, after = (float(v) for v in traced.stdout.split()[-2:])
    against["base exact in a fresh process, before / after a profiler window"] = (
        f"{before:.2f} / {after:.2f} ms/frame")
    phase("bench", f"python3 bench_torch.py: exit 0 in {seconds:.1f} s, keys = bench.result_line's"
                   f"{' with the golden key' if BENCH_GOLDEN_KEY in line else ''}, metric "
                   f"{line['metric']}; against phases 7 and 15: {json.dumps(against)} ({card}); "
                   f"its line: {out[-1]}")


def split_phase(scene, cfg, path_launches, kernels, dev, card, devices=None) -> None:
    """Phase 40: the split frame over two shards of the card (the module
    docstring), or one shard per device of ``devices``, eager and replayed,
    beside the single frame on ``dev``. The replayed split path's raster
    and occlusion launches join the kernels line's."""
    from torch.profiler import ProfilerActivity

    from renderer_tpu_torch.parallel import make_mesh

    devices = [torch.device(d) for d in devices or [dev] * SPLIT_SHARDS]
    mesh, shards = make_mesh(devices), len(devices)
    rows = HEIGHT // shards
    card1 = devices[1]  # kernels 1 and 2 are held to their plain versions at shard 1's work
    outputs = ("image", "vis", "soup")
    cam = bench_camera(0, dev)
    lines, checks = [], []
    for name, (changes, switches) in SPLIT_TIERS.items():
        tcfg = dataclasses.replace(cfg, **changes)
        scfg = dataclasses.replace(tcfg, spmd_devices=shards)
        paths = {"eager single": Renderer(scene, tcfg, outputs=outputs, device=dev, replay=False),
                 "eager split": Renderer(scene, scfg, outputs=outputs, spmd_mesh=mesh,
                                         replay=False),
                 "replayed single": Renderer(scene, tcfg, outputs=outputs, device=dev),
                 "replayed split": Renderer(scene, scfg, outputs=outputs, spmd_mesh=mesh)}
        one, split, rone, rsplit = paths.values()
        if one.replay or split.replay or not (rone.replay and rsplit.replay):
            raise AssertionError("split: the default Renderer must replay on the card, split too")
        for r in paths.values():
            r.set_config(**switches)
            r.apply_config_now()
        # lockstep; frame 0 is the replayed paths' eager frame and capture
        for k in range(SPLIT_CHECK_FRAMES):
            out = {label: r.render(bench_camera(k, dev)) for label, r in paths.items()}
            got = out["replayed split"]
            differs = [what for what, ok in (
                ("eager split's outputs", nan_equal(got, out["eager split"])),
                ("eager split's state", nan_equal(rsplit.state, split.state)),
                ("replayed single's image and vis", nan_equal(
                    (got["image"], got["vis"]),
                    (out["replayed single"]["image"], out["replayed single"]["vis"]))))
                if not ok]
            if differs:
                raise AssertionError(f"split {name}: frame {k}: the replayed split frame differs "
                                     f"from the {', '.join(differs)}")
        a, b = out["eager single"], out["eager split"]
        same_cover = torch.equal(a["vis"].tri_id >= 0, b["vis"].tri_id >= 0)
        same_ids = torch.equal(a["vis"].tri_id, b["vis"].tri_id)
        err = (a["image"] - b["image"]).abs().max().item()
        if not same_cover or err > SPLIT_ATOL:
            raise AssertionError(f"split {name}: covered mask equal {same_cover}, max abs "
                                 f"difference {err} against the single-shard frame "
                                 f"({int((a['image'] != b['image']).any(-1).sum())} pixels "
                                 f"differ, tri_id equal {same_ids})")
        ms = {label: [] for label in paths}
        launched = {}  # label -> launches per frame, from its first timed turn
        turns = list(paths) + list(reversed(paths))
        for turn, label in enumerate(turns):
            r = paths[label]
            frames = SPLIT_EAGER_FRAMES if label.startswith("eager") else SPLIT_FRAMES
            first = label not in launched
            if first:
                for kernel in KERNELS:
                    kernel.launches = 0
            with no_blocking_sync(True):
                ms[label].append(frames_ms(r, frames, lambda r, k: r.render(
                    bench_camera(SPLIT_CHECK_FRAMES + turn * SPLIT_FRAMES + k, dev))))
            if first:
                counts = {kn.symbol: kn.launches for kn in KERNELS}
                if any(n % frames for n in counts.values()):
                    raise AssertionError(f"split {name}: {label}: launches {counts} over "
                                         f"{frames} frames")
                launched[label] = {k: n // frames for k, n in counts.items()}
                if label == "replayed split":
                    path_launches[f"split_{name}"] = counts[rc.RASTER_TILES.symbol]
                    kernels["occlusion_tiles"]["launches"] += counts[oc.OCCLUSION_TILES.symbol]
        for single, pair in (("eager single", "eager split"),
                             ("replayed single", "replayed split")):
            if launched[single][tpbr.SHADE.symbol] != shades(tcfg, switches):
                raise AssertionError(f"split {name}: {single} kernel 7 launches "
                                     f"{launched[single][tpbr.SHADE.symbol]} per frame, want "
                                     f"{shades(tcfg, switches)}")
            if launched[single][tshadow.SIGNATURE.symbol] != signatures(tcfg, switches):
                raise AssertionError(f"split {name}: {single} kernel 8 launches "
                                     f"{launched[single][tshadow.SIGNATURE.symbol]} per frame, "
                                     f"want {signatures(tcfg, switches)}")
            want = {k: shards * v for k, v in launched[single].items()}
            if launched[pair] != want or not want[rc.RASTER_TILES.symbol] or (
                    switches.get("rt") and not want[oc.OCCLUSION_TILES.symbol]):
                raise AssertionError(f"split {name}: {pair} launches {launched[pair]} per frame, "
                                     f"want {want} (the {single} path's per shard)")
        # label -> (device busy ms/frame over a traced window, idle % of the turns' ms; per
        # card, the busiest card's idle)
        busy = {}
        for label, r in paths.items():
            prof, _ = traced_window(r, dev, [ProfilerActivity.CUDA], frames=SPLIT_PROFILE_FRAMES,
                                    cam_at=lambda k, d: bench_camera(SPLIT_CHECK_FRAMES + k, d))
            per_card = busy_by_card(prof, SPLIT_PROFILE_FRAMES)
            busy[label] = (per_card, 100.0 * (1.0 - max(per_card.values())
                                              / statistics.mean(ms[label])))
        (program,) = rsplit.programs.values()
        (single_program,) = rone.programs.values()
        lines.append(
            f"{name}: replayed split = eager split (outputs, state) = replayed single (image, "
            f"vis) bit for bit on {SPLIT_CHECK_FRAMES} frames; eager split against eager single:"
            f" covered equal, tri_id {'equal' if same_ids else 'not equal'}, max abs difference "
            f"{err:.3g}; ms/frame in turns, each under sync-debug error ({SPLIT_EAGER_FRAMES} "
            f"eager, {SPLIT_FRAMES} replayed frames a turn): "
            + ", ".join(f"{label} {ms[label][0]:.2f} / {ms[label][1]:.2f}" for label in paths)
            + "; busy ms/frame (idle): "
            + ", ".join(f"{label} " + " + ".join(f"{b:.3f}" for b in v[0].values())
                        + (f" on cards {list(v[0])}" if len(v[0]) > 1 else "")
                        + f" ({v[1]:.1f}%)" for label, v in busy.items())
            + f"; replayed split: capture {program.capture_s:.2f} s, pool "
              f"{program.pool_bytes / 2**20:.1f} MiB, {len(program.graphs)} graph replays per "
              f"frame (replayed single: {single_program.capture_s:.2f} s, "
              f"{single_program.pool_bytes / 2**20:.1f} MiB, {len(single_program.graphs)}); "
              f"kernel 1 / 2 launches per frame: "
            + ", ".join(f"{label} {v[rc.RASTER_TILES.symbol]} / {v[oc.OCCLUSION_TILES.symbol]}"
                        for label, v in launched.items()))
        calls, gathered = [], []
        record, order = trt.occlusion_grid, geometry.draw_order

        def occlusion_grid(*args):  # kernel 2's inputs, by the shard that traced them
            calls.append((threading.current_thread().name, args))
            return record(*args)

        def draw_order(soup, n):  # the gathered soup, before it is put in the cull's order
            gathered.append((threading.current_thread().name, soup))
            return order(soup, n)

        trt.occlusion_grid, geometry.draw_order = occlusion_grid, draw_order
        try:  # eager frames: a replay calls no recorder
            b = split.render(cam)
            shard_vis = split.shard_outputs[1]["vis"]
        finally:
            trt.occlusion_grid, geometry.draw_order = record, order
        with torch.cuda.device(card1):  # shard 1's inputs, on its card
            if name == "base_exact":  # kernel 1 at shard 1's rows, y0 = rows
                seg = [soup for thread, soup in gathered if thread == "shard-1"][-1]
                soup = b["soup"]
                count = int(soup.count)
                if bool(seg.valid[:count].all()) or not bool(soup.valid[:count].all()):
                    raise AssertionError("split soup: want the gathered valid mask segmented "
                                         "and the ordered one a prefix")
                k1 = []
                for label, s in (("gathered (segmented)", seg), ("ordered (the frame's)", soup)):
                    args = rc.raster_inputs(s.clip.to(card1), s.valid.to(card1), WIDTH, rows,
                                            y0=rows, full_height=HEIGHT)
                    got = rc.raster_kernel(*args, False)
                    if not all(torch.equal(g, w)
                               for g, w in zip(got, rc.raster_tiles_plain(*args, False))):
                        raise AssertionError(f"split: kernel 1 at shard 1's rows of the "
                                             f"{label} soup differs from its plain version")
                    k_ms = cuda_ms(lambda: rc.raster_kernel(*args, False), 10)
                    k1.append(f"{label} {k_ms:.4f} ms")
                if not (torch.equal(got[0], shard_vis.depth)
                        and torch.equal(got[1], shard_vis.tri_id)):
                    raise AssertionError("split: kernel 1 at shard 1's rows differs from the "
                                         "shard's visibility buffer")
                checks.append(f"kernel 1 at shard 1's rows {rows}..{2 * rows - 1} of the "
                              f"gathered soup ({count} live of {seg.valid.numel()}, segments "
                              f"{[int(v.sum()) for v in seg.valid.chunk(shards)]}) and of the "
                              "ordered one: each equal to its plain version, the ordered one to "
                              f"the shard's buffer; kernel {', '.join(k1)}")
            if switches.get("rt"):  # kernel 2 at shard 1's receivers
                shard1 = [args for thread, args in calls if thread == "shard-1"]
                if not shard1:
                    raise AssertionError("split rt: shard 1 traced no slot")
                args = trt.occlusion_inputs(*shard1[0])
                if not torch.equal(oc.occlusion_kernel(*args), oc.occlusion_tiles_plain(*args)):
                    raise AssertionError("split rt: kernel 2 at shard 1's receivers differs "
                                         "from its plain version")
                checks.append(f"kernel 2 at shard 1's receivers ({tuple(shard1[0][2].shape)} "
                              f"grid, {len(shard1)} traced slots): equal to its plain version")
    where = (f"on one card (make_mesh([dev] * {shards}))" if len(set(devices)) == 1 else
             f"one per card (make_mesh({[str(d) for d in devices]}))")
    phase("split" if devices == [dev] * SPLIT_SHARDS else f"split_{shards}_cards",
          f"{shards} shards of {WIDTH}x{rows} {where}, sponza_like_scene({N_INSTANCES}): "
          + "; ".join(lines + checks) + f" ({card})")


def nan_equal(a, b) -> bool:
    """Bit-for-bit equality of two trees of tensors, NaN equal to NaN."""
    la, sa = tree.flatten(a)
    lb, sb = tree.flatten(b)
    return repr(sa) == repr(sb) and all(
        torch.equal(x, y) if not x.is_floating_point()
        else torch.equal(torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0))
        for x, y in zip(la, lb))


def synchronize_cards() -> None:
    """Wait for every card (a split frame may end on each)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def frames_ms(renderer, frames: int, frame) -> float:
    """Host-clock ms per frame of ``frames`` calls ``frame(renderer, k)``,
    every card synchronized on both sides."""
    synchronize_cards()
    t0 = time.perf_counter()
    for k in range(frames):
        frame(renderer, k)
    synchronize_cards()
    return (time.perf_counter() - t0) * 1e3 / frames


def graph_tier(label, make, switches, cam_at, scene_at=lambda k: None, prep=False, hud=False):
    """One captured tier: an eager and a replayed Renderer (``make(replay)``)
    in lockstep over GRAPH_CHECK_FRAMES frames (image, visibility buffer and
    state equal bit for bit on each; with ``prep`` the switches are taken up
    after the first frame, as freeze culling needs a culled frame), then
    ms/frame of both in turns, their device busy per frame over a traced
    window and idle share against the turns' ms (the traced window's own
    wall holds the profiler's start), and the program's capture seconds
    and pool. Returns (the phase line's entry, ms and busy of both, the
    replayed renderer)."""
    from torch.profiler import ProfilerActivity

    eager, replay = make(False), make(None)
    if not replay.replay or eager.replay:
        raise AssertionError(f"graph {label}: the default renderer must replay on the card")

    def frame(r, k):
        overlay = hud_overlay(f"frame {k}", r.cfg.width) if hud else None
        return r.render(cam_at(k, r.device), scene=scene_at(k), time_s=k / 60.0, overlay=overlay)

    for k in range(GRAPH_CHECK_FRAMES):
        if k == int(prep):
            for r in (eager, replay):
                r.set_config(**switches)
                r.apply_config_now()
        a, b = frame(eager, k), frame(replay, k)
        if not (nan_equal(a, b) and nan_equal(eager.state, replay.state)):
            raise AssertionError(f"graph {label}: frame {k} replayed differs from eager")
    program = next(p for key, p in replay.programs.items()
                   if dict(key[0]) == vars(replay.config))
    if not program.graphs:
        raise AssertionError(f"graph {label}: no graph captured")
    ms = {"eager": [], "replay": []}
    for name in ("eager", "replay", "replay", "eager"):
        r = eager if name == "eager" else replay
        ms[name].append(frames_ms(r, GRAPH_FRAMES,
                                  lambda r, k: frame(r, GRAPH_CHECK_FRAMES + k)))
    busy = {}  # device busy ms/frame (a traced window), idle against the untraced turns' ms
    for name, r in (("eager", eager), ("replay", replay)):
        prof, _ = traced_window(r, r.device, [ProfilerActivity.CUDA],
                                cam_at=lambda k, d: cam_at(GRAPH_CHECK_FRAMES + k, d),
                                frames=GRAPH_PROFILE_FRAMES)
        b = traced_busy(prof, GRAPH_PROFILE_FRAMES)[1]
        busy[name] = (b, 100.0 * (1.0 - b / statistics.mean(ms[name])))
    entry = (f"{label}: replay = eager bit for bit on {GRAPH_CHECK_FRAMES} frames; ms/frame in turns "
             f"eager {ms['eager'][0]:.2f}, replay {ms['replay'][0]:.2f}, replay "
             f"{ms['replay'][1]:.2f}, eager {ms['eager'][1]:.2f}; busy ms/frame eager "
             f"{busy['eager'][0]:.3f} (idle {busy['eager'][1]:.1f}%), replay "
             f"{busy['replay'][0]:.3f} (idle {busy['replay'][1]:.1f}%); capture "
             f"{program.capture_s:.2f} s, pool {program.pool_bytes / 2**20:.1f} MiB")
    return entry, ms, busy, replay


def shadow_pass_ms(r, cam) -> dict:
    """Device ms per replay of the shadowed plan of ``r`` (a renderer whose
    cache has converged) cut after the shadow pass, less the same plan cut
    before it, at no update and camera ``cam``, with and without conditional
    nodes: the shadow pass's device time. Each cut plan is a FrameProgram
    over a copy of the renderer's state, timed by CUDA events over
    GRAPH_SHADOW_REPLAYS replays, in turns."""
    from renderer_tpu_torch.runtime.frame import execute_plan
    from renderer_tpu_torch.runtime.program import FrameProgram

    scene, dev = r.scene, r.device
    passes = r.passes
    cut = [p.name for p in passes].index("shadow_pass")
    programs = {}
    for name, n, cond in (("before", cut, True), ("with nodes", cut + 1, True),
                          ("without nodes", cut + 1, False)):
        control.ENABLED = cond
        try:
            state = {k: tree.unflatten(tree.flatten(v)[1], [t.clone() for t in tree.leaves(v)])
                     for k, v in r.state.items()}
            prog = FrameProgram(passes[:n], (), state, scene, cam, dev, False, execute_plan)
            prog.run(scene, cam)  # warm-up and capture
        finally:
            control.ENABLED = True
        if (prog.conditional is None) != (cond and control.conditional_nodes()[0]):
            raise AssertionError(f"shadow pass {name}: conditional nodes {prog.conditional}")
        programs[name] = prog
    ms = {name: [] for name in programs}
    for name in ("before", "with nodes", "without nodes", "without nodes", "with nodes", "before"):
        ms[name].append(cuda_ms(programs[name].replay, GRAPH_SHADOW_REPLAYS))
    atlas = programs["with nodes"].state["shadow_cache"][0]
    if not torch.equal(atlas, programs["without nodes"].state["shadow_cache"][0]):
        raise AssertionError("shadow pass: the atlas differs with and without conditional nodes")
    for p in programs.values():
        p.close()
    base = statistics.mean(ms["before"])
    return {name: statistics.mean(v) - base for name, v in ms.items() if name != "before"}


def graph_phase(scene, cfg, path_launches, dev, card) -> None:
    """Phase 41: one CUDA graph replay per frame (runtime/program.py). Every
    captured tier at the bench frame and the plain configuration's 512x512
    orbit (graph_tier), the shadow pass's device time at no update with
    and without conditional nodes, and the launches of a replayed path."""
    ok, why = control.conditional_nodes()
    outputs = ("image", "vis")
    cfg_dyn = dataclasses.replace(cfg, shade_rate="checkerboard", shadow_update_budget=1,
                                  shadow_progressive=SHADOW_PROGRESSIVE,
                                  shadow_tri_capacity=SHADOW_BAND_CAPACITY)
    tables = mover_tables(scene, range(GRAPH_CHECK_FRAMES + 2 * GRAPH_FRAMES
                                       + GRAPH_PROFILE_FRAMES), dev)

    def moved_scene(k):
        return scene._replace(instances=scene.instances._replace(translation=tables[k]))

    for label, (changes, switches) in GRAPH_TIERS.items():
        tcfg = cfg_dyn if label == "shadowed_dynamic" else dataclasses.replace(cfg, **changes)

        def make(replay, tcfg=tcfg):
            return Renderer(scene, tcfg, outputs=outputs, device=dev, replay=replay)

        entry, *_ = graph_tier(label, make, switches, bench_camera,
                               scene_at=moved_scene if label == "shadowed_dynamic" else
                               (lambda k: None), prep=label == "freeze", hud=label == "hud")
        phase(f"graph_{label}", entry + f" ({card})")
    for name in PLAIN_SCENES:
        pcfg = PipelineConfig(width=DEMO_SIZE, height=DEMO_SIZE, tri_capacity=PLAIN_CAPACITY,
                              skinning=name == "skinned", tile_raster=False)
        pscene = build_demo_scene(name, dev)

        def make(replay, pscene=pscene, pcfg=pcfg):
            return Renderer(pscene, pcfg, outputs=outputs, device=dev, replay=replay)

        entry, *_ = graph_tier(f"plain_{name}", make, {},
                               lambda k, d, name=name: make_demo_camera(name, 0.5 + 0.02 * k, d))
        phase(f"graph_plain_{name}", entry + f" ({card})")
    r = Renderer(scene, dataclasses.replace(cfg, shade_rate="checkerboard"), device=dev)
    r.set_config(shadows=True)
    r.apply_config_now()
    for _ in range(2):  # every unit rendered on the first frame (budget 0)
        r.render(bench_camera(0, dev))
    shadow = shadow_pass_ms(r, bench_camera(0, dev))
    r = Renderer(scene, cfg, device=dev)
    launches_of(lambda: [r.render(bench_camera(k, dev)) for k in range(GRAPH_FRAMES)],
                GRAPH_FRAMES, "graph: a replayed path", GRAPH_FRAMES * shades(r.cfg, r.config))
    path_launches["graph_base"] = GRAPH_FRAMES
    phase("graph", f"one CUDA graph replay per frame, captured at each switch set's first frame; "
                   f"conditional nodes: "
                   f"{'yes (csrc/graph_cond.cu)' if ok else f'no, torch.where in the graph: {why}'}; "
                   f"the shadowed static checkerboard+fix frame's shadow pass at no update, device "
                   f"ms per replay: with conditional nodes {shadow['with nodes']:.3f}, without "
                   f"{shadow['without nodes']:.3f} (the plan cut after it less the plan cut "
                   f"before it, CUDA events over {GRAPH_SHADOW_REPLAYS} replays, in turns); "
                   f"{GRAPH_FRAMES} frames of a fresh base renderer (1 eager + capture, "
                   f"{GRAPH_FRAMES - 1} replays) launch kernel 1 {GRAPH_FRAMES} times ({card})")


def envelope_units(sig, prev) -> torch.Tensor:
    """(slots, bands) bool: the units whose signature a frame wrote (a NaN
    signature left NaN is unchanged)."""
    same = (sig == prev) | (torch.isnan(sig) & torch.isnan(prev))
    return ~same.all(dim=-1)


def envelope_frame(r, cam, scene=None) -> tuple:
    """One frame of ``r``: (host-clock ms with the card synchronized on both
    sides, the (slots, bands) units it rendered, kernel 1's launches)."""
    prev = r.state["shadow_cache"][1].clone()
    before = rc.RASTER_TILES.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(cam, scene=scene)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, envelope_units(r.state["shadow_cache"][1], prev), rc.RASTER_TILES.launches - before


def envelope_shades(what: str, r, frames: int) -> None:
    """Kernels 7 and 8 launched ``shades`` and ``signatures`` times for
    each of the ``frames`` frames of ``r`` since the counts were set to 0."""
    for n, kernel, want in ((7, tpbr.SHADE, shades(r.cfg, r.config)),
                            (8, tshadow.SIGNATURE, signatures(r.cfg, r.config))):
        if kernel.launches != frames * want:
            raise AssertionError(f"envelope {what}: kernel {n} launches {kernel.launches} for "
                                 f"{frames} frames, want {frames * want}")


def atlas_copies_ms(atlas) -> dict:
    """Device ms of each copy a steady replay makes of the (slots, S, S)
    atlas, at its shapes, each alone in a captured graph of one call
    (GRAPH_CALL_REPLAYS replays, CUDA events): every slot's previous depth
    copied (``ops/control.cond``), the slots stacked into a new atlas, the
    new atlas donated into a buffer of the state's shape. The atlas is
    read, never written."""
    slots = list(atlas.unbind(0))
    fresh = [t.clone() for t in slots]
    new = torch.stack(fresh)
    buffer = torch.empty_like(atlas)
    steps = {"slot copies": lambda: [t.clone() for t in slots],
             "stack": lambda: torch.stack(fresh),
             "donation": lambda: buffer.copy_(new)}
    return {name: graph_ms_per_call(fn, calls=1) for name, fn in steps.items()}


def ms_list(v) -> str:
    return "[" + ", ".join(f"{m:.2f}" for m in v) + "]"


def envelope_kernel(name, args) -> str:
    """Kernel 1 against its plain version at one of the envelope's raster
    inputs, bit for bit (depth, tri_id and both barycentric planes); the
    kernel's ms a call in a graph of GRAPH_CALLS calls, the plain version's
    host ms, the bound by phase 6's rule and the share of it."""
    got = rc.raster_kernel(*args, False)
    want = [None]
    p_ms = host_ms(lambda: want.__setitem__(0, rc.raster_tiles_plain(*args, False)))
    if not all(torch.equal(a, b) for a, b in zip(got, want[0])):
        raise AssertionError(f"envelope {name}: kernel 1 differs from its plain version")
    k_ms = graph_ms_per_call(lambda: rc.raster_kernel(*args, False))
    _, _, pairs, listed = raster_work(args)
    b_ms, b_by = raster_bound(args, pairs, listed)
    return (f"{name} {args[5]}x{args[6]} (y0 {args[7]}), {args[3].numel()} tiles, "
            f"{int(args[3].sum())} bin-list entries (max {int(args[3].max())} a tile): identical; "
            f"kernel {k_ms:.5f} ms a call in a graph of {GRAPH_CALLS}, plain {p_ms:.1f} ms; "
            f"{pairs} pixel pairs, {listed} triangles listed: bound {b_ms:.5f} ms by {b_by} = "
            f"{100 * b_ms / k_ms:.1f}% of the kernel's time")


def spelled_visibility(signature, slots: tuple, k: int, n: int, dev) -> torch.Tensor:
    """(n_slots, units, n) bool: the visibility kernel 8 folds, read out of
    ``signature(weights)`` (a call of kernel 8 with those weights) through
    weights that are all 0 but the count term, which gives instance i the
    bit 2^j of one component: a unit's component minus its kind term is
    then the sum of its visible instances' bits (below 2^SIGNATURE_BITS,
    exact)."""
    units, bits = max(k, 1), SIGNATURE_BITS
    zeros = [torch.zeros(shape, device=dev) for shape in ((6, 16), (16,), (n,))]
    table = tshadow.signature_units(slots, k)
    kinds = torch.tensor([e.kind for e in table], device=dev)[:, None, None]
    tracked = torch.tensor([[u < e.units for u in range(units)] for e in table],
                           device=dev)[..., None]
    vis = torch.zeros((len(slots), units, n), dtype=torch.bool, device=dev)
    shifts = torch.arange(bits, device=dev)
    for start in range(0, n, tshadow.SIG_C * bits):
        span = [(min(start + c * bits, n), min(start + (c + 1) * bits, n))
                for c in range(tshadow.SIG_C)]
        count = []
        for lo, hi in span:
            w = torch.zeros(n, device=dev)
            w[lo:hi] = 2.0 ** torch.arange(hi - lo, device=dev, dtype=torch.float32)
            count.append(w)
        none = [(z,) * tshadow.SIG_C for z in zeros]
        sig = signature(tshadow.SignatureWeights(none[0], none[1], none[2], none[2], tuple(count)))
        sig = sig.reshape(len(slots), units, tshadow.SIG_C)
        acc = torch.where(tracked, sig - kinds, 0.0).to(torch.int64)  # exact: small integers
        if not torch.equal(torch.where(tracked, acc.to(torch.float32) + kinds, sig), sig):
            raise AssertionError("kernel 8's spelled signature is not a sum of bits")
        spelled = ((acc[..., None] >> shifts) & 1).bool()  # (slots, units, SIG_C, bits)
        for c, (lo, hi) in enumerate(span):
            vis[:, :, lo:hi] = spelled[:, :, c, :hi - lo]
    return vis


def signature_ops(scene, mats, model, slots, k) -> int:
    """FP32 operations kernel 8 executes at ``slots`` (k bands): per (unit,
    alive instance) the planes it tests, in SIGNATURE_PLANE_ORDER up to the
    first the box lies outside, of each of the unit's views up to the first
    that sees the box; per (live slot, instance) the world box and the
    profiles; per (unit, instance) the fold; per signature the light term
    and the tiles' sum."""
    table = tshadow.signature_units(slots, k)
    planes = tshadow.signature_planes(mats, table)[:, list(SIGNATURE_PLANE_ORDER), :, None]
    cw, ew, _, _ = geometry._world_aabb_cols(scene, geometry._cols_of(model))
    a, b, c, d = (planes[:, :, q] for q in range(4))  # (views, 6, 1) each
    outside = (a * cw[0] + b * cw[1] + c * cw[2] + d
               + (a.abs() * ew[0] + b.abs() * ew[1] + c.abs() * ew[2]) < 0.0)  # (views, 6, n)
    first = torch.where(outside.any(dim=1), outside.int().argmax(dim=1), 5)
    tested = (first + 1) * scene.instances.alive  # (views, n): planes a view's test takes
    n, tests, units = model.shape[0], 0, 0
    for e in table:
        if e.light < 0:
            continue
        units += e.units
        for u in range(e.units):
            v0 = e.view0 + u * e.views
            sees = ~outside[v0:v0 + e.views].any(dim=1)  # (views, n)
            earlier = torch.cumsum(sees.int(), dim=0) - sees.int()  # views before that saw it
            tests += int((tested[v0:v0 + e.views] * (earlier == 0)).sum())
    live = sum(e.light >= 0 for e in table)
    tiles = -(-n // 256)
    return (SIGNATURE_PLANE_OPS * tests + SIGNATURE_SLOT_OPS * live * n
            + SIGNATURE_FOLD_OPS * units * n + tshadow.SIG_C * units * (2 * 96 + tiles + 2))


def signature_checks(label, scene, prepared, mats, slots, weights) -> None:
    """Kernel 8 against its plain version at ``slots`` (ENVELOPE_BANDS
    bands); raise on a mismatch: each unit's visible instances, spelled out
    of kernel 8's signatures, equal ``signature_visibility``'s; and the two
    dirty the same units (a unit is dirty when its signature changed, as
    ``select_shadow_updates`` reads it) for the same inputs again (none),
    a nudged caster and a moved light (some)."""
    model = prepared.model
    k, n, dev = ENVELOPE_BANDS, model.shape[0], model.device
    got = spelled_visibility(lambda w: tshadow.shadow_signature_kernel(
        scene, mats, model, slots, k, w), slots, k, n, dev)
    for slot, e in enumerate(tshadow.signature_units(slots, k)):
        if e.light >= 0:
            want = tshadow.signature_visibility(scene, model, mats, slots[slot], k)
            if not torch.equal(got[slot, :e.units], want):
                raise AssertionError(f"kernel 8 at {label}: slot {slot}'s visibility differs from "
                                     f"coarse_cull's at {int((got[slot, :e.units] != want).sum())} "
                                     f"(unit, instance) pairs")
        if got[slot, e.units:].any():
            raise AssertionError(f"kernel 8 at {label}: slot {slot} folds an untracked unit")
    seen = got.any(dim=1)  # (slots, n): instances some unit of the slot sees
    caster = int(seen.any(dim=0).int().argmax())
    nudged = model.clone()
    nudged[caster, 3] += 0.05  # its translation's x
    light = slots[0][0]
    turned = mats.clone()
    turned[light] = tshadow.light_matrices_cube(
        scene.lights._replace(position=light_nudged(scene.lights.position, light)),
        prepared.scene_min, prepared.scene_max)[light]
    steps = (("the same inputs", model, mats), ("a nudged caster", nudged, mats),
             ("a moved light", nudged, turned))
    prev = None
    for what, m, lm in steps:
        sig = [fn(scene, lm, m, slots, k, weights)
               for fn in (tshadow.shadow_signature_kernel, tshadow.shadow_signature)]
        if prev is not None:
            dirty = [~torch.all(s == p, dim=-1) for s, p in zip(sig, prev)]
            if not torch.equal(*dirty):
                raise AssertionError(f"kernel 8 at {label}, {what}: dirty units "
                                     f"{dirty[0].nonzero().tolist()}, the plain version's "
                                     f"{dirty[1].nonzero().tolist()}")
            if bool(dirty[1].any()) != (what != "the same inputs"):
                raise AssertionError(f"kernel 8 at {label}, {what}: {int(dirty[1].sum())} units "
                                     f"dirty")
        prev = sig


def light_nudged(position: torch.Tensor, light: int) -> torch.Tensor:
    """The light table's positions (a directional light's direction) with
    light ``light``'s turned by about 0.05 rad about y."""
    pos = position.clone()
    x, z = pos[light, 0].clone(), pos[light, 2].clone()
    cs, sn = math.cos(0.05), math.sin(0.05)
    pos[light, 0], pos[light, 2] = cs * x + sn * z, cs * z - sn * x
    return pos


def signature_readings(label, scene, prepared, mats, slots, weights) -> str:
    """Kernel 8 and its plain version at ``slots`` (ENVELOPE_BANDS bands),
    checked (``signature_checks``), then ms a call in a graph of
    ENVELOPE_SIG_CALLS, beside kernel 8's bound: the operations it executes
    (``signature_ops``) against the bytes read once (SIGNATURE_INSTANCE_BYTES
    an instance, the mesh boxes, the units' planes) and the signatures
    written."""
    signature_checks(label, scene, prepared, mats, slots, weights)
    model = prepared.model
    ms = {name: graph_ms_per_call(lambda fn=fn: fn(scene, mats, model, slots, ENVELOPE_BANDS,
                                                   weights), calls=ENVELOPE_SIG_CALLS)
          for name, fn in (("kernel", tshadow.shadow_signature_kernel),
                           ("plain", tshadow.shadow_signature))}  # the plain: ~900 kernels a call
    units = ENVELOPE_BANDS * sum(sl is not None for sl in slots)
    alive = int(scene.instances.alive.sum())
    n_ops = signature_ops(scene, mats, model, slots, ENVELOPE_BANDS)
    n_bytes = (model.shape[0] * SIGNATURE_INSTANCE_BYTES + 24 * scene.meshes.mesh_aabb_min.shape[0]
               + 96 * units + 12 * ENVELOPE_BANDS * len(slots))
    b_ms, b_by = bound(n_bytes, n_ops)
    return (f"{label} ({units} units x {alive} alive instances of {model.shape[0]}; visibility "
            f"and dirty units equal the plain version's): kernel 8 "
            f"{ms['kernel']:.4f} ms a call, the plain version {ms['plain']:.4f} "
            f"({ms['plain'] / ms['kernel']:.0f}x), in graphs of {ENVELOPE_SIG_CALLS} calls; "
            f"{n_ops / 1e6:.1f} M operations ({n_ops / (units * alive):.1f} a unit and alive "
            f"instance); bound {b_ms:.5f} ms by {b_by} = {100 * b_ms / ms['kernel']:.1f}%")


def envelope_phase(cfg, path_launches, dev, card) -> None:
    """Phase 42: the reference's shadow envelope, 16 directional slots of
    4096x4096 in 16 bands of 4096x256, through a replayed Renderer
    (convergence, steady state, a moved light, an orbiting light, replay
    against eager), the cold envelope through render_shadow_atlas_per_light,
    and kernel 1 against its plain version at the envelope's two shapes."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scene = sponza_like_scene(N_INSTANCES, limits=SceneLimits(**ENVELOPE_LIMITS), device=dev)
    scene = scene._replace(lights=shadow_envelope_lights(ENVELOPE_SLOTS, device=dev))
    t_scene = time.perf_counter() - t0
    ecfg = dataclasses.replace(
        cfg, shade_rate="checkerboard", shade_fix=True, shadow_slots=ENVELOPE_SLOTS,
        shadow_size=ENVELOPE_SIZE, shadow_cache=True, shadow_update_budget=1,
        shadow_progressive=ENVELOPE_BANDS, shade_light_slots=2, shadow_tri_capacity=0)
    n_units = ENVELOPE_SLOTS * ENVELOPE_BANDS
    outputs = ("image", "vis")

    def cam(angle):
        return orbit_camera(angle, WIDTH / HEIGHT, dev)

    def shadowed(replay):
        r = Renderer(scene, ecfg, outputs=outputs, device=dev, replay=replay)
        r.set_config(shadows=True)
        r.apply_config_now()
        return r

    parts = {}  # host seconds of each part of the phase
    mark = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - mark[0], 1)
        mark[0] = now

    # convergence: one unit a frame until all 256 have rendered, then none
    r = shadowed(None)
    slots = trt.slot_lights(r.atlas_casts, ENVELOPE_SLOTS)
    if slots != tuple((i, True) for i in range(ENVELOPE_SLOTS)) or len(r.light_casts) != 2:
        raise AssertionError(f"envelope: atlas slots {slots}, shaded lights {r.light_casts}")
    for k in KERNELS:
        k.launches = 0
    first = envelope_frame(r, cam(0.3))
    conv = [envelope_frame(r, cam(0.3 + 0.003 * (k + 1))) for k in range(n_units + 2)]
    frames = [first] + conv
    per_frame = [int(u.sum()) for _, u, _ in frames]
    if per_frame != [1] * n_units + [0, 0, 0]:
        raise AssertionError(f"envelope convergence: units per frame {per_frame}")
    if not torch.stack([u for _, u, _ in frames[:n_units]]).any(dim=0).all():
        raise AssertionError("envelope convergence: a unit never rendered")
    want = [1 + ENVELOPE_SLOTS] + [1 + n for n in per_frame[1:]]  # the first frame is eager
    if [n for _, _, n in frames] != want:
        raise AssertionError(f"envelope convergence: kernel 1 launches "
                             f"{[n for _, _, n in frames]}, want {want}")
    envelope_shades("convergence", r, len(frames))
    if torch.isnan(r.state["shadow_cache"][1]).any():
        raise AssertionError("envelope: a signature is still NaN after convergence")
    path_launches["envelope_convergence"] = sum(want)
    conv_ms = [m for m, _, _ in conv]
    program = next(iter(r.programs.values()))
    state_mib = sum(t.numel() * t.element_size() for t in tree.leaves(r.state)) / 2**20
    atlas = r.state["shadow_cache"][0]
    coverage_conv = float((atlas < 1.0).sum()) / atlas.numel()
    part("convergence")

    # steady state: every unit clean, kernel 1 only for the camera
    r.render(cam(0.5))
    sig = r.state["shadow_cache"][1].clone()
    steady_ms = launches_of(
        lambda: frames_ms(r, ENVELOPE_STEADY, lambda r, k: r.render(cam(0.5 + 0.01 * k))),
        ENVELOPE_STEADY, "envelope steady state (kernel 1 for the camera only)",
        ENVELOPE_STEADY * shades(r.cfg, r.config), ENVELOPE_STEADY * signatures(r.cfg, r.config))
    if not nan_equal(sig, r.state["shadow_cache"][1]):
        raise AssertionError("envelope steady state: a unit rendered")
    path_launches["envelope_steady"] = ENVELOPE_STEADY
    prof, _ = traced_window(r, dev, [ProfilerActivity.CUDA],
                            cam_at=lambda k, d: cam(0.5 + 0.01 * (ENVELOPE_STEADY + k)),
                            frames=GRAPH_PROFILE_FRAMES)
    device_ops, busy = traced_busy(prof, GRAPH_PROFILE_FRAMES)
    longest = sorted(device_ops, key=lambda e: -e.self_device_time_total)[:8]
    # a steady replay copies the atlas three times: each slot's previous
    # depth (ops/control.cond's copy of prev), the 16 results stacked into a
    # new atlas, the new atlas donated into the state's buffer; each byte
    # read once and written once
    copy_bytes = 3 * 2 * atlas.numel() * atlas.element_size()
    copies = atlas_copies_ms(atlas)
    copy_ms = sum(copies.values())
    part("steady")

    # light 7 moved: its slot's 16 bands, one a frame, and nothing else
    pos = scene.lights.position.clone()
    pos[ENVELOPE_LIGHT] = torch.tensor(ENVELOPE_MOVED, dtype=torch.float32, device=dev)
    moved = scene._replace(lights=scene.lights._replace(position=pos))
    for k in KERNELS:
        k.launches = 0
    moved_frames = [envelope_frame(r, cam(0.55 + 0.01 * k), moved)
                    for k in range(ENVELOPE_BANDS + 1)]
    units = torch.stack([u for _, u, _ in moved_frames])
    only7 = torch.zeros_like(units[0])
    only7[ENVELOPE_LIGHT] = True
    if ([int(u.sum()) for u in units] != [1] * ENVELOPE_BANDS + [0]
            or not torch.equal(units.any(dim=0), only7)):
        raise AssertionError(f"envelope moved light: units rendered {units.nonzero().tolist()}")
    moved_launches = [n for _, _, n in moved_frames]
    if moved_launches != [2] * ENVELOPE_BANDS + [1]:
        raise AssertionError(f"envelope moved light: kernel 1 launches {moved_launches}")
    envelope_shades("moved light", r, len(moved_frames))
    path_launches["envelope_moved"] = sum(moved_launches)
    part("moved light")

    # light 7 orbiting: at most one band a frame (tables made before the frames)
    a = 0.25 * torch.arange(ENVELOPE_ORBIT + 1, dtype=torch.float32, device=dev)
    d7 = torch.stack([0.6 * torch.sin(a), -torch.ones_like(a), 0.6 * torch.cos(a)], dim=-1)
    tables = pos[None].repeat(ENVELOPE_ORBIT + 1, 1, 1)
    tables[:, ENVELOPE_LIGHT] = d7 / torch.linalg.norm(d7, dim=-1, keepdim=True)

    def orbit_scene(k):
        return scene._replace(lights=scene.lights._replace(position=tables[k]))

    for k in KERNELS:
        k.launches = 0
    orbit_frames = [envelope_frame(r, cam(0.6 + 0.01 * k), orbit_scene(k))
                    for k in range(ENVELOPE_ORBIT + 1)]
    orbit_units = [int(u.sum()) for _, u, _ in orbit_frames]
    if any(n > 1 for n in orbit_units) or any(
            int(u.sum()) and not u[ENVELOPE_LIGHT].any() for _, u, _ in orbit_frames):
        raise AssertionError(f"envelope orbit: units per frame {orbit_units}")
    if [n for _, _, n in orbit_frames] != [1 + n for n in orbit_units]:
        raise AssertionError(f"envelope orbit: kernel 1 launches {[n for _, _, n in orbit_frames]}")
    envelope_shades("orbit", r, len(orbit_frames))
    path_launches["envelope_orbit"] = sum(1 + n for n in orbit_units)
    orbit_ms = [m for m, _, _ in orbit_frames[1:]]
    part("orbit")

    # the shadow pass at no update (the cut plans), and the signatures alone,
    # once light 7 is back and its slot's bands have rendered again
    for _ in range(ENVELOPE_BANDS):
        r.render(cam(0.6), scene=scene)
    if envelope_frame(r, cam(0.6))[1].any():
        raise AssertionError("envelope: the cache did not converge again after the orbit")
    shadow = shadow_pass_ms(r, cam(0.6))
    prepared = geometry.prepare_frame_columns(scene, cam(0.6))
    mats = tshadow.light_matrices_cube(scene.lights, prepared.scene_min, prepared.scene_max)
    weights = tshadow.signature_weights(prepared.model.shape[0], dev)
    sig_lines = [signature_readings(label, scene, prepared, mats, slot_list, weights)
                 for label, slot_list in (("the envelope", slots),
                                          ("sponza's pattern", slots[:1] + (None,) * 3))]
    part("shadow pass and signatures")
    profile_main_path("envelope_profile", r, dev, card, cam_at=lambda k, d: cam(0.6 + 0.01 * k))
    part("profile")
    shade = PASS_PROFILES["envelope_profile"].get("shade_shadowed", math.nan)
    shade_4 = PASS_PROFILES.get("shadow_profile", {}).get("shade_shadowed", math.nan)
    capture_s, pool_mib = program.capture_s, program.pool_bytes / 2**20
    r.drop_plans()
    del r, program, atlas
    torch.cuda.empty_cache()

    phase("envelope", (
        f"sponza_like_scene({N_INSTANCES}) with {ENVELOPE_SLOTS} directional lights "
        f"(shadow_envelope_lights, built in {t_scene:.1f} s), {ENVELOPE_SLOTS} slots of "
        f"{ENVELOPE_SIZE}x{ENVELOPE_SIZE} in {ENVELOPE_BANDS} bands, budget 1, 2 shaded lights, "
        f"checkerboard+fix, replayed: first frame (eager + capture) {first[0]:.1f} ms; "
        f"convergence over {n_units} units + 2 frames, one unit a frame then none: first 8 "
        f"{ms_list(conv_ms[:8])} last 4 {ms_list(conv_ms[-4:])} ms, mean over the unit frames "
        f"{statistics.mean(conv_ms[:n_units - 1]):.2f} ms; no signature NaN; atlas coverage "
        f"{100 * coverage_conv:.1f}%; steady {steady_ms:.2f} ms/frame over {ENVELOPE_STEADY} "
        f"frames, kernel 1 {ENVELOPE_STEADY} launches (the camera's: 0 in the atlas), busy "
        f"{busy:.3f} ms/frame (idle {100 * (1 - busy / steady_ms):.1f}%) over "
        f"{GRAPH_PROFILE_FRAMES} traced frames, longest (ms/frame, launches/frame) "
        + ", ".join(f"{e.key[:90]} {e.self_device_time_total / 1e3 / GRAPH_PROFILE_FRAMES:.3f} "
                    f"{e.count / GRAPH_PROFILE_FRAMES:.0f}" for e in longest)
        + f"; atlas copies a steady frame: {copy_bytes / 2**30:.2f} GiB moved (16 slot copies, "
        f"the stack, the donation, each read and written once), device ms each alone in a "
        f"graph {json.dumps({k: round(v, 4) for k, v in copies.items()})} = {copy_ms:.3f} ms "
        f"({copy_bytes / copy_ms / 1e6:.0f} GB/s); light {ENVELOPE_LIGHT} moved to "
        f"{ENVELOPE_MOVED}: the next "
        f"{ENVELOPE_BANDS} frames render exactly its slot's {ENVELOPE_BANDS} bands, one a frame, "
        f"then none: {ms_list([m for m, _, _ in moved_frames])} ms; light {ENVELOPE_LIGHT} "
        f"orbiting ({ENVELOPE_ORBIT} frames): units per frame {orbit_units[1:]}, "
        f"{ms_list(orbit_ms)} ms, mean {statistics.mean(orbit_ms):.2f}; shadow pass at no update "
        f"(cut plans) {shadow['with nodes']:.3f} ms a replay with conditional nodes, "
        f"{shadow['without nodes']:.3f} without; signatures at " + "; at ".join(sig_lines) + "; "
        f"shade_shadowed device {shade:.3f} ms/frame against {shade_4:.3f} at 4 slots of "
        f"512x512 (phase 19); capture {capture_s:.2f} s, pool {pool_mib:.0f} MiB, state "
        f"{state_mib:.0f} MiB ({card})"))

    # replayed against eager, bit for bit: image, vis and the whole state
    eager, replay = shadowed(False), shadowed(None)
    for k in range(ENVELOPE_LOCKSTEP + 1):
        sc = moved if k == ENVELOPE_LOCKSTEP else None
        a_out = eager.render(cam(0.3 + 0.003 * k), scene=sc)
        b_out = replay.render(cam(0.3 + 0.003 * k), scene=sc)
        if not (nan_equal(a_out, b_out) and nan_equal(eager.state, replay.state)):
            raise AssertionError(f"envelope: replayed frame {k} differs from eager")
    replay.drop_plans()
    del eager, replay, a_out, b_out
    torch.cuda.empty_cache()
    part("replayed against eager")

    # the cold envelope: 16 whole slots every call
    cam_c = cam(ENVELOPE_COLD_ANGLE)
    prepared = geometry.prepare_frame_columns(scene, cam_c)
    mats = tshadow.light_matrices_cube(scene.lights, prepared.scene_min, prepared.scene_max)

    def cold(slot_list=slots):
        return tshadow.render_shadow_atlas_per_light(
            scene, mats, prepared.model, prepared.lod, slot_list, ENVELOPE_SIZE,
            ENVELOPE_COLD_CAPACITY)

    def cold_calls():
        for _ in range(ENVELOPE_COLD_CALLS):
            out = cold()
        return out

    cold()
    atlas = launches_of(cold_calls, ENVELOPE_SLOTS * ENVELOPE_COLD_CALLS, "the cold envelope",
                        0)
    path_launches["envelope_cold"] = ENVELOPE_SLOTS * ENVELOPE_COLD_CALLS
    cold_ms = frames_ms(None, ENVELOPE_COLD_CALLS, lambda _, k: cold())
    coverage = float((atlas < 1.0).sum()) / atlas.numel()
    del atlas
    demand = tshadow.shadow_caster_truncation(scene, prepared.model, prepared.lod, mats,
                                              ENVELOPE_SLOTS, 0, slot_size=ENVELOPE_SIZE)
    dropped = torch.clamp(demand - ENVELOPE_COLD_CAPACITY, min=0)
    part("cold envelope")

    # kernel 1 at the band of most casters, and at those rows of its whole slot
    smin, smax = prepared.scene_min, prepared.scene_max
    center, radius = tshadow._scene_sphere(smin, smax)
    mesh_id = scene.instances.mesh_id.long()
    bands = torch.arange(ENVELOPE_BANDS, device=dev)
    unit_demand = []
    for li, _ in slots:
        light_dir = scene.lights.position[li]
        eye = center - light_dir / torch.clamp(tshadow._norm3(light_dir), min=1e-8) * (radius * 2.0)
        lod_pick = tshadow.lod_by_distance(scene, prepared.model, eye,
                                           bias=tshadow.shadow_lod_bias(ENVELOPE_SIZE))
        vis = geometry.coarse_cull(scene, prepared.model,
                                   tshadow.band_matrix(mats[li, 0], bands, ENVELOPE_BANDS))
        unit_demand.append(torch.where(vis, scene.meshes.lod_tri_count[mesh_id, lod_pick], 0)
                           .sum(dim=-1))
    unit_demand = torch.stack(unit_demand)
    s_max, b_max = divmod(int(torch.argmax(unit_demand)), ENVELOPE_BANDS)
    sel = torch.zeros((1, ENVELOPE_BANDS), dtype=torch.bool, device=dev)
    sel[0, b_max] = True
    with Recorder(tshadow, "rasterize_cuda") as ras:
        tshadow.render_shadow_atlas_per_light(
            scene, mats, prepared.model, prepared.lod, slots[s_max:s_max + 1], ENVELOPE_SIZE,
            ecfg.caster_capacity, selected=sel,
            atlas_prev=torch.ones((1, ENVELOPE_SIZE, ENVELOPE_SIZE), device=dev),
            scene_min=smin, scene_max=smax, progressive=ENVELOPE_BANDS)
    clip, valid, w, h = ras.calls[0][0]
    band_args = rc.raster_inputs(clip, valid, w, h, cull_backface=False)
    band_casters = int(valid.sum())
    del ras, clip, valid
    with Recorder(tshadow, "rasterize_cuda") as ras:
        cold(slots[s_max:s_max + 1])
    clip, valid, w, h = ras.calls[0][0]
    bh = ENVELOPE_SIZE // ENVELOPE_BANDS
    rows_args = rc.raster_inputs(clip, valid, w, bh, cull_backface=False, y0=b_max * bh,
                                 full_height=h)
    slot_casters = int(valid.sum())
    del ras, clip, valid
    lines = [envelope_kernel(f"band {b_max} of slot {s_max} ({band_casters} casters of "
                             f"{int(unit_demand[s_max, b_max])} wanted, capacity "
                             f"{ecfg.caster_capacity})", band_args),
             envelope_kernel(f"rows of slot {s_max}'s whole view ({slot_casters} casters, "
                             f"capacity {ENVELOPE_COLD_CAPACITY})", rows_args)]
    del band_args, rows_args
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    part("kernel 1")
    phase("envelope_cold", (
        f"render_shadow_atlas_per_light over the {ENVELOPE_SLOTS} whole slots at bench angle "
        f"{ENVELOPE_COLD_ANGLE}, caster capacity {ENVELOPE_COLD_CAPACITY}: "
        f"{cold_ms:.2f} ms a call over {ENVELOPE_COLD_CALLS} calls after a warm-up, kernel 1 "
        f"{ENVELOPE_SLOTS} launches a call; coverage {100 * coverage:.1f}% of texels < 1; "
        f"caster demand per slot {demand.tolist()}, dropped {dropped.tolist()}; replayed = eager "
        f"bit for bit (image, vis, state) over {ENVELOPE_LOCKSTEP} frames and a moved-light "
        f"frame; kernel 1 against its plain version: " + "; ".join(lines)
        + f"; band demands of slot {s_max} {unit_demand[s_max].tolist()}; peak "
        f"torch.cuda.max_memory_allocated over the phase {peak:.2f} GiB; host seconds of the "
        f"phase's parts {json.dumps(parts)} ({card})"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on NVIDIA GPUs.")
    ap.add_argument("--split-cards", type=int, nargs="+", metavar="N",
                    help="phases 1, 2 and then only phase 40, over the first N cards for each N")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if opts.split_cards and max(opts.split_cards) > torch.cuda.device_count():
        print(f"chip_smoke: --split-cards {opts.split_cards} needs "
              f"{max(opts.split_cards)} cards, {torch.cuda.device_count()} seen", file=sys.stderr)
        return 1
    t_start = _phase_clock[0] = time.perf_counter()
    dev = torch.device("cuda")
    kernels = {}

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
    libraries = {"raster.cu": rc.LIBRARY, "occlusion.cu": oc.LIBRARY,
                 "probe.cu": probe_cuda.LIBRARY, "scan_raster.cu": rs.LIBRARY,
                 "rt_brute.cu": brute.LIBRARY, "graph_cond.cu": control.LIBRARY,
                 "shade.cu": tpbr.LIBRARY, "signature.cu": tshadow.LIBRARY}
    cuda_build.build_all(libraries.values())
    for kernel in KERNELS:
        kernel.load()
    phase("build", f"{len(libraries)} sources built in parallel and loaded in "
                   f"{time.perf_counter() - t0:.2f} s; " + "; ".join(
                       f"{name}: {lib.build_log.splitlines()[0] if lib.build_log else 'cached'}, "
                       f"{cuda_build.ptxas_summary(lib)}" for name, lib in libraries.items()))
    if opts.split_cards:
        scene = sponza_like_scene(N_INSTANCES, device=dev)
        cfg = PipelineConfig(width=WIDTH, height=HEIGHT, tri_capacity=TRI_CAPACITY,
                             enable_normal_maps=True, aa="edge", trilinear=False)
        for n in opts.split_cards:
            split_phase(scene, cfg, {}, {"occlusion_tiles": {"launches": 0}}, dev, card,
                        devices=[f"cuda:{i}" for i in range(n)])
        phase("total", f"chip_smoke --split-cards ran {time.perf_counter() - t_start:.1f} s "
                       f"({card})")
        return 0

    # 3. raster kernel vs plain on the test cases -------------------------------
    worst = 0.0
    for name, (build, w, h, cull) in sorted(CASES.items()):
        clip, valid = build()
        args = rc.raster_inputs(torch.from_numpy(clip).to(dev), torch.from_numpy(valid).to(dev),
                                w, h, cull)
        for with_bary in (True, False):
            worst = max(worst, compare(rc.raster_kernel(*args, with_bary),
                                       rc.raster_tiles_plain(*args, with_bary)))
    phase("raster_cases", f"{len(CASES)} cases x bary on/off: tri_id identical, max float err {worst:.1e}")

    # 4. occlusion kernel vs plain on the test cases -----------------------------
    segment_lengths = (oc.SEGMENT_BLOCKS, 1)
    for name, build in sorted(OCCLUSION_CASES.items()):
        args = trt.occlusion_inputs(*(torch.from_numpy(a).to(dev) for a in build()))
        want = oc.occlusion_tiles_plain(*args)
        for seg in segment_lengths:
            if not torch.equal(oc.occlusion_kernel(*args, segment_blocks=seg), want):
                raise AssertionError(f"occlusion kernel differs from its plain version on {name} "
                                     f"with {seg}-block segments")
    phase("occlusion_cases", f"{len(OCCLUSION_CASES)} cases x segments of {segment_lengths} blocks: "
                             "planes identical")

    # 5. the kernels on no path ---------------------------------------------
    probes = {}
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32)).to(dev)
    e = torch.from_numpy(np.random.default_rng(1).normal(size=(262144, 36)).astype(np.float32)).to(dev)
    rounds = {}
    for pname, replaces, kernel, plain, library, inp, iters, n_rounds in (
            ("add_one", "tests/test_tpu_hw.py:87", probe_cuda.add_one, probe_cuda.add_one_plain,
             lambda: x + 1, x, LAUNCH_CALLS, PROBE_ROUNDS),
            ("transpose", "scripts/prof_phasea.py:93", probe_cuda.transpose,
             probe_cuda.transpose_plain, lambda: e.T.contiguous(), e, 50, 2)):
        got, want = kernel(inp), plain(inp)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{pname} differs from its plain version")
        p_bound, p_by = bound(2 * inp.numel() * 4, inp.numel() if pname == "add_one" else 0)
        # timed in turns (kernel, plain, library, then the other way round, ...), median
        fns = {"ms": lambda: kernel(inp), "plain_ms": lambda: plain(inp), "library_ms": library}
        rounds[pname] = {k: [] for k in fns}
        for r in range(n_rounds):
            for k, fn in (list(fns.items()) if r % 2 == 0 else list(reversed(fns.items()))):
                rounds[pname][k].append(cuda_ms(fn, iters))
        probes[pname] = kernels[pname] = dict(
            name=pname, route="cuda", source="renderer_tpu_torch/csrc/probe.cu",
            replaces=replaces, launches=None, max_abs_err=(got - want).abs().max().item(),
            bound_ms=p_bound, bound_by=p_by,
            **{k: statistics.median(v) for k, v in rounds[pname].items()})
    phase("probe", "; ".join(
        f"{k} {tuple(v.shape)}: kernel {p['ms']:.5f} ms, plain {p['plain_ms']:.5f} ms, library "
        f"{p['library_ms']:.5f} ms, bound {p['bound_ms']:.6f} ms by {p['bound_by']}, max err "
        f"{p['max_abs_err']}" for (k, p), v in zip(probes.items(), (x, e))) + f" ({card})")
    turns = rounds["add_one"]
    wins = sum(a <= b for a, b in zip(turns["ms"], turns["library_ms"]))
    phase("launch_path", f"add_one {tuple(x.shape)} against x + 1: " + launch_breakdown(x)
          + f"; cuda_ms over {LAUNCH_CALLS} launches, median of {PROBE_ROUNDS} rounds in turns: "
          f"add_one {1e3 * probes['add_one']['ms']:.3f} us, x + 1 "
          f"{1e3 * probes['add_one']['library_ms']:.3f} us, add_one no slower in {wins} of "
          f"{PROBE_ROUNDS} rounds; per round add_one "
          + json.dumps([round(1e3 * v, 3) for v in turns["ms"]]) + ", x + 1 "
          + json.dumps([round(1e3 * v, 3) for v in turns["library_ms"]]) + f" ({card})")

    # 6. the bench frame's soup ---------------------------------------------
    t0 = time.perf_counter()
    scene = sponza_like_scene(N_INSTANCES, device=dev)
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    prepared = geometry.prepare_frame_columns(scene, orbit_camera(0.3, WIDTH / HEIGHT, dev))
    soup, _ = geometry.build_draw_stream(scene, prepared, 2 * TRI_CAPACITY, TRI_CAPACITY,
                                         WIDTH, HEIGHT)
    args = rc.raster_inputs(soup.clip, soup.valid, WIDTH, HEIGHT)
    counts = args[3]
    full_ms = cuda_ms(lambda: rc.rasterize_cuda(soup.clip, soup.valid, WIDTH, HEIGHT,
                                                with_bary=False), 10)
    got = rc.raster_kernel(*args, False)
    want = [None]
    plain_ms = host_ms(lambda: want.__setitem__(0, rc.raster_tiles_plain(*args, False)))
    bench_err = compare(got, want[0])
    bits, regions, pixel_pairs, listed_tris = raster_work(args)
    r_bound, r_by = raster_bound(args, pixel_pairs, listed_tris)
    old_bound, old_by = bound(0, int(bits.sum()) * rc.TILE_H * rc.TILE_W * OPS_PER_PAIR)
    hot = torch.argsort(bits, descending=True, stable=True)[:HOT_TILES].tolist()
    # the whole soup, and the same inputs with the bin lists of the heaviest
    # tile, the HOT_TILES heaviest and none: ms by CUDA events over 20 calls
    # (host-bound when the device work is shorter than a call's launch path)
    # and device ms per call from the profiler
    lists = {n: with_lists_of(args, hot[:n]) for n in (1, HOT_TILES, 0)}
    lists["all"] = args
    event_ms = {n: cuda_ms(lambda a=a: rc.raster_kernel(*a, False), 20) for n, a in lists.items()}
    device_us = {n: device_us_by_kernel(lambda a=a: rc.raster_kernel(*a, False), 100)
                 for n, a in lists.items()}
    kernel_ms = event_ms["all"]

    def timed(n) -> str:
        return f"{event_ms[n]:.4f} / {sum(device_us[n].values()) / 1e3:.4f} ms"

    kernels["raster_tiles"] = dict(
        name="raster_tiles", route="cuda", source="renderer_tpu_torch/csrc/raster.cu",
        replaces="renderer_tpu/ops/raster_pallas.py:373", launches=None, max_abs_err=bench_err,
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=r_bound, bound_by=r_by, library_ms=None)
    phase("bench_soup", f"scene built in {t_scene:.1f} s; {int(soup.count)} triangles; bins "
                        f"mean {counts.float().mean().item():.1f} max {int(counts.max())} blocks/tile; "
                        f"kernel by events / device {timed('all')} ({us_line(device_us['all'])} us), "
                        f"setup+binning+kernel {full_ms:.3f} ms, plain "
                        f"{plain_ms:.1f} ms; tri_id identical, max float err {bench_err:.1e}; "
                        f"mask bits {int(bits.sum())} (ops bound {old_bound:.4f} ms), pixel pairs "
                        f"inside the padded bbox {pixel_pairs}, {listed_tris} triangles listed: "
                        f"bound {r_bound:.4f} ms by {r_by} = "
                        f"{100 * r_bound / kernel_ms:.1f}% of the kernel's time; mask bits per tile "
                        f"{spread(bits)}; triangles per region whose bbox overlaps its pixel centres "
                        + "; ".join(f"{rw}x{rh} ({v.numel()}): {int(v.sum())} pairs, {spread(v)}"
                                    for (rw, rh), v in regions.items())
                        + f"; kernel by events / device with the bin lists of the heaviest tile only "
                        f"(tile {hot[0]}, {int(bits[hot[0]])} bits, {int(counts[hot[0]])} blocks) "
                        f"{timed(1)}, of the {HOT_TILES} heaviest (tiles {sorted(hot)}) "
                        f"{timed(HOT_TILES)}, of none {timed(0)} ({card})")

    # 7. main path ------------------------------------------------------------
    cfg = PipelineConfig(width=WIDTH, height=HEIGHT, tri_capacity=TRI_CAPACITY,
                         enable_normal_maps=True, aa="edge", trilinear=False)
    renderer = Renderer(scene, cfg, outputs=("image", "vis", "soup"), device=dev)
    for k in KERNELS:
        k.launches = 0
    frame_ms, out = run_orbit(renderer, dev)
    base_launches = {k.symbol: k.launches for k in KERNELS}
    launches = rc.RASTER_TILES.launches
    frames = FRAMES + 1
    if (launches != frames or oc.OCCLUSION_TILES.launches
            or tpbr.SHADE.launches != frames * shades(cfg)
            or tshadow.SIGNATURE.launches != frames * signatures(cfg)):
        raise AssertionError(f"launches for {frames} frames of the base path: {base_launches}")
    path_launches = {"base": launches}
    img_base, coverage, brightness = check_image(out)
    write_png(os.path.join(enable_persistent_cache(), "chip_smoke_frame.png"),
              np.clip(img_base, 0.0, 1.0))
    passes = replayed_pass_ms(renderer, dev)
    phase("main_path", f"{frame_ms:.2f} ms/frame = {1e3 / frame_ms:.2f} FPS over {FRAMES} frames "
                       f"({card}); {int(out['soup'].count)} visible triangles; raster launches "
                       f"{launches} = frames {frames}; coverage {coverage:.3f}, mean "
                       f"{brightness:.3f}; pass ms "
                       + json.dumps({k: round(v, 3) for k, v in passes.items()}))

    # 8. main path, kernel vs plain raster ------------------------------------
    cam = orbit_camera(0.3, WIDTH / HEIGHT, dev)
    ref_out = Renderer(scene, cfg, device=dev, replay=False).render(cam)
    kernel_fn = rc.raster_kernel
    rc.raster_kernel = rc.raster_tiles_plain  # the plain version on CUDA tensors
    try:  # eager: the plain version waits for the card, which a capture refuses
        plain_out = Renderer(scene, cfg, device=dev, replay=False).render(cam)
    finally:
        rc.raster_kernel = kernel_fn
    if not torch.equal(ref_out["vis"].tri_id, plain_out["vis"].tri_id):
        raise AssertionError("main path tri_id differs between kernel and plain raster")
    frame_psnr = psnr(np.clip(ref_out["image"].cpu().numpy(), 0, 1),
                      np.clip(plain_out["image"].cpu().numpy(), 0, 1))
    if frame_psnr < PSNR_GATE_DB:
        raise AssertionError(f"main path PSNR kernel vs plain {frame_psnr:.1f} dB")
    phase("main_vs_plain", f"tri_id identical; display-clamped PSNR "
                           f"{'inf' if math.isinf(frame_psnr) else f'{frame_psnr:.1f}'} dB")

    # 9. profile ----------------------------------------------------------------
    profile_main_path("profile", renderer, dev, card)

    # 10. rt: slot 0's occlusion inputs at the bench camera --------------------
    rt_cfgs = {s: dataclasses.replace(cfg, rt_scale=s) for s in RT_SCALES}
    rt_inputs = {}
    for s, c in rt_cfgs.items():
        r = Renderer(scene, c, device=dev)
        r.set_config(rt=True)
        r.apply_config_now()
        with Recorder(trt, "occlusion_grid") as rec:
            r.render(cam)
        rt_inputs[s] = rec.calls[0][0]  # the first slot traced: slot 0
    mats = directional_light_matrices(scene.lights, prepared.scene_min, prepared.scene_max)
    visible = geometry.coarse_cull(scene, prepared.model, mats[0])
    mesh_id = scene.instances.mesh_id.long()
    demand = int(torch.where(visible, scene.meshes.lod_tri_count[mesh_id, prepared.lod], 0).sum())
    cap = cfg.caster_capacity
    grid = []
    for s in RT_SCALES:
        clip, valid, lx, ly, ld = rt_inputs[s]
        args = trt.occlusion_inputs(clip, valid, lx, ly, ld)
        got = oc.occlusion_kernel(*args)
        want = [None]
        p_ms = host_ms(lambda: want.__setitem__(0, oc.occlusion_tiles_plain(*args)))
        if not torch.equal(got, want[0]):
            raise AssertionError(f"occlusion kernel differs from plain at rt_scale {s}: "
                                 f"{int((got != want[0]).sum())} receivers")
        occ_err = (got - want[0]).abs().max().item()
        k_ms = cuda_ms(lambda: oc.occlusion_kernel(*args), 20)
        f_ms = cuda_ms(lambda: trt.occlusion_grid(clip, valid, lx, ly, ld), 10)
        sweep = {}
        for seg in SEGMENT_SWEEP:
            if not torch.equal(oc.occlusion_kernel(*args, segment_blocks=seg), want[0]):
                raise AssertionError(f"occlusion kernel with {seg}-block segments differs from plain "
                                     f"at rt_scale {s}")
            sweep[seg] = cuda_ms(lambda: oc.occlusion_kernel(*args, segment_blocks=seg), 10)
        parts = device_us_by_kernel(lambda: oc.occlusion_kernel(*args), 20)
        (o_bound, o_by), pairs, hit_casters = occlusion_bound(args)
        bc = args[2]
        listed = int(bc.sum()) * rc.BLOCK
        items = int(oc.segments(bc, oc.SEGMENT_BLOCKS).sum())
        live = torch.isfinite(ld)
        shadowed = float(((got[: ld.shape[0], : ld.shape[1]] == 0) & live).sum()) / max(1, int(live.sum()))
        grid.append(f"rt_scale {s}: grid {lx.shape[0]}x{lx.shape[1]}, {bc.numel()} tiles, bins mean "
                    f"{bc.float().mean().item():.1f} max {int(bc.max())} blocks/tile, {pairs} "
                    f"receiver-caster pairs, {100 * shadowed:.1f}% of live receivers shadowed; "
                    f"kernel {k_ms:.3f} ms (device us per call: {us_line(parts)}; "
                    f"bound {o_bound:.4f} ms by {o_by} = "
                    f"{100 * o_bound / k_ms:.1f}% of the kernel's time), {items} work items of "
                    f"{oc.SEGMENT_BLOCKS} blocks, {hit_casters} hit casters staged (early exit not "
                    f"counted) of {listed} listed = {100 * hit_casters / max(1, listed):.2f}%; "
                    f"setup+binning+kernel {f_ms:.3f} ms, plain {p_ms:.1f} ms; planes identical; "
                    "kernel ms by segment length " + json.dumps({k: round(v, 4) for k, v in sweep.items()}))
        if s == 2:
            kernels["occlusion_tiles"] = dict(
                name="occlusion_tiles", route="cuda", source="renderer_tpu_torch/csrc/occlusion.cu",
                replaces="renderer_tpu/ops/rt_grid.py:98", launches=None, max_abs_err=occ_err,
                ms=k_ms, plain_ms=p_ms, bound_ms=o_bound, bound_by=o_by, library_ms=None)
    n_live = int(rt_inputs[2][1].sum())
    phase("rt_grid", f"casters: {demand} wanted by the sun's coarse cull at the camera LOD, "
                     f"capacity {cap}, {n_live} expanded "
                     f"({'truncated' if demand > cap else 'not truncated'}); " + "; ".join(grid)
          + f" ({card})")

    # 11. rt main path ----------------------------------------------------------
    rt_renderer = Renderer(scene, rt_cfgs[2], outputs=("image", "vis", "soup"), device=dev)
    rt_renderer.set_config(rt=True)
    rt_renderer.apply_config_now()
    slots = trt.slot_lights(rt_renderer.light_casts, rt_renderer.cfg.shadow_slots)
    per_frame = sum(0 if sl is None else (1 if sl[1] else 6) for sl in slots)
    for k in KERNELS:
        k.launches = 0
    rt_ms, rt_out = run_orbit(rt_renderer, dev)
    occ_launches, ras_launches = oc.OCCLUSION_TILES.launches, rc.RASTER_TILES.launches
    probe_launches = {}
    for name, k in (("add_one", probe_cuda.ADD_ONE), ("transpose", probe_cuda.TRANSPOSE)):
        probe_launches[name] = kernels[name]["launches"] = base_launches[k.symbol] + k.launches
    if any(probe_launches.values()):
        raise AssertionError(f"kernels of no path launched on the main paths: {probe_launches}")
    if occ_launches != frames * per_frame or per_frame == 0:
        raise AssertionError(f"occlusion kernel launched {occ_launches} times for {frames} frames "
                             f"x {per_frame} traced slot faces")
    if ras_launches != frames:
        raise AssertionError(f"raster kernel launched {ras_launches} times for {frames} rt frames")
    rt_shades = frames * shades(rt_renderer.cfg, rt_renderer.config)
    if tpbr.SHADE.launches != rt_shades:
        raise AssertionError(f"kernel 7 launched {tpbr.SHADE.launches} times for {frames} rt "
                             f"frames, want {rt_shades}")
    if tshadow.SIGNATURE.launches != frames * signatures(rt_renderer.cfg, rt_renderer.config):
        raise AssertionError(f"kernel 8 launched {tshadow.SIGNATURE.launches} times for {frames} "
                             f"rt frames")
    kernels["occlusion_tiles"]["launches"] = occ_launches
    path_launches["rt"] = ras_launches
    img_rt, coverage, brightness = check_image(rt_out)
    darker = (img_base - img_rt).mean(axis=-1) > 0.05
    covered = (rt_out["vis"].tri_id >= 0).cpu().numpy()
    dark_share = float(darker[covered].mean())
    if dark_share < 0.005:
        raise AssertionError(f"rt frame darker than the rt-off frame on only {100 * dark_share:.2f}% "
                             "of covered pixels")
    write_png(os.path.join(enable_persistent_cache(), "chip_smoke_rt_frame.png"),
              np.clip(img_rt, 0.0, 1.0))
    rt_passes = replayed_pass_ms(rt_renderer, dev)
    phase("rt_main_path", f"{rt_ms:.2f} ms/frame = {1e3 / rt_ms:.2f} FPS over {FRAMES} frames vs "
                          f"base {frame_ms:.2f} ms/frame ({card}); traced slots "
                          f"{[sl for sl in slots if sl is not None]}; occlusion launches "
                          f"{occ_launches} = frames {frames} x {per_frame}, raster launches "
                          f"{ras_launches}, add_one/transpose launches on both main paths "
                          f"{probe_launches}; coverage {coverage:.3f}, mean {brightness:.3f}, darker "
                          f"than rt-off by > 0.05 on {100 * dark_share:.2f}% of covered pixels; pass ms "
                          + json.dumps({k: round(v, 3) for k, v in rt_passes.items()}))

    # 12. rt frame, kernel vs plain occlusion ------------------------------------
    def rt_frame():
        r = Renderer(scene, rt_cfgs[2], device=dev, replay=False)  # one frame, maybe the plain walk
        r.set_config(rt=True)
        r.apply_config_now()
        with Recorder(trt, "occlusion_grid") as rec:
            img = r.render(cam)["image"]
        return img, [out for _, _, out in rec.calls]

    ref_img, ref_planes = rt_frame()
    kernel = trt.occlusion_kernel
    trt.occlusion_kernel = oc.occlusion_tiles_plain  # the plain version on CUDA tensors
    try:
        plain_img, plain_planes = rt_frame()
    finally:
        trt.occlusion_kernel = kernel
    if len(ref_planes) != len(plain_planes) or not all(
            torch.equal(a, b) for a, b in zip(ref_planes, plain_planes)):
        raise AssertionError("rt frame occlusion planes differ between kernel and plain version")
    if not torch.equal(ref_img, plain_img):
        raise AssertionError("rt frame image differs between kernel and plain occlusion")
    rt_psnr = psnr(np.clip(ref_img.cpu().numpy(), 0, 1), np.clip(plain_img.cpu().numpy(), 0, 1))
    if rt_psnr < PSNR_GATE_DB:
        raise AssertionError(f"rt frame PSNR kernel vs plain {rt_psnr:.1f} dB")
    phase("rt_vs_plain", f"{len(ref_planes)} occlusion planes and the images identical; "
                         f"display-clamped PSNR {'inf' if math.isinf(rt_psnr) else f'{rt_psnr:.1f}'} dB")

    # 13. rt profile ------------------------------------------------------------
    profile_main_path("rt_profile", rt_renderer, dev, card)

    tier_ms = shadow_phases(scene, prepared, cfg, renderer, frame_ms, path_launches, dev, card)
    city = culling_phases(scene, prepared, cfg, renderer, kernel_ms, path_launches, dev, card)
    tier_phases(scene, cfg, renderer, frame_ms, path_launches, dev, card)
    runtime_phases(scene, cfg, renderer, frame_ms, city, path_launches, dev, card)
    plain_phases(scene, cfg, path_launches, dev, card)
    kernels["scan_raster"] = scan_raster_phase(scene, cfg, dev, card)
    kernels["rt_brute"] = rt_brute_phase(dev, card)
    kernels["shade"] = shade_phase(cfg, dev, card)
    bench_phase(tier_ms, scene, cfg, dev, card)
    split_phase(scene, cfg, path_launches, kernels, dev, card)
    graph_phase(scene, cfg, path_launches, dev, card)
    envelope_phase(cfg, path_launches, dev, card)
    kernels["raster_tiles"]["launches"] = sum(path_launches.values())
    for name, k in (("scan_raster", rs.SCAN_RASTER), ("rt_brute", brute.RT_BRUTE)):
        kernels[name]["launches"] = sum(plain_path_launches[k.symbol].values())
        if not kernels[name]["launches"]:
            raise AssertionError(f"{name} was launched no time on the plain paths")
    phase("launches", f"raster kernel launches per main path, each counted from 0: "
                      f"{json.dumps(path_launches)}, {sum(path_launches.values())} in all; "
                      f"kernel 5 (scan raster) per plain path "
                      f"{json.dumps(plain_path_launches[rs.SCAN_RASTER.symbol])}, kernel 6 "
                      f"(brute-force rt) {json.dumps(plain_path_launches[brute.RT_BRUTE.symbol])}, "
                      f"occlusion kernel {kernels['occlusion_tiles']['launches']}, kernel 7 "
                      f"(shading) per replayed frame {json.dumps(kernels['shade']['launches'])}")

    phase("phase_seconds", "host seconds of each phase, from the line before it: "
                           + json.dumps(PHASE_SECONDS))
    phase("total", f"chip_smoke ran {time.perf_counter() - t_start:.1f} s ({card})")
    print(json.dumps({"kernels": [kernels[k] for k in
                                  ("raster_tiles", "occlusion_tiles", "add_one", "transpose",
                                   "scan_raster", "rt_brute", "shade")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
