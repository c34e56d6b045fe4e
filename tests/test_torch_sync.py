"""The frame makes no blocking host-device synchronization: after warm-up
(each switch set's first frame captures its program), the replayed
base, rt, shadowed exact and shadowed checkerboard+fix frames, the
occlusion-culled, frozen, debug-AABB and cluster-culled ones, and the
skinned (pose pass and per-corner cull), quarter-rate, SSAA, Lambert,
reference-view and HUD ones, the plain configuration's frames
(``tile_raster=False``: the scan rasterizer, brute-force rt), a few of
them eagerly (``Renderer(replay=False)``), ``render_forward`` and the split frame over two shards of the card
(base, checkerboard+fix, shadowed checkerboard+fix, rt; replayed and
eager; and over one shard per card, up to four, where the host has two
or more) render, and the scene streamer's pumps and
the projectile step run, under ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
operation that waits for the card (a blocking copy between host and card,
``.item()``, ``nonzero``, a stream synchronization). The cameras are made
by ``orbit_camera`` inside that window, as a render loop makes them, and
so are the HUD's overlay tables (host numpy, copied pinned). The split frame's
shards also hand each other work in the order it was queued: on one card
(and across two, where the host has them) a shard reads what another
wrote before a collective, and each works on the caller's stream. On the card
only:

    python -m pytest tests/test_torch_sync.py -m gpu -q
"""

import dataclasses

import pytest
import torch

from renderer_tpu_torch.parallel import make_mesh, run_shards

from renderer_tpu_torch.mathx import orbit_camera
from renderer_tpu_torch.models import sponza_like_scene
from renderer_tpu_torch.ops.overlay import hud_overlay
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer

CFG = PipelineConfig(width=256, height=128, tri_capacity=8192, aa="edge", trilinear=False,
                     shadow_size=256)
FRAMES = {  # name -> (config changes, switches)
    "base": ({}, {}),
    "skinned": (dict(skinning=True), {}),
    "quarter_fix": (dict(shade_rate="quarter"), {}),
    "ssaa2": (dict(ssaa=2), {}),
    "lambert": (dict(shading="lambert", aa="none"), {}),
    "reference_image": ({}, dict(reference_image=True)),
    "hud": ({}, dict(hud=True)),
    "rt": ({}, dict(rt=True)),
    "shadowed_exact": ({}, dict(shadows=True)),
    "shadowed_checkerboard_fix": (dict(shade_rate="checkerboard"), dict(shadows=True)),
    "shadowed_progressive": (dict(shade_rate="checkerboard", shadow_update_budget=1,
                                  shadow_progressive=4), dict(shadows=True)),
    "occlusion": ({}, dict(occlusion_culling=True)),
    "freeze": ({}, dict(freeze_culling=True)),
    "debug_aabbs": ({}, dict(debug_aabbs=True)),
    "cluster_cull": (dict(cluster_cull=True), {}),
    "plain": (dict(tile_raster=False), {}),
    "plain_rt": (dict(tile_raster=False), dict(rt=True)),
    "plain_shadowed_checkerboard_fix": (dict(tile_raster=False, shade_rate="checkerboard"),
                                        dict(shadows=True)),
    "plain_quarter_fix": (dict(tile_raster=False, shade_rate="quarter"), {}),
    "plain_freeze": (dict(tile_raster=False), dict(freeze_culling=True)),
}


# frames also rendered eagerly (Renderer(replay=False)); FRAMES are replayed
EAGER_FRAMES = ("base", "hud", "shadowed_checkerboard_fix", "shadowed_progressive", "rt",
                "plain_rt")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_makes_no_blocking_sync(name):
    """The frames after each switch set's first (its capture) are replays."""
    r = _frames_without_sync(name, replay=True)
    assert r.stats["compiles"] >= 1 and all(p.graphs for p in r.programs.values())


@pytest.mark.gpu
@pytest.mark.parametrize("name", EAGER_FRAMES)
def test_eager_frame_makes_no_blocking_sync(name):
    r = _frames_without_sync(name, replay=False)
    assert r.stats["compiles"] == 0 and not r.programs


def _frames_without_sync(name: str, replay: bool) -> Renderer:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    changes, switches = FRAMES[name]
    aspect = CFG.width / CFG.height
    r = Renderer(sponza_like_scene(256, device=dev), dataclasses.replace(CFG, **changes),
                 device=dev, replay=replay)
    def frame(k):
        overlay = hud_overlay(f"frame {k}\nHUD 1.25 ms", CFG.width) if "hud" in switches else None
        return r.render(orbit_camera(0.3 + 0.01 * k, aspect, dev), time_s=k / 60.0,
                        overlay=overlay)

    for k in range(3):  # warm-up: kernels built, plan and cache state made
        if k == 1:  # after one frame without them: freezing keeps a culled list
            r.set_config(**switches)
            r.apply_config_now()
        frame(k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(3, 6):
            out = frame(k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    img = out["image"]
    assert img.shape == (CFG.height, CFG.width, 3) and bool(torch.isfinite(img).all())
    return r


@pytest.mark.gpu
def test_streaming_and_projectiles_make_no_blocking_sync():
    """Every ``pump()`` (meshes, one chunked past CHUNK_VERTS, and a texture
    resized to the layer size, staged through the page-locked arena), a
    projectile step and a frame, under ``set_sync_debug_mode("error")``;
    after ``close()`` the arena holds no block and the streamed vertices
    are on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from renderer_tpu_torch.runtime.allocator import Arena
    from renderer_tpu_torch.runtime.gameplay import ProjectileSystem
    from renderer_tpu_torch.runtime.streaming import CHUNK_VERTS, SceneStreamer
    from renderer_tpu_torch.scene import SceneLimits, primitives

    dev = torch.device("cuda")
    limits = SceneLimits(max_instances=1024, max_vertices=1 << 16, max_triangles=1 << 16,
                         max_materials=64, max_lights=4)
    scene = sponza_like_scene(256, limits=limits, texture_slots=6, device=dev)
    projectiles = ProjectileSystem(scene, mesh_id=1, material_id=0, capacity=32)
    projectiles.step()  # the slots it reserves count as live before the streamer starts
    arena = Arena(64 << 20, device=dev)
    streamer = SceneStreamer(scene, budget=2, arena=arena)
    big = primitives.uv_sphere(rings=64, sectors=96)
    assert len(big.positions) > CHUNK_VERTS
    streamer.request_mesh(big, translation=(0.0, 2.0, 0.0), scale=3.0)
    for i in range(3):
        streamer.request_mesh(primitives.torus(), translation=(3.0 * i, 1.0, 2.0))
    streamer.request_texture(np.random.default_rng(0).integers(0, 256, (512, 512, 4),
                                                               dtype=np.uint8))
    r = Renderer(scene, CFG, device=dev)
    aspect = CFG.width / CFG.height
    r.render(orbit_camera(0.3, aspect, dev))
    for f in streamer._pending:
        f.result(timeout=120)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(1, 6):
            streamer.pump()
            projectiles.step()
            out = r.render(orbit_camera(0.3 + 0.01 * k, aspect, dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert streamer.stats["uploaded"] == 5 and arena.pinned
    streamer.close()
    assert arena.stats()["live_allocs"] == 0
    lib = scene.meshes
    off = int(lib.mesh_vertex_offset[int(lib.mesh_count) - 4])
    assert torch.equal(lib.positions[off:off + len(big.positions)].cpu(),
                       torch.from_numpy(big.positions))
    assert projectiles.alive_count() > 0
    img = out["image"]
    assert img.shape == (CFG.height, CFG.width, 3) and bool(torch.isfinite(img).all())
    arena.close()


@pytest.mark.gpu
def test_render_forward_makes_no_blocking_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from renderer_tpu_torch.passes.forward import render_forward

    dev = torch.device("cuda")
    scene = sponza_like_scene(64, device=dev)
    aspect = CFG.width / CFG.height
    render_forward(scene, orbit_camera(0.3, aspect, dev), CFG.width, CFG.height, 4096)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, vis = render_forward(scene, orbit_camera(0.31, aspect, dev), CFG.width, CFG.height,
                                  4096)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert img.shape == (CFG.height, CFG.width, 3) and bool(torch.isfinite(img).all())
    assert bool((vis.tri_id >= 0).any())


SPLIT_FRAMES = {  # name -> (config changes, switches), over two shards of the card
    "base": ({}, {}),
    "checkerboard_fix": (dict(shade_rate="checkerboard"), {}),
    "shadowed_checkerboard_fix": (dict(shade_rate="checkerboard"), dict(shadows=True)),
    "rt": ({}, dict(rt=True)),
}


def _split_frames(name: str, devices, replay=None):
    """The single-shard frame on the first device and the split frame over
    ``devices`` (replayed by default), after warm-up, the split frames
    under sync-debug "error"; asserts they are the same frame (tri_id
    equal, image within 2e-6)."""
    dev = torch.device(devices[0])
    changes, switches = SPLIT_FRAMES[name]
    scene = sponza_like_scene(256, device=dev)
    cfg = dataclasses.replace(CFG, **changes)
    renderers = [Renderer(scene, cfg, device=dev),
                 Renderer(scene, dataclasses.replace(cfg, spmd_devices=len(devices)),
                          spmd_mesh=make_mesh(devices), replay=replay)]
    aspect = CFG.width / CFG.height
    for r in renderers:
        r.set_config(**switches)
        r.apply_config_now()
        for k in range(2):  # warm-up: kernels built, plans and the atlas made
            r.render(orbit_camera(0.3 + 0.01 * k, aspect, dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(2, 5):
            out = renderers[1].render(orbit_camera(0.3 + 0.01 * k, aspect, dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    one = renderers[0].render(orbit_camera(0.3 + 0.01 * 4, aspect, dev))
    programs = renderers[1].programs.values()
    assert (replay is False) == (not programs) and all(p.graphs for p in programs)
    img = out["image"]
    assert img.shape == (CFG.height, CFG.width, 3) and bool(torch.isfinite(img).all())
    assert torch.equal(out["vis"].tri_id, one["vis"].tri_id)
    assert (img - one["image"]).abs().max().item() <= 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SPLIT_FRAMES))
def test_split_frame_makes_no_blocking_sync(name):
    """Two shards on the card, replayed (their segments launched from the
    caller's thread), render the single-shard frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _split_frames(name, ["cuda:0"] * 2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SPLIT_FRAMES))
def test_eager_split_frame_makes_no_blocking_sync(name):
    """Two shards on the card, eager, wait for each other on the host
    only, and render the single-shard frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _split_frames(name, ["cuda:0"] * 2, replay=False)


@pytest.mark.gpu
@pytest.mark.parametrize("replay", [None, False], ids=["replayed", "eager"])
@pytest.mark.parametrize("name", sorted(SPLIT_FRAMES))
def test_split_frame_across_cards(name, replay):
    """One shard per card (up to four), replayed and eager, the same frame."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    _split_frames(name, [f"cuda:{i}" for i in range(min(4, torch.cuda.device_count()))], replay)


def _handoff(devices, side_stream: bool):
    """Shard 0 writes a tensor through a long queue of work and hands it to
    shard 1 before that work has run; shard 1 must read the written
    values. Returns what shard 1 read and the streams the shards ran on."""
    mesh = make_mesh(devices)
    a = torch.randn(2048, 2048, device=mesh.devices[0])

    def fn(s):
        x = torch.zeros(2048, 2048, device=s.device)
        if s.axis_index() == 0:
            for _ in range(20):  # tens of ms of queued work before the value is final
                x = x + a @ a * 1e-3
        got = s.all_gather(x)[:2048]  # shard 0's
        return got.sum(), torch.cuda.current_stream(s.device)

    stream = torch.cuda.Stream(mesh.devices[0]) if side_stream else None
    with torch.cuda.stream(stream):
        results = run_shards(mesh, fn)
        want = a @ a * 1e-3 * 20
    torch.cuda.synchronize()
    return results, want.sum(), stream


@pytest.mark.gpu
@pytest.mark.parametrize("side_stream", [False, True])
def test_shards_on_one_card_are_ordered(side_stream):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    results, want, stream = _handoff(["cuda:0"] * 2, side_stream)
    assert torch.allclose(results[1][0], want, rtol=1e-3)
    if stream is not None:
        assert all(r[1] == stream for r in results)


@pytest.mark.gpu
def test_shards_across_cards_are_ordered():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    results, want, _ = _handoff(["cuda:0", "cuda:1"], False)
    assert results[1][0].device == torch.device("cuda:1")
    assert torch.allclose(results[1][0].to(want.device), want, rtol=1e-3)
