"""The port's runtime extras against the JAX package's: projectiles
(runtime/gameplay.py), the camera controller, FrameStats and trace
(utils/profiling.py), the HUD's fps, arena and streaming lines, checkpoints
(runtime/checkpoint.py over utils/tree.py), auto-capacity
(runtime/autocap.py) and kernel live-reload (runtime/reload.py).

Gates, with their reasons:
- projectiles: 120 seeded steps (spawn on and off, positions and
  velocities drawn from a numpy seed) through both packages: the alive
  mask equal after every step, translations within 1e-5 (float32 on both
  sides, the gravity step rounded alike);
- the camera controller: the same states (the same numpy code, equal),
  and the cameras' view and viewproj matrices within 1e-6;
- the HUD's fps, staging-arena and streaming lines equal to JAX's text
  for the same frame statistics, arena history and streamer stats;
- a checkpoint of a renderer with streamed content, loaded into a fresh
  renderer: the next frame identical to the original's next frame; a
  wrong shape or dtype raises ValueError;
- auto-capacity on sponza_like_scene(300, area=20.0) at 64x64 with
  test_auto_capacity_ladder's ladder: per check, the tier and the demand
  equal to JAX's (integers). The draw-list count is not compared: the
  JAX AutoCapacityRenderer runs its XLA raster path by default, whose
  truncated cull keeps other triangles than the Pallas path the port
  follows (222 against 491 at tier 512 here); the demand drives the
  trajectory on this walk;
- reload: editing a watched module gives the next frame the new code; a
  broken edit keeps the old plan rendering, counts one failure and says
  why; a kernel source whose rebuild fails (nvcc made to fail) keeps the
  old library and kernel objects and counts one failure.
"""

import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.mathx import camera as jcam_mod
from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models import sponza_like_scene as jax_sponza
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import AutoCapacityRenderer as JaxAutoCap
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.runtime import camera_controller as jcc
from renderer_tpu.runtime import hud as jhud
from renderer_tpu.runtime.allocator import Arena as JaxArena
from renderer_tpu.runtime.gameplay import ProjectileSystem as JaxProjectiles
from renderer_tpu.runtime.streaming import SceneStreamer as JaxStreamer
from renderer_tpu.scene import primitives as jprim
from renderer_tpu.utils.profiling import FrameStats as JaxFrameStats
from renderer_tpu_torch.mathx import Camera, camera as tcam_mod
from renderer_tpu_torch.models import box_scene, sponza_like_scene
from renderer_tpu_torch.ops import cuda_build
from renderer_tpu_torch.passes.pipeline import Pass, PipelineConfig
from renderer_tpu_torch.runtime import AutoCapacityRenderer, KernelReloader, Renderer
from renderer_tpu_torch.runtime import camera_controller as tcc
from renderer_tpu_torch.runtime import checkpoint, hud
from renderer_tpu_torch.runtime.allocator import Arena
from renderer_tpu_torch.runtime.gameplay import ProjectileSystem
from renderer_tpu_torch.runtime.streaming import SceneStreamer
from renderer_tpu_torch.scene import primitives
from renderer_tpu_torch.utils.profiling import FrameStats, trace
from test_torch_streaming import both_scenes, wait


def test_projectiles_match_jax():
    port_scene, jax_scene = both_scenes()
    port = ProjectileSystem(port_scene, mesh_id=0, material_id=0, capacity=8)
    jax = JaxProjectiles(jax_scene, mesh_id=0, material_id=0, capacity=8)
    assert port.base == jax.base == 1
    rng = np.random.default_rng(12)
    sl = slice(port.base, port.base + port.capacity)
    for k in range(120):
        kw = dict(dt=1 / 60, ttl=0.4, spawn_pos=tuple(rng.uniform(-1, 1, 3)),
                  spawn_vel=tuple(rng.uniform(-3, 6, 3)), spawn=bool(rng.random() < 0.6))
        port.step(**kw)
        jax.step(**kw)
        inst, want = port.scene.instances, jax.scene.instances
        assert np.array_equal(inst.alive.numpy(), np.asarray(want.alive)), k
        np.testing.assert_allclose(inst.translation[sl].numpy(), np.asarray(want.translation[sl]),
                                   rtol=0, atol=1e-5, err_msg=str(k))
        assert int(inst.count) == int(want.count)
    assert port.alive_count() == jax.alive_count() > 0
    for name in ("mesh_id", "material_id", "scale"):
        assert np.array_equal(getattr(port.scene.instances, name).numpy(),
                              np.asarray(getattr(jax.scene.instances, name)))


def test_camera_controller_matches_jax():
    rng = np.random.default_rng(3)
    port = tcc.CameraState(position=np.array([0.0, 0.5, 4.0], np.float32))
    jax = jcc.CameraState(position=np.array([0.0, 0.5, 4.0], np.float32))
    for k in range(40):
        f = dict(forward=float(rng.uniform(-1, 1)), strafe=float(rng.uniform(-1, 1)),
                 up=float(rng.uniform(-1, 1)), look_dx=float(rng.uniform(-0.2, 0.2)),
                 look_dy=float(rng.uniform(-0.2, 0.2)), speed=3.0, toggle_fly=k % 13 == 5)
        port = tcc.step(port, tcc.InputFrame(**f), 1 / 30)
        jax = jcc.step(jax, jcc.InputFrame(**f), 1 / 30)
        assert np.array_equal(port.position, jax.position)
        assert (port.yaw, port.pitch, port.fly_mode) == (jax.yaw, jax.pitch, jax.fly_mode)
        got = tcam_mod.camera_matrices(tcc.to_camera(port, aspect=2.0, device="cpu"))
        want = jcam_mod.camera_matrices(jcc.to_camera(jax, aspect=2.0))
        for i in (0, 2):  # view, viewproj
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0, atol=1e-6)
    r = Renderer(box_scene(device="cpu"), PipelineConfig(width=64, height=64, tri_capacity=256))
    s = tcc.CameraState(position=np.array([0.0, 0.5, 4.0], np.float32))
    imgs = []
    for _ in range(3):
        s = tcc.step(s, tcc.InputFrame(forward=1.0, speed=6.0), 1 / 30)
        imgs.append(r.render(tcc.to_camera(s, device="cpu"))["image"].numpy())
    assert np.abs(imgs[2] - imgs[0]).max() > 0.02  # moving toward the box


def test_frame_stats_and_trace(tmp_path):
    fs = FrameStats(window=4)
    for _ in range(6):
        fs.tick()
        time.sleep(0.001)
    s = fs.summary()
    assert s["fps"] > 0 and s["ms_avg"] > 0 and len(fs.samples) <= 4
    assert FrameStats().summary() == JaxFrameStats().summary()
    r = Renderer(box_scene(device="cpu"), PipelineConfig(width=64, height=64, tri_capacity=256))
    with trace(str(tmp_path / "trace")) as log_dir:
        r.render(Camera.create([0.0, 0.5, 3.0], device="cpu"))
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "forward.raster" in names and "forward.shade" in names


def test_hud_arena_and_streaming_lines_match_jax():
    port_scene, jax_scene = both_scenes()
    r = Renderer(port_scene, PipelineConfig(width=64, height=64, tri_capacity=256))
    jr = JaxRenderer(jax_scene, JaxConfig(width=64, height=64, tri_capacity=256))
    cam = [0.0, 0.8, 4.0]
    r.render(Camera.create(cam, device="cpu"))
    jr.render(JaxCamera.create(position=jnp.asarray(cam)))
    stats = FrameStats(), JaxFrameStats()
    for fs in stats:
        fs.samples = [0.016, 0.017, 0.021, 0.015]
    arenas = Arena(1 << 16, device="cpu"), JaxArena(1 << 16)
    for a in arenas:
        kept = [a.alloc((100,), np.float32), a.alloc((3000,), np.uint8)]
        a.free(kept[0])
    streamers = SceneStreamer(port_scene, budget=3), JaxStreamer(jax_scene, budget=3)
    for s, prim in zip(streamers, (primitives, jprim)):
        for i in range(5):
            s.request_mesh(prim.uv_sphere(rings=4, sectors=6), translation=(i - 2.0, 0, -1))
    wait(*streamers)
    for s in streamers:
        s.pump()
    got = hud.format_hud(r, frame_stats=stats[0], arena=arenas[0], streamer=streamers[0],
                         extra={"coverage": "42%"})
    want = jhud.format_hud(jr, frame_stats=stats[1], arena=arenas[1], streamer=streamers[1],
                           extra={"coverage": "42%"})
    picks = ("fps:", "staging arena:", "streaming:", "coverage:")
    got_lines = [ln for ln in got.split("\n") if ln.startswith(picks)]
    assert len(got_lines) == 4
    assert got_lines == [ln for ln in want.split("\n") if ln.startswith(picks)]
    assert "live allocs 1" in got and "3/5 uploaded (2 decoded+queued)" in got
    for s in streamers:
        s.close()


def test_checkpoint_round_trip(tmp_path):
    """A renderer whose scene holds streamed content, saved and loaded into
    a fresh renderer of a scene of the same shapes: the next frames equal."""
    port_scene, _ = both_scenes()
    streamer = SceneStreamer(port_scene, budget=4)
    streamer.request_mesh(primitives.uv_sphere(rings=8, sectors=12), translation=(1.0, 0, 0))
    wait(streamer)
    streamer.pump()
    streamer.close()
    cfg = PipelineConfig(width=64, height=64, tri_capacity=512)
    r = Renderer(port_scene, cfg)
    r.set_config(occlusion_culling=True)
    r.render(Camera.create([0.0, 0.8, 4.0], device="cpu"))
    prefix = str(tmp_path / "ck")
    checkpoint.save_renderer(prefix, r)
    fresh = Renderer(both_scenes()[0], cfg)
    checkpoint.load_renderer(prefix, fresh)
    assert fresh.config.occlusion_culling and fresh.stats["frames"] == 1
    cam = Camera.create([0.3, 0.8, 3.5], device="cpu")
    a, b = r.render(cam), fresh.render(cam)
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["vis"].tri_id, b["vis"].tri_id)
    assert int(fresh.scene.meshes.mesh_count) == 2
    like = fresh.state
    bad_shape = dict(like, prev_vp=torch.zeros(3, 4))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_pytree(prefix + ".state.npz", bad_shape)
    bad_dtype = dict(like, prev_vp=torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load_pytree(prefix + ".state.npz", bad_dtype)


def test_auto_capacity_matches_jax():
    ladder = (512, 2048, 8192, 32768)
    port = AutoCapacityRenderer(sponza_like_scene(300, area=20.0, device="cpu"),
                                PipelineConfig(width=64, height=64), ladder=ladder,
                                check_every=1)
    jax = JaxAutoCap(jax_sponza(300, area=20.0), JaxConfig(width=64, height=64, shading="pbr"),
                     ladder=ladder, check_every=1)
    views = [([0.0, 3.0, 14.0], dict(fov_y=1.0, near=0.1, far=100.0))] * 6
    views += [([0.0, 500.0, 0.0], dict(fov_y=0.4, near=0.1, far=10.0))] * 8
    got, want = [], []
    for pos, cam in views:
        out = port.render(Camera.create(pos, device="cpu", **cam))
        jax.render(JaxCamera.create(position=jnp.asarray(pos), **cam))
        got.append((port.capacity, port.stats["last_demand"]))
        want.append((jax.capacity, jax.stats["last_demand"]))
    assert got == want
    caps = [c for c, _ in got]
    assert max(caps) > 512 and caps[-1] < max(caps)  # climbs, then descends
    assert np.isfinite(out["image"].numpy()).all()
    assert port.stats["tier_switches"] == jax.stats["tier_switches"]


@pytest.fixture
def hot_module(tmp_path):
    """A watched module ``hot_shade_torch`` with a TINT, importable."""
    path = tmp_path / "hot_shade_torch.py"
    path.write_text("TINT = 0.0\n")
    sys.path.insert(0, str(tmp_path))
    try:
        yield path
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("hot_shade_torch", None)


def hot_plan(cfg, outputs, light_casts, **switches):
    import hot_shade_torch as hs

    def shade(camera):
        return {"image": torch.full((4, 4, 3), hs.TINT)}

    return [Pass("shade", ("camera",), ("image",), shade)]


def edit(path, text):
    time.sleep(0.01)
    path.write_text(text)
    os.utime(path)  # the mtime moves even on a coarse filesystem


def test_reload_swaps_a_changed_module(hot_module):
    r = Renderer(box_scene(device="cpu"), PipelineConfig(width=64, height=64, tri_capacity=256),
                 outputs=("image",))
    r.plan_builder = hot_plan
    reloader = KernelReloader(r, rebuild=lambda: hot_plan, modules=["hot_shade_torch"],
                              sources=[])
    cam = Camera.create([0.0, 0.0, 3.0], device="cpu")
    assert r.render(cam)["image"].max() == 0.0
    assert reloader.poll() is False
    edit(hot_module, "TINT = 0.5\n")
    assert reloader.poll() is True and reloader.stats["reloads"] == 1
    assert torch.all(r.render(cam)["image"] == 0.5)
    edit(hot_module, "TINT = (unclosed\n")  # broken: the old plan keeps rendering
    assert reloader.poll() is False
    assert reloader.stats == {"reloads": 1, "failures": 1}
    assert reloader.last_error.startswith("SyntaxError")
    assert torch.all(r.render(cam)["image"] == 0.5)
    assert reloader.poll() is False and reloader.stats["failures"] == 1  # not retried


def test_reload_keeps_the_old_kernel_when_its_rebuild_fails(tmp_path, monkeypatch):
    source = tmp_path / "probe_copy.cu"
    source.write_text(open(os.path.join(cuda_build.CSRC, "probe.cu")).read())
    monkeypatch.setattr(cuda_build, "LIBRARIES", {})
    lib = cuda_build.library(str(source))
    kernel = lib.kernel("rtt_add_one", [])
    old_path = lib.path
    assert cuda_build.library(str(source)) is lib and lib.kernel("rtt_add_one", []) is kernel

    def failing_load(self):
        raise RuntimeError(f"nvcc failed on {self.source}: error: expected ';'")

    monkeypatch.setattr(cuda_build.CudaLibrary, "load", failing_load)
    r = Renderer(box_scene(device="cpu"), PipelineConfig(width=64, height=64, tri_capacity=256))
    reloader = KernelReloader(r, modules=[], sources=[str(source)])
    cam = Camera.create([0.0, 0.5, 3.0], device="cpu")
    before = r.render(cam)["image"]
    plans, builder = dict(r._plans), r.plan_builder
    edit(source, source.read_text() + "\n// edited\n")
    assert reloader.poll() is False
    assert reloader.stats == {"reloads": 0, "failures": 1}
    assert "nvcc failed" in reloader.last_error
    assert lib.kernels == [kernel] and kernel.library is lib and lib.path == old_path
    assert r.plan_builder is builder and r._plans == plans
    assert torch.equal(r.render(cam)["image"], before)

