"""The port runs without jax and without the JAX package: the port package
(the split frame over a CPU mesh included),
chip_smoke.py, chip_ab.py and bench_torch.py import neither, directly or
indirectly, and bench_torch.py does not import bench.py (the machine with
the card has no jax installed, and the port stands alone). Nor does it need
Pillow for PNG textures or their resize: the machine with the card has
none."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRAME = """
import sys
sys.modules["PIL"] = None  # the card's machine has no Pillow: importing it raises
sys.path.insert(0, "tests")  # torch_raster_cases
import numpy as np
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import textured_scene
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneLimits
r = Renderer(textured_scene(SceneLimits.tiny(), 32, device="cpu"),
             PipelineConfig(width=128, height=64, tri_capacity=2048, aa="edge",
                            shade_rate="checkerboard", shadow_size=128))
cam = Camera.create([0.0, 1.2, 4.0], fov_y=0.9, aspect=2.0, device="cpu")
switch_sets = [dict(shadows=shadows, rt=rt) for shadows, rt in ((False, True), (True, False))]
switch_sets += [dict(occlusion_culling=True), dict(freeze_culling=True), dict(debug_aabbs=True),
                 dict(reference_image=True), dict(hud=True)]
for switches in [{}] + switch_sets:
    r.set_config(**{**{k: False for k in vars(r.config)}, **switches})
    r.apply_config_now()
    img = r.render(cam)["image"].numpy()
    assert img.shape == (64, 128, 3) and np.isfinite(img).all()
import dataclasses
from renderer_tpu_torch.passes.forward import render_forward
plain = Renderer(r.scene, dataclasses.replace(r.cfg, tile_raster=False))
for switches in ({}, dict(rt=True), dict(shadows=True)):
    plain.set_config(**{**{k: False for k in vars(plain.config)}, **switches})
    plain.apply_config_now()
    assert np.isfinite(plain.render(cam)["image"].numpy()).all()
img, _ = render_forward(r.scene, cam, 128, 64, 2048)
assert np.isfinite(img.numpy()).all()
from renderer_tpu_torch.parallel import make_mesh, render_frame_spmd
split = Renderer(r.scene, dataclasses.replace(r.cfg, spmd_devices=2),
                 spmd_mesh=make_mesh(["cpu"] * 2))
split.set_config(rt=True)
split.apply_config_now()
assert split.render(cam)["image"].shape == (64, 128, 3)
img, _, _ = render_frame_spmd(r.scene, cam, make_mesh(["cpu"] * 2), 128, 64, 1024)
assert np.isfinite(img.numpy()).all()
from renderer_tpu_torch.models import city_scene
city = Renderer(city_scene(3, device="cpu"),
                PipelineConfig(width=128, height=64, tri_capacity=4096, cluster_cull=True))
assert np.isfinite(city.render(cam)["image"].numpy()).all()
import os, tempfile
from renderer_tpu_torch import demo
from renderer_tpu_torch.graph import dot  # noqa: F401
from renderer_tpu_torch.ops import overlay, skin  # noqa: F401
from renderer_tpu_torch.runtime import hud  # noqa: F401
out = os.path.join(tempfile.mkdtemp(), "demo.png")
demo.main(["--scene", "skinned", "--size", "64", "--out", out, "--device", "cpu", "--hud",
           "--dump-graphs"])
assert os.path.exists(out)
import json, time
from renderer_tpu_torch.models import colonnade_scene
from renderer_tpu_torch.runtime import AutoCapacityRenderer, KernelReloader, checkpoint
from renderer_tpu_torch.runtime.allocator import Arena
from renderer_tpu_torch.runtime.camera_controller import CameraState, to_camera
from renderer_tpu_torch.runtime.gameplay import ProjectileSystem
from renderer_tpu_torch.runtime.streaming import SceneStreamer
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits
from renderer_tpu_torch.scene.gltf import load_gltf
from renderer_tpu_torch.utils.image import write_png
from renderer_tpu_torch.utils.profiling import FrameStats, trace
import base64
from renderer_tpu_torch.scene import primitives
d = tempfile.mkdtemp()
write_png(os.path.join(d, "t.png"), np.random.default_rng(0).uniform(size=(40, 24, 4)))
box = primitives.box()
blob = box.positions.tobytes() + box.indices.astype(np.uint32).tobytes()
json.dump({"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(blob),
           "uri": "data:application/octet-stream;base64," + base64.b64encode(blob).decode()}],
           "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": box.positions.nbytes},
                           {"buffer": 0, "byteOffset": box.positions.nbytes,
                            "byteLength": box.indices.size * 4}],
           "accessors": [{"bufferView": 0, "componentType": 5126, "count": len(box.positions),
                          "type": "VEC3"},
                         {"bufferView": 1, "componentType": 5125, "count": box.indices.size,
                          "type": "SCALAR"}],
           "images": [{"uri": "t.png"}], "textures": [{"source": 0}],
           "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                       "material": 0}]}],
           "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}]},
          open(os.path.join(d, "t.gltf"), "w"))
b = load_gltf(os.path.join(d, "t.gltf"), SceneBuilder(SceneLimits(), atlas_size=32))
assert b._materials[0]["base_color_tex"] == 0
b = load_gltf("assets/colonnade.glb", b)
b.add_texture(np.random.default_rng(1).integers(0, 256, (50, 70, 4), dtype=np.uint8))
scene = b.build(texture_slots=3, device="cpu")
s = SceneStreamer(scene, arena=Arena(1 << 22, device="cpu"))
s.request_texture(np.zeros((20, 9, 4), np.uint8))
s.request_mesh("assets/colonnade.glb")
while s.stats["uploaded"] < 2:
    time.sleep(0.01)
    s.pump()
s.close()
ProjectileSystem(scene, 0, 0, 4).step()
print("PIL blocked:", "PIL" in sys.modules and sys.modules["PIL"] is None)
import bench_torch, chip_ab, chip_smoke, torch_raster_cases  # noqa: F401
assert "bench" not in sys.modules
import renderer_tpu_torch.ops.probe_cuda  # noqa: F401
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "renderer_tpu"))
print("JAX_MODULES", loaded)
"""

# import statements that name jax or the JAX package (renderer_tpu, not
# renderer_tpu_torch)
IMPORT = re.compile(r"^\s*(import\s+(jax|renderer_tpu)\b(?!_)|from\s+(jax|renderer_tpu)\b(?!_))", re.M)
# import statements that name bench.py (bench, not bench_torch)
BENCH_IMPORT = re.compile(r"^\s*(import\s+bench\b(?!_)|from\s+bench\b(?!_))", re.M)


def test_port_renders_a_frame_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", FRAME], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout
    assert "PIL blocked: True" in res.stdout, res.stdout


def test_no_jax_import_in_port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "chip_ab.py"),
             os.path.join(ROOT, "bench_torch.py"),
             os.path.join(ROOT, "tests", "torch_raster_cases.py"),
             os.path.join(ROOT, "tests", "torch_occlusion_cases.py"),
             os.path.join(ROOT, "tests", "test_torch_kernels.py"),
             os.path.join(ROOT, "tests", "test_torch_sync.py")]
    for d, dirs, files in os.walk(os.path.join(ROOT, "renderer_tpu_torch")):
        dirs[:] = [x for x in dirs if x != "_build"]  # build outputs, not sources
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    assert IMPORT.search("from renderer_tpu.ops import raster_ref")
    assert not IMPORT.search("from renderer_tpu_torch.ops import raster_cuda")
    assert BENCH_IMPORT.search("import bench") and BENCH_IMPORT.search("from bench import x")
    assert not BENCH_IMPORT.search("import bench_torch")
    for p in paths:
        with open(p) as f:
            src = f.read()
        assert not IMPORT.search(src), p
        assert not BENCH_IMPORT.search(src), p
