"""The port runs without jax and without the JAX package: the port package,
chip_smoke.py and chip_ab.py import neither, directly or indirectly (the machine with
the card has no jax installed, and the port stands alone)."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FRAME = """
import sys
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
import chip_ab, chip_smoke, torch_raster_cases  # noqa: F401
import renderer_tpu_torch.ops.probe_cuda  # noqa: F401
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "renderer_tpu"))
print("JAX_MODULES", loaded)
"""

# import statements that name jax or the JAX package (renderer_tpu, not
# renderer_tpu_torch)
IMPORT = re.compile(r"^\s*(import\s+(jax|renderer_tpu)\b(?!_)|from\s+(jax|renderer_tpu)\b(?!_))", re.M)


def test_port_renders_a_frame_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", FRAME], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout


def test_no_jax_import_in_port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "chip_ab.py"),
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
    for p in paths:
        with open(p) as f:
            assert not IMPORT.search(f.read()), p
