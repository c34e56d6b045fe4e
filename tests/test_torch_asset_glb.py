"""The committed asset (assets/colonnade.glb) through the port's glTF
loader: against the port's procedural twin (models.colonnade_scene), as
tests/test_asset_glb.py holds the JAX package's; against the JAX render of
it; and through the port's streamer.

Gates, with their reasons:
- the port's load of the asset equals the JAX loader's, every table bit
  for bit (rotations included), and the instances whose rotation moves
  by an ulp against the twin are the same in both packages: the JAX
  loader moves the same five by the same amounts against its own twin;
- the loaded scene's tables equal the twin's bit for bit (the same spec,
  one through the GLB container), but the instances' rotations, which
  the loader rebuilds from the node's matrix, within one float32 ulp
  (1.2e-7; five central ornaments); its frame against the twin's: tri_id
  equal, the image within 1e-6 (test_asset_glb's gate) on every pixel of
  an instance whose rotation is bit-equal, and display-clamped PSNR >= 50
  dB over the frame. The ornaments' one-ulp rotation moves their
  shading by up to 6e-5 here; the JAX package's Pallas frame moves by
  3.2e-5 for it too (its XLA frame, which test_asset_glb renders, by 0);
- the port's frame of the loaded asset against the JAX Renderer's (its
  Pallas raster in interpret mode): the visible (instance, library
  triangle) equal on >= 99.9% of pixels, display-clamped PSNR >= 50 dB;
- streaming: the asset by path (parsed in the worker) and its meshes by
  callables, under the budget, every table equal to the JAX streamer's
  after every pump (cluster_data as in test_torch_streaming), and the
  streamed colonnade renders.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models.scenes import _colonnade_lights as jax_lights
from renderer_tpu.models.scenes import colonnade_scene as jax_twin
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.runtime.streaming import SceneStreamer as JaxStreamer
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits
from renderer_tpu.scene.gltf import load_gltf as jax_load
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import colonnade_scene
from renderer_tpu_torch.models.scenes import _colonnade_lights, colonnade_spec
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.runtime.streaming import SceneStreamer
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits
from renderer_tpu_torch.scene.gltf import load_gltf
from test_torch_gltf import assert_scene_tables_equal
from test_torch_pipeline import visible_identity
from test_torch_streaming import CLUSTER_ATOL, pump_both

ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "colonnade.glb")
W, H = 128, 128
POS = [0.0, 2.5, 12.0]
CAM = dict(fov_y=0.9, near=0.1, far=80.0)
OUTPUTS = ("image", "vis", "soup")


def render(scene):
    return Renderer(scene, PipelineConfig(width=W, height=H, tri_capacity=8192),
                    outputs=OUTPUTS).render(Camera.create(POS, device="cpu", **CAM))


@functools.lru_cache(maxsize=None)
def loaded():
    b = load_gltf(ASSET, SceneBuilder(SceneLimits()))
    _colonnade_lights(b)
    return b.build(device="cpu")


def test_glb_loads_as_the_jax_loader_loads_it():
    jb = jax_load(ASSET, JaxBuilder(JaxLimits()))
    jax_lights(jb)
    jax_scene = jb.build()
    port = loaded()
    assert_scene_tables_equal(port, jax_scene)
    # the node-matrix round trip: the same instances move, by the same
    # amounts, against each package's own twin
    port_twin = colonnade_scene(device="cpu")
    port_moved = port.instances.rotation.numpy() - port_twin.instances.rotation.numpy()
    jax_moved = np.asarray(jax_scene.instances.rotation) - np.asarray(jax_twin().instances.rotation)
    assert np.array_equal(port_moved, jax_moved)
    assert np.count_nonzero(port_moved.any(axis=1)) == 5
    assert np.abs(port_moved).max() <= 1.2e-7


def test_glb_equals_the_procedural_twin():
    twin = colonnade_scene(device="cpu")
    scene = loaded()
    for part in ("meshes", "instances", "materials", "lights", "atlas", "skins"):
        for f, a, b in zip(getattr(scene, part)._fields, getattr(scene, part), getattr(twin, part)):
            if a is None or b is None:
                assert a is None and b is None, (part, f)
            elif (part, f) == ("instances", "rotation"):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1.2e-7)
            else:
                assert np.array_equal(a.numpy(), b.numpy()), (part, f)
    a, b = render(scene), render(twin)
    tri = a["vis"].tri_id.numpy()
    assert (tri >= 0).mean() > 0.2 and np.array_equal(tri, b["vis"].tri_id.numpy())
    same_rot = (scene.instances.rotation == twin.instances.rotation).all(dim=1).numpy()
    exact = (tri < 0) | same_rot[a["soup"].instance.numpy()[np.maximum(tri, 0)]]
    assert exact.mean() > 0.95
    img_a, img_b = a["image"].numpy(), b["image"].numpy()
    np.testing.assert_allclose(img_a[exact], img_b[exact], rtol=0, atol=1e-6)
    assert psnr(np.clip(img_a, 0, 1), np.clip(img_b, 0, 1)) >= 50.0


def test_glb_renders_as_the_jax_package():
    jb = jax_load(ASSET, JaxBuilder(JaxLimits()))
    jax_lights(jb)
    jcfg = JaxConfig(width=W, height=H, tri_capacity=8192, shading="pbr", use_pallas=True,
                     pallas_interpret=True)
    want = JaxRenderer(jb.build(), jcfg, outputs=OUTPUTS).render(
        JaxCamera.create(position=jnp.asarray(POS), **CAM))
    got = render(loaded())
    got_id, want_id = got["vis"].tri_id.numpy(), np.asarray(want["vis"].tri_id)
    same = visible_identity(got, got_id) == visible_identity(want, want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    assert psnr(np.clip(got["image"].numpy(), 0, 1), np.clip(np.asarray(want["image"]), 0, 1)) >= 50


def test_glb_through_the_streamer():
    """Mesh 0 streams from the .glb path (parsed in the worker thread); the
    next 23 instances' meshes decode through callables over the file."""
    scenes = []
    for builder, limits, lights in ((SceneBuilder, SceneLimits, _colonnade_lights),
                                    (JaxBuilder, JaxLimits, jax_lights)):
        b = builder(limits())
        lights(b)
        scenes.append(b.build(device="cpu") if builder is SceneBuilder else b.build())
    port, jax = SceneStreamer(scenes[0], budget=8), JaxStreamer(scenes[1], budget=8)
    _, instances, _ = colonnade_spec()
    for s, load, builder, limits in ((port, load_gltf, SceneBuilder, SceneLimits),
                                     (jax, jax_load, JaxBuilder, JaxLimits)):
        s.request_mesh(ASSET, translation=(0.0, -1.0, 0.0))

        def mesh_from_disk(i, load=load, builder=builder, limits=limits):
            return lambda: load(ASSET, builder(limits()))._meshes[i]

        for mesh_idx, _mat, t, q, scale in instances[1:24]:
            s.request_mesh(mesh_from_disk(mesh_idx), translation=t, rotation=q, scale=scale)
    for _ in range(3):
        scene = pump_both(port, jax)
    assert port.stats["uploaded"] == 24 and port.stats["chunks"] == jax.stats["chunks"]
    assert_scene_tables_equal(scene, jax.scene, cluster_atol=CLUSTER_ATOL)
    out = render(scene)
    assert (out["vis"].tri_id >= 0).float().mean() > 0.05
    assert np.isfinite(out["image"].numpy()).all()
    port.close()
    jax.close()
