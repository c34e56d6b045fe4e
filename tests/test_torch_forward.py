"""``render_forward`` (renderer_tpu_torch/passes/forward.py) against the JAX
package's, and the cases of its tests/test_forward.py:111-170.

Gates, with their reasons:
- the frame of the JAX test scene from a seeded pose at 256x256, the JAX
  test's size (a pixel at an edge may flip: XLA fuses the jitted
  frame's multiply-adds, PERF.md §2): tri_id equal on
  >= 99.9% of pixels (the soup is not sorted, so its slots are the JAX
  package's) and display-clamped PSNR >= 50 dB;
- an empty scene: every pixel the background, within 1e-6;
- a plane under a directional light straight down: the centre pixel is
  albedo * (ambient + intensity) within 1e-4, the JAX test's bound;
- an instance behind the camera is culled and expands nothing.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.passes.forward import render_forward as jax_render_forward
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits
from renderer_tpu.scene import primitives as jprims
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera, quat_from_axis_angle
from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.ops.raster_spec import NO_TRIANGLE
from renderer_tpu_torch.passes.forward import render_forward
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives


def build(builder_cls, limits_cls, prims):
    """The JAX test's scene (a box and a rotated sphere, two lights)."""
    b = builder_cls(limits_cls.tiny())
    box = b.add_mesh(prims.box())
    sph = b.add_mesh(prims.uv_sphere(rings=10, sectors=14))
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1.0))
    blue = b.add_material(base_color=(0.2, 0.3, 0.9, 1.0))
    b.add_instance(box, red, translation=(-0.7, 0.0, 0.0))
    rot = quat_from_axis_angle((0.0, 1.0, 0.0), 0.8, device="cpu").numpy()
    b.add_instance(sph, blue, translation=(0.7, 0.0, 0.0), scale=1.2, rotation=rot)
    b.add_light(position=(2.0, 3.0, 4.0), intensity=20.0)
    b.add_light(position=(-1.0, -1.0, -0.5), directional=True, intensity=0.4)
    return b


def camera(pos=(0.0, 0.6, 3.0)):
    return Camera.create(pos, near=0.1, far=50.0, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_render_forward_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5)
    pos = (3.0 * math.sin(a), rng.uniform(0.2, 1.0), 3.0 * math.cos(a))
    rot = quat_from_axis_angle((0.0, 1.0, 0.0), a, device="cpu").numpy()
    img, vis = render_forward(build(SceneBuilder, SceneLimits, primitives).build(device="cpu"),
                              Camera.create(pos, rot, near=0.1, far=50.0, device="cpu"),
                              width=256, height=256, tri_capacity=1024)
    jimg, jvis = jax_render_forward(
        build(JaxBuilder, JaxLimits, jprims).build(),
        JaxCamera.create(position=jnp.asarray(pos), rotation=jnp.asarray(rot), near=0.1,
                         far=50.0), width=256, height=256, tri_capacity=1024)
    img = img.numpy()
    assert img.shape == (256, 256, 3) and np.isfinite(img).all()
    tri_id = vis.tri_id.numpy()
    assert 0.1 < (tri_id != NO_TRIANGLE).mean() < 0.9
    assert (tri_id == np.asarray(jvis.tri_id)).mean() >= 0.999
    assert psnr(np.clip(img, 0, 1), np.clip(np.asarray(jimg), 0, 1)) >= 50.0


def test_empty_scene_renders_background():
    scene = SceneBuilder(SceneLimits.tiny()).build(device="cpu")
    img, vis = render_forward(scene, camera(), width=64, height=64, tri_capacity=128)
    img = img.numpy()
    assert np.isfinite(img).all()
    assert (vis.tri_id == NO_TRIANGLE).all()
    np.testing.assert_allclose(img, np.broadcast_to([0.05, 0.05, 0.08], img.shape), atol=1e-6)


def test_analytic_directional_shading():
    """Plane facing +Y, directional light straight down: albedo * (ambient + I)."""
    b = SceneBuilder(SceneLimits.tiny())
    b.add_instance(b.add_mesh(primitives.plane(size=10.0)),
                   b.add_material(base_color=(0.5, 0.6, 0.7, 1.0)))
    b.add_light(position=(0.0, -1.0, 0.0), directional=True, intensity=0.5)
    rot = quat_from_axis_angle((1.0, 0.0, 0.0), -np.pi / 2, device="cpu").numpy()
    cam = Camera.create((0.0, 2.0, 0.0), rot, near=0.1, far=50.0, device="cpu")
    img, _ = render_forward(b.build(device="cpu"), cam, width=32, height=32, tri_capacity=128)
    np.testing.assert_allclose(img[16, 16].numpy(), np.array([0.5, 0.6, 0.7]) * (0.15 + 0.5),
                               atol=1e-4)


def test_instance_culling_reduces_work():
    """An instance behind the camera is coarse-culled and expands nothing."""
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    m = b.add_material()
    b.add_instance(box, m, translation=(0.0, 0.0, 0.0))
    b.add_instance(box, m, translation=(0.0, 0.0, 100.0))  # behind the camera
    scene = b.build(device="cpu")
    model = geometry.instance_matrices(scene)
    vp, clip_mats = geometry.camera_clip_matrices(camera(), model)
    visible = geometry.coarse_cull(scene, model, vp)
    assert bool(visible[0]) and not bool(visible[1])
    lod = geometry.select_lod(scene, camera(), model)
    soup = geometry.expand_draw_stream(scene, visible, lod, clip_mats, model, 128)
    assert int(soup.count) == 12  # only one box's triangles expanded
    assert torch.equal(soup.valid, torch.arange(128) < 12)
