"""The ported frame end to end: the port's Renderer on the CPU against the
JAX Renderer with the Pallas rasterizer in interpret mode, same scene and
camera, edge AA, normal maps, bilinear filtering.

Gates: the visible triangle equal on >= 99.9% of pixels, and
display-clamped PSNR >= 50 dB. The visible triangle is compared by its
(instance, library triangle) identity: tri_id numbers a slot of the sorted
soup, and XLA's fused arithmetic may round a Morton key across a cell
seam, which renumbers slots without changing what is drawn.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models import sponza_like_scene as jax_sponza, textured_scene as jax_textured
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.scene import SceneLimits as JaxLimits
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import sponza_like_scene, textured_scene
from renderer_tpu_torch.passes.pipeline import Pass, PipelineConfig, build_forward_plan, check_plan
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneLimits

# name -> (port scene, JAX scene, camera position, width, height)
FRAMES = {
    "textured_128x64": (lambda: textured_scene(SceneLimits.tiny(), 32, device="cpu"),
                        lambda: jax_textured(JaxLimits.tiny(), 32), [0.0, 1.2, 4.0], 128, 64),
    "sponza64_256x64": (lambda: sponza_like_scene(64, device="cpu"), lambda: jax_sponza(64),
                        [4.0, 6.0, 18.0], 256, 64),
}
OPTS = dict(tri_capacity=4096, aa="edge", enable_normal_maps=True, trilinear=False)


def visible_identity(out, tri_id):
    """(H, W) int64: instance * 2^32 + library triangle, -1 where empty."""
    inst = np.asarray(out["soup"].instance).astype(np.int64)
    tri = np.asarray(out["soup"].tri_idx).astype(np.int64)
    safe = np.maximum(tri_id, 0)
    return np.where(tri_id >= 0, (inst[safe] << 32) + tri[safe], -1)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_matches_jax_renderer(name):
    port_scene, jax_scene, pos, w, h = FRAMES[name]
    cam = dict(fov_y=0.9, near=0.1, far=60.0, aspect=w / h)
    outputs = ("image", "vis", "soup")
    got = Renderer(port_scene(), PipelineConfig(width=w, height=h, **OPTS),
                   outputs=outputs).render(Camera.create(pos, **cam, device="cpu"))
    jcfg = JaxConfig(width=w, height=h, shading="pbr", use_pallas=True,
                     pallas_interpret=True, **OPTS)
    want = JaxRenderer(jax_scene(), jcfg, outputs=outputs).render(
        JaxCamera.create(jnp.asarray(pos), **cam))
    got_id = got["vis"].tri_id.numpy()
    want_id = np.asarray(want["vis"].tri_id)
    assert 0.2 < (got_id >= 0).mean() < 1.0
    same = visible_identity(got, got_id) == visible_identity(want, want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    img = got["image"].numpy()
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 1), np.clip(np.asarray(want["image"]), 0, 1)) >= 50.0


def tiny_renderer(**kw):
    return Renderer(textured_scene(SceneLimits.tiny(), 32, device="cpu"),
                    PipelineConfig(width=128, height=64, tri_capacity=2048, **kw))


def cam():
    return Camera.create([0.0, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0, aspect=2.0,
                         device="cpu")


def test_plan_is_the_base_frame():
    plan = build_forward_plan(PipelineConfig(width=128, height=64), outputs=["image", "vis"])
    assert [p.name for p in plan] == ["pose", "prepare", "cull", "raster", "shade", "present"]


def test_plan_check_rejects_missing_producers():
    plan = build_forward_plan(PipelineConfig(width=128, height=64))
    with pytest.raises(ValueError, match="no earlier pass"):
        check_plan(plan[:2] + plan[3:], outputs=["image"])  # raster without cull
    with pytest.raises(ValueError, match="no pass"):
        check_plan(plan, outputs=["shadow_map"])
    r = tiny_renderer()
    r.passes[-1] = Pass("present", ("image_pre",), ("image",), lambda image_pre: {})
    with pytest.raises(RuntimeError, match="claims"):
        r.render(cam())


def test_frames_repeat_and_are_counted():
    r = tiny_renderer()
    first = r.render(cam())
    second = r.render(cam())
    assert np.array_equal(first["image"].numpy(), second["image"].numpy())
    assert np.array_equal(first["vis"].tri_id.numpy(), second["vis"].tri_id.numpy())
    assert (first["vis"].tri_id >= 0).any()
    assert r.stats["frames"] == 2 and r.stats["last_ms"] > 0


def test_light_slots_follow_the_scene():
    r = tiny_renderer()
    assert r.cfg.shade_light_slots == 2
    scene = r.scene
    more = scene._replace(lights=scene.lights._replace(count=scene.lights.count + 1))
    with pytest.raises(ValueError, match="live lights"):
        r.render(cam(), scene=more)
