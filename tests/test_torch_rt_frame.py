"""The rt frame end to end: the port's Renderer with the ``rt`` switch on
the CPU against the JAX Renderer with ``set_config(rt=True)``, the Pallas
rasterizer and occlusion kernel in interpret mode, same scene and camera,
edge AA, normal maps, bilinear filtering, rt_scale 2 (the default).

Gates: the visible triangle equal on >= 99.9% of pixels (compared by
(instance, library triangle), as in test_torch_pipeline.py), and
display-clamped PSNR >= 40 dB (one receiver flipped by rounding at
128x64 alone costs about 45 dB). The rt frame must be darker than the
rt-off frame by > 0.05 on > 20 pixels of the sponza frame; the textured
scene's shadow light has intensity 0.35, so its shadows are at most ~0.048
deep, and there the gate is > 0.02 on > 20 pixels.
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
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneLimits
from test_torch_pipeline import visible_identity

# name -> (port scene, JAX scene, camera position, width, height, darkness gate)
FRAMES = {
    "textured_128x64": (lambda: textured_scene(SceneLimits.tiny(), 32, device="cpu"),
                        lambda: jax_textured(JaxLimits.tiny(), 32), [0.0, 1.2, 4.0], 128, 64, 0.02),
    "sponza64_256x64": (lambda: sponza_like_scene(64, device="cpu"), lambda: jax_sponza(64),
                        [4.0, 6.0, 18.0], 256, 64, 0.05),
}
OPTS = dict(tri_capacity=4096, aa="edge", enable_normal_maps=True, trilinear=False)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_rt_frame_matches_jax_renderer(name):
    port_scene, jax_scene, pos, w, h, drop = FRAMES[name]
    cam = dict(fov_y=0.9, near=0.1, far=60.0, aspect=w / h)
    outputs = ("image", "vis", "soup")
    r = Renderer(port_scene(), PipelineConfig(width=w, height=h, **OPTS), outputs=outputs)
    tcam = Camera.create(pos, **cam, device="cpu")
    lit = r.render(tcam)["image"].numpy()
    r.set_config(rt=True)
    r.apply_config_now()
    got = r.render(tcam)
    jr = JaxRenderer(jax_scene(), JaxConfig(width=w, height=h, shading="pbr", use_pallas=True,
                                            pallas_interpret=True, **OPTS), outputs=outputs)
    jr.set_config(rt=True)
    jr.apply_config_now()
    want = jr.render(JaxCamera.create(jnp.asarray(pos), **cam))
    got_id = got["vis"].tri_id.numpy()
    want_id = np.asarray(want["vis"].tri_id)
    assert 0.2 < (got_id >= 0).mean() < 1.0
    same = visible_identity(got, got_id) == visible_identity(want, want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    img = got["image"].numpy()
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 1), np.clip(np.asarray(want["image"]), 0, 1)) >= 40.0
    darker = (lit - img).mean(axis=-1)
    assert (darker > drop).sum() > 20, f"{(darker > drop).sum()} pixels darker by > {drop}"
