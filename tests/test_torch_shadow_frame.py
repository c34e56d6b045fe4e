"""The shadowed frame end to end: the port's Renderer with the ``shadows``
switch on the CPU against the JAX Renderer with ``set_config(shadows=True)``
(Pallas rasterizer in interpret mode, 128x128 atlas slots on both sides),
at the exact shade rate and at checkerboard+fix, same scene and camera,
edge AA, normal maps, bilinear filtering.

Gates, as in test_torch_rt_frame.py: the visible triangle equal on >=
99.9% of pixels (by (instance, library triangle)), display-clamped PSNR >=
40 dB, and the shadowed frame darker than the unshadowed one by > 0.05 on
> 20 pixels of the sponza frame (> 0.02 on the textured scene, whose
shadow light is dim). The sponza camera looks down on the floor: at 128x128
a slot's texel spans ~1.5 scene units, so from the rt test's camera
few of the small casters' shadows show. The JAX frames run in their own
file, so that the test workers spread them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from test_torch_pipeline import visible_identity
from test_torch_rt_frame import FRAMES, OPTS

RATES = {"exact": dict(shade_rate="full"), "checkerboard_fix": dict(shade_rate="checkerboard")}
# name -> (camera position, pitch in radians)
CAMERAS = {"textured_128x64": ([0.0, 1.2, 4.0], 0.0), "sponza64_256x64": ([6.0, 12.0, 14.0], -0.7)}


@pytest.mark.parametrize("rate", sorted(RATES))
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_shadowed_frame_matches_jax_renderer(name, rate):
    port_scene, jax_scene, _, w, h, drop = FRAMES[name]
    pos, pitch = CAMERAS[name]
    cam = dict(rotation=[math.cos(pitch / 2), math.sin(pitch / 2), 0.0, 0.0], fov_y=0.9,
               near=0.1, far=60.0, aspect=w / h)
    opts = dict(OPTS, shadow_size=128, **RATES[rate])
    outputs = ("image", "vis", "soup")
    r = Renderer(port_scene(), PipelineConfig(width=w, height=h, **opts), outputs=outputs)
    tcam = Camera.create(pos, **cam, device="cpu")
    lit = r.render(tcam)["image"].numpy()
    r.set_config(shadows=True)
    r.apply_config_now()
    got = r.render(tcam)
    jr = JaxRenderer(jax_scene(), JaxConfig(width=w, height=h, shading="pbr", use_pallas=True,
                                            pallas_interpret=True, **opts), outputs=outputs)
    jr.set_config(shadows=True)
    jr.apply_config_now()
    want = jr.render(JaxCamera.create(jnp.asarray(pos), **{k: jnp.asarray(v) for k, v in cam.items()}))
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
