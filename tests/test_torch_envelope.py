"""The reference's shadow envelope at test size: the port's Renderer on the
CPU against the JAX Renderer (Pallas in interpret mode). The port's
schedule alone is ``test_torch_envelope_schedule.py``.

The configuration is ``scripts/prof_shadow_amort.py``'s, cut to size: the
sponza64 256x64 frame of ``test_torch_rt_frame.FRAMES`` with a light table
of 16 directional lights (``models.shadow_envelope_lights``; the JAX side
builds it with that script's lines), 16 shadow slots of 128x128 in 2 bands
each, the cache at budget 1, two shaded lights, checkerboard+fix, edge AA.
The atlas renders every slot that holds a live light, shaded or not, as the
JAX atlas does.

Gates against JAX, at frames 1, 17 and 34 and after light 7 moves: the
units rendered equal on every frame; each slot's depth within 1e-5 on >=
99.9% of texels (``test_torch_shadow.py``'s gate); the visible triangle
equal on >= 99.9% of pixels; display-clamped PSNR >= 40 dB.
"""

import jax.numpy as jnp
import numpy as np

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models import sponza_like_scene as jax_sponza
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.scene import SceneLimits as JaxLimits
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.models import shadow_envelope_lights
from renderer_tpu_torch.ops.rt_grid import slot_lights
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from test_torch_envelope_schedule import (CAM, H, LIMITS, MOVED, N_LIGHTS, OPTS, POS, W,  # noqa: F401
                                          one_thread, port_camera, port_scene, rendered_units,
                                          with_light7)
from test_torch_pipeline import visible_identity

CHECK_FRAMES = (1, 17, 34)


def jax_scene():
    """prof_shadow_amort.py:37-58 at 64 instances."""
    scene = jax_sponza(64, limits=JaxLimits(**LIMITS))
    rng = np.random.default_rng(3)
    L = N_LIGHTS
    d = rng.normal(size=(L, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0] = np.asarray((-0.5, -1.0, -0.3), np.float32) / np.linalg.norm((-0.5, -1.0, -0.3))
    lights = scene.lights._replace(
        position=jnp.asarray(d),
        color=jnp.ones((L, 3), jnp.float32),
        intensity=jnp.full((L,), 1.2, jnp.float32),
        directional=jnp.ones((L,), bool),
        shadow_slot=jnp.arange(L, dtype=jnp.int32),
        alive=jnp.ones((L,), bool),
        count=jnp.int32(L),
    )
    return scene._replace(lights=lights)


def jax_with_light7(scene, direction):
    pos = scene.lights.position.at[7].set(jnp.asarray(direction, jnp.float32))
    return scene._replace(lights=scene.lights._replace(position=pos))


def test_envelope_lights_are_the_harness_table():
    port = shadow_envelope_lights(N_LIGHTS, device="cpu")
    jl = jax_scene().lights
    for field in port._fields:
        assert np.array_equal(getattr(port, field).numpy(), np.asarray(getattr(jl, field))), field


def test_envelope_matches_the_jax_renderer():
    r = Renderer(port_scene(), PipelineConfig(**OPTS), outputs=("image", "vis", "soup"))
    r.set_config(shadows=True)
    r.apply_config_now()
    assert slot_lights(r.atlas_casts, N_LIGHTS) == tuple((i, True) for i in range(N_LIGHTS))
    assert r.light_casts == ((0, True), (1, True))
    outputs = ("image", "vis", "soup")
    jr = JaxRenderer(jax_scene(), JaxConfig(shading="pbr", use_pallas=True, pallas_interpret=True,
                                            **OPTS), outputs=outputs)
    jr.set_config(shadows=True)
    jr.apply_config_now()
    tcam = port_camera()
    jcam = JaxCamera.create(jnp.asarray(POS), **{k: jnp.asarray(v) for k, v in CAM.items()})
    tscene, jscene = r.scene, jr.scene
    checks = {k: None for k in CHECK_FRAMES}
    checks["moved"] = (with_light7(tscene, MOVED), jax_with_light7(jscene, MOVED))
    for k in list(range(1, CHECK_FRAMES[-1] + 1)) + ["moved"]:
        ts, js = checks.get(k) or (None, None)
        t_prev = r.state["shadow_cache"][1].clone()
        j_prev = np.asarray(jr.state["shadow_cache"][1])
        got = r.render(tcam, scene=ts)
        want = jr.render(jcam, scene=js)
        tu = rendered_units(r.state["shadow_cache"][1], t_prev)
        ju = rendered_units(jr.state["shadow_cache"][1], j_prev)
        assert (tu == ju).all(), (k, np.argwhere(tu), np.argwhere(ju))
        assert int(r.state["shadow_cache"][2]) == int(jr.state["shadow_cache"][2]), k
        if k not in checks:
            continue
        t_atlas = r.state["shadow_cache"][0].numpy()
        j_atlas = np.asarray(jr.state["shadow_cache"][0])
        for slot in range(N_LIGHTS):
            close = np.abs(t_atlas[slot] - j_atlas[slot]) <= 1e-5
            assert close.mean() >= 0.999, f"frame {k} slot {slot}: {(~close).sum()} texels differ"
        got_id = got["vis"].tri_id.numpy()
        same = visible_identity(got, got_id) == visible_identity(want, np.asarray(want["vis"].tri_id))
        assert same.mean() >= 0.999, f"frame {k}: visible triangle differs on {(~same).sum()} pixels"
        img = got["image"].numpy()
        assert img.shape == (H, W, 3) and np.isfinite(img).all()
        db = psnr(np.clip(img, 0, 1), np.clip(np.asarray(want["image"]), 0, 1))
        assert db >= 40.0, f"frame {k}: PSNR {db:.1f} dB"
    # the whole schedule ran: every unit rendered, each slot holds depth
    assert not np.isnan(np.asarray(jr.state["shadow_cache"][1])).any()
    assert ((t_atlas < 1.0).mean(axis=(1, 2)) > 0.05).all()
