"""The HUD and the reference view (renderer_tpu_torch/ops/overlay.py,
runtime/hud.py, ops/raster_scan.py, ops/shadow.shadow_caster_truncation,
graph/dot.py, the overlay_pass and reference_view passes) against the JAX
package's.

Gates, with their reasons:
- the font atlas and the overlay tables equal, bit for bit (the same
  numpy code);
- compose_overlay within 1e-6 of JAX's on a seeded image with a rect,
  overlapping glyphs and glyphs off the screen: the same blends, in the
  same order wherever glyphs overlap;
- the independent scan rasterizer equal to JAX's on a seeded soup (ids
  exact, depth and barycentrics within 1e-6), and no shared code with
  kernel 1's path;
- format_hud's switch, pass, shadow-caster and cluster lines equal to
  JAX's for the same switches (the JAX prepare and truncation run op by
  op);
- the reference-view and HUD frames against the JAX Renderer's (the
  Pallas raster in interpret mode): display-clamped PSNR >= 50 dB.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models import textured_scene as jax_textured
from renderer_tpu.ops import geometry as jgeo, overlay as joverlay, raster_jax
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.runtime import hud as jhud
from renderer_tpu.scene import SceneLimits as JaxLimits
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.graph import dot
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import textured_scene
from renderer_tpu_torch.ops import geometry as tgeo, overlay as toverlay, raster_scan
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.runtime import hud as thud
from renderer_tpu_torch.scene import SceneLimits

W, H = 128, 64
POS = [0.0, 1.2, 4.0]
CAM = dict(fov_y=0.9, near=0.1, far=60.0, aspect=W / H)
OPTS = dict(width=W, height=H, tri_capacity=4096, enable_normal_maps=True, trilinear=False,
            shadow_size=128)


@functools.lru_cache(maxsize=None)
def scenes():
    return jax_textured(JaxLimits.tiny(), 32), textured_scene(SceneLimits.tiny(), 32, device="cpu")


def _overlays(builder_cls):
    b = builder_cls()
    b.rect(2, 3, 70, 30, color=(0.1, 0.2, 0.3), alpha=0.5)
    b.rect(20, 10, 40, 50, color=(0.9, 0.1, 0.1), alpha=0.3)
    b.text(4, 4, "HUD 12.5 ms\nfps: 80", color=(1.0, 0.9, 0.2))
    b.text(6, 7, "OVERLAP?", color=(0.2, 1.0, 0.4), alpha=0.7)  # on top of the first text
    b.text(7, 8, "%%##", alpha=0.5)
    b.text(W - 8, 4, "EDGE", color=(0.5, 0.5, 1.0))  # runs off the right edge
    b.text(-3, 40, "LEFT")  # starts off the left edge
    return b.build()


def test_font_atlas_and_tables_equal_jax():
    assert np.array_equal(toverlay.build_font_atlas(), joverlay.build_font_atlas())
    got, want = _overlays(toverlay.OverlayBuilder), _overlays(joverlay.OverlayBuilder)
    for f in toverlay.Overlay._fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    text = "line one\nTWO: 2"
    for f, a in toverlay.hud_overlay(text, W)._asdict().items():
        assert np.array_equal(np.asarray(a), np.asarray(getattr(joverlay.hud_overlay(text, W), f)))


def test_compose_overlay_matches_jax():
    img = np.random.default_rng(2).uniform(0, 1.5, (H, W, 3)).astype(np.float32)
    font = toverlay.build_font_atlas()
    got = toverlay.compose_overlay(torch.from_numpy(img), _overlays(toverlay.OverlayBuilder),
                                   torch.from_numpy(font)).numpy()
    want = np.asarray(joverlay.compose_overlay(jnp.asarray(img), _overlays(joverlay.OverlayBuilder),
                                               jnp.asarray(font)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    layers = toverlay.glyph_layers(_overlays(toverlay.OverlayBuilder), W, H)
    assert len(layers) >= 3  # the overlapping texts really overlap
    assert np.abs(got - img).max() > 0.5


def test_scan_rasterizer_matches_jax():
    """The independent path against the JAX scan rasterizer on a seeded
    soup of large triangles, some crossing w = 0, some back-facing."""
    rng = np.random.default_rng(4)
    t = 256
    clip = rng.normal(0, 1.0, (t, 3, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(-0.2, 2.0, (t, 3)).astype(np.float32)
    clip[..., 2] = clip[..., 3] * rng.uniform(0.0, 1.0, (t, 3)).astype(np.float32)
    valid = rng.random(t) < 0.9
    for cull in (True, False):
        got = raster_scan.rasterize_scan(torch.from_numpy(clip), torch.from_numpy(valid), 48, 40,
                                         cull_backface=cull)
        want = raster_jax.rasterize(jnp.asarray(clip), jnp.asarray(valid), 48, 40,
                                    cull_backface=cull, strip_rows=8)
        assert np.array_equal(got.tri_id.numpy(), np.asarray(want.tri_id))
        assert (got.tri_id.numpy() >= 0).mean() > 0.5
        for f in ("depth", "bary"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    src = open(raster_scan.__file__).read()
    assert "raster_tiles_plain" not in src and "setup_tri_data" not in src


@pytest.mark.parametrize("switches", [dict(shadows=True), dict(occlusion_culling=True, hud=True),
                                      dict(reference_image=True, rt=True)])
def test_format_hud_lines_match_jax(switches):
    jscene, scene = scenes()
    opts = dict(OPTS, shadow_tri_capacity=128, cluster_cull=True)
    r = Renderer(scene, PipelineConfig(**opts))
    jr = JaxRenderer(jscene, JaxConfig(**opts, shading="pbr", use_pallas=True,
                                       pallas_interpret=True))
    for rr in (r, jr):
        rr.set_config(**switches)
        rr.apply_config_now()
    prep = tgeo.prepare_frame_columns(scene, Camera.create(POS, **CAM, device="cpu"))
    with jax.disable_jit():
        jprep = jgeo.prepare_frame_columns(jscene, JaxCamera.create(jnp.asarray(POS), **CAM))
        want = jhud.format_hud(jr, prepared=jprep, extra={"coverage": "50.0%"}).split("\n")
    got = thud.format_hud(r, prepared=prep, extra={"coverage": "50.0%"}).split("\n")
    keys = ("switches:", "active passes:", "shadow casters:", "cluster budget:", "coverage:")
    pick = {k: [line for line in got if line.startswith(k)] for k in keys}
    assert pick == {k: [line for line in want if line.startswith(k)] for k in keys}
    assert len(pick["switches:"]) == len(pick["active passes:"]) == 1
    if switches.get("shadows"):
        assert pick["shadow casters:"] and "DROPPED" in pick["shadow casters:"][0]
        assert any(line.startswith("shadow atlas cache:") for line in got)
    text = dot.plan_to_dot(r.passes, vars(r.config))
    assert all(f'"{p.name}"' in text for p in r.passes) and text.startswith("digraph")


def test_validate_frame(tmp_path):
    thud.validate_frame({"image": torch.zeros(4, 4, 3), "n": (torch.ones(2),)})
    bad = torch.zeros(4, 4, 3)
    bad[1, 2, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="image"):
        thud.validate_frame({"image": bad}, dump_path=str(tmp_path / "crash.npz"))
    assert (tmp_path / "crash.npz").exists()


@pytest.mark.parametrize("switch", ["reference_image", "hud"])
def test_switch_frame_matches_jax_renderer(switch):
    jscene, scene = scenes()
    text = "=== HUD ===\nframe 1  12.5 ms\nswitches: hud=on"
    r = Renderer(scene, PipelineConfig(**OPTS, aa="edge"))
    jr = JaxRenderer(jscene, JaxConfig(**OPTS, aa="edge", shading="pbr", use_pallas=True,
                                       pallas_interpret=True))
    for rr in (r, jr):
        rr.set_config(**{switch: True})
        rr.apply_config_now()
    img = r.render(Camera.create(POS, **CAM, device="cpu"),
                   overlay=toverlay.hud_overlay(text, W))["image"].numpy()
    want = np.asarray(jr.render(JaxCamera.create(jnp.asarray(POS), **CAM),
                                overlay=joverlay.hud_overlay(text, W))["image"])
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 1), np.clip(want, 0, 1)) >= 50.0
    plain = Renderer(scene, PipelineConfig(**OPTS, aa="edge")).render(
        Camera.create(POS, **CAM, device="cpu"))["image"].numpy()
    if switch == "hud":  # the panel darkens the top left; the text lights it
        assert np.abs(img - plain)[4:30, 4:60].max() > 0.3
