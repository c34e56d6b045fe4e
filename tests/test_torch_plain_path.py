"""The plain configuration (``PipelineConfig(tile_raster=False)``, the JAX
package's default ``use_pallas=False``) against the JAX package's.

Gates, with their reasons:
- the plain cull's functions against JAX's, run op by op on the same
  scene and a camera made from a seed: camera_clip_matrices,
  instance_matrices within 1e-6 (products summed in other orders);
  select_lod, the expansion's owners, library triangles, valid mask and
  count, and the culled mask equal; the clip corners of the ``tri_rec``
  branch bit for bit (the same column expressions), of the per-corner
  branch and the world normals and tangents within 1e-6; the shade
  records without edge columns within 1e-6 and zero past column 40;
- the plain Renderer's frame against the JAX package's default Renderer
  for each switch set (cases of one test): the visible (instance, library
  triangle) equal on >= 99.9% of pixels and display-clamped PSNR >= 50 dB
  (>= 40 dB under shadows and rt, with a sun ten times as bright, so that
  its shadows show: a pixel whose visible triangle flips at an edge, or a
  receiver at a shadow's edge, differs by up to its full contrast);
- the plain frame against the port's tile frame, the gate of the JAX
  package's tests/test_pipeline.py:117 (the two rasterizers pick other
  winners on depth-tied edge pixels): error < 0.02 on > 95% of pixels,
  mean error < 0.005, brightness within 0.01.
"""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models import textured_scene as jax_textured
from renderer_tpu.ops import cull as jcull, geometry as jgeo, overlay as joverlay
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.scene import SceneLimits as JaxLimits
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import textured_scene
from renderer_tpu_torch.ops import geometry as tgeo, overlay as toverlay
from renderer_tpu_torch.ops.cull import compact_soup
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneLimits
from test_torch_pipeline import visible_identity

W, H = 128, 64
CAP = 8192  # the plain cull expands at tri_capacity: room for every triangle
OPTS = dict(width=W, height=H, tri_capacity=CAP, shadow_size=128)
HUD_TEXT = "=== HUD ===\nframe 2  9.5 ms\nswitches: hud=on"


SUN = 1  # the textured scene's directional light, in shadow slot 0
# ten times the scene's, for the shadowed cases: their shadows then show in
# the frame (at the scene's own 0.35 they change 4 pixels of the 8192)
SUN_INTENSITY = 3.5


@functools.lru_cache(maxsize=None)
def scenes(sun: float = None):
    """(JAX scene, port scene): the textured scene, its sun at ``sun``."""
    jscene = jax_textured(JaxLimits.tiny(), 32)
    scene = textured_scene(SceneLimits.tiny(), 32, device="cpu")
    if sun is not None:
        scene.lights.intensity[SUN] = sun
        jscene = jscene._replace(lights=jscene.lights._replace(
            intensity=jscene.lights.intensity.at[SUN].set(sun)))
    return jscene, scene


def seeded_pose(seed: int):
    """An orbit position around the textured scene, from a numpy seed."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.6, 0.6)
    r, h = rng.uniform(3.5, 4.5), rng.uniform(0.8, 1.6)
    return [float(r * math.sin(a)), float(h), float(r * math.cos(a))]


def cameras(pos):
    cam = dict(fov_y=0.9, near=0.1, far=60.0, aspect=W / H)
    return Camera.create(pos, **cam, device="cpu"), JaxCamera.create(jnp.asarray(pos), **cam)


def np_(x):
    return np.array(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("per_corner", [False, True])
def test_plain_cull_matches_jax(per_corner):
    jscene, scene = scenes()
    if per_corner:  # the posed-scene branch: corners from the vertex pool
        jscene = jscene._replace(meshes=jscene.meshes._replace(tri_rec=None))
        scene = scene._replace(meshes=scene.meshes._replace(tri_rec=None))
    cam, jcam = cameras(seeded_pose(7))
    model, jmodel = tgeo.instance_matrices(scene), jgeo.instance_matrices(jscene)
    np.testing.assert_allclose(np_(model), np_(jmodel), rtol=1e-6, atol=1e-6)
    vp, clip_mats = tgeo.camera_clip_matrices(cam, model)
    jvp, jclip_mats = jgeo.camera_clip_matrices(jcam, jmodel)
    np.testing.assert_allclose(np_(vp), np_(jvp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(clip_mats), np_(jclip_mats), rtol=1e-6, atol=1e-6)
    visible = tgeo.coarse_cull(scene, model, vp)
    jvisible = jgeo.coarse_cull(jscene, jmodel, jvp)
    lod, jlod = tgeo.select_lod(scene, cam, model), jgeo.select_lod(jscene, jcam, jmodel)
    assert np.array_equal(np_(visible), np_(jvisible)) and np.array_equal(np_(lod), np_(jlod))
    # both expand the JAX inputs, so the comparison is of the expansion alone
    soup = tgeo.expand_draw_stream(scene, torch.from_numpy(np_(jvisible)),
                                   torch.from_numpy(np_(jlod)).long(),
                                   torch.from_numpy(np_(jclip_mats)),
                                   torch.from_numpy(np_(jmodel)), CAP)
    jsoup = jgeo.expand_draw_stream(jscene, jvisible, jlod, jclip_mats, jmodel, CAP)
    for f in ("instance", "tri_idx", "valid", "count"):
        assert np.array_equal(np_(getattr(soup, f)), np_(getattr(jsoup, f))), f
    assert 2000 < int(soup.count) < CAP
    if per_corner:
        np.testing.assert_allclose(np_(soup.clip), np_(jsoup.clip), rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(np_(soup.clip), np_(jsoup.clip))
    for f in ("normal", "uv", "tangent"):
        np.testing.assert_allclose(np_(getattr(soup, f)), np_(getattr(jsoup, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    for backface in (True, False):
        got = tgeo.cull_triangles(soup, cull_backface=backface).valid
        want = jgeo.cull_triangles(jsoup, cull_backface=backface).valid
        assert np.array_equal(np_(got), np_(want)), backface
    culled = compact_soup(tgeo.cull_triangles(soup))
    jculled = jcull.compact_soup(jgeo.cull_triangles(jsoup))
    assert 0 < int(culled.count) == int(jculled.count) < int(soup.count)
    culled = tgeo.finalize_tex_lod(culled, W, H, scene.atlas.level_size[0])
    jculled = jgeo.finalize_tex_lod(jculled, W, H, jscene.atlas.level_size[0])
    rec = np_(tgeo.build_shade_records(culled, scene))
    jrec = np_(jgeo.build_shade_records(jculled, jscene))
    np.testing.assert_allclose(rec, jrec, rtol=1e-6, atol=1e-6)
    assert not rec[:, tgeo.SR_EDGE:].any()
    # the setup pieces JAX's cull is made of
    adj, det, zw = tgeo.triangle_setup(soup.clip, W, H)
    jadj, jdet, jzw = jgeo.triangle_setup(jsoup.clip, W, H)
    for g, w_ in ((adj, jadj), (det, jdet), (zw, jzw)):
        np.testing.assert_allclose(np_(g), np_(w_), rtol=1e-6, atol=1e-3)
    for g, w_ in zip(tgeo.ndc_bounds(soup.clip), jgeo.ndc_bounds(jsoup.clip)):
        np.testing.assert_allclose(np_(g), np_(w_), rtol=1e-6, atol=1e-6)


# switch set -> (PipelineConfig changes, runtime switches, frames before the compared one)
CASES = {
    "none": ({}, {}, 0),
    "shadows": ({}, dict(shadows=True), 0),
    "rt": ({}, dict(rt=True), 0),
    "freeze_culling": ({}, dict(freeze_culling=True), 1),
    "occlusion_culling": ({}, dict(occlusion_culling=True), 1),
    "debug_aabbs": ({}, dict(debug_aabbs=True), 0),
    "hud": ({}, dict(hud=True), 0),
    "checkerboard_fix": (dict(shade_rate="checkerboard"), {}, 0),
    "quarter_fix": (dict(shade_rate="quarter"), {}, 0),
    "ssaa2": (dict(ssaa=2), {}, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_frame_matches_jax_default_renderer(case):
    """Frames before the compared one render culled at another pose; the
    switches go on just before the compared frame (so a frozen frame
    renders the draw list of the pose before)."""
    cfg_kw, switches, before = CASES[case]
    shadowed = case in ("shadows", "rt")
    jscene, scene = scenes(SUN_INTENSITY if shadowed else None)
    outputs = ("image", "vis", "soup")
    r = Renderer(scene, PipelineConfig(**OPTS, tile_raster=False, **cfg_kw), outputs=outputs)
    jr = JaxRenderer(jscene, JaxConfig(**OPTS, **cfg_kw), outputs=outputs)
    assert not jr.cfg.use_pallas
    poses = [seeded_pose(12 - before + k) for k in range(before + 1)]
    for k, pos in enumerate(poses):
        if k == before:
            for rr in (r, jr):
                rr.set_config(**switches)
                rr.apply_config_now()
        cam, jcam = cameras(pos)
        got = r.render(cam, overlay=toverlay.hud_overlay(HUD_TEXT, W))
        want = jr.render(jcam, overlay=joverlay.hud_overlay(HUD_TEXT, W))
    got_id, want_id = got["vis"].tri_id.numpy(), np.asarray(want["vis"].tri_id)
    assert got_id.shape == (H * r.cfg.ssaa, W * r.cfg.ssaa)
    assert 0.2 < (got_id >= 0).mean() < 1.0
    same = visible_identity(got, got_id) == visible_identity(want, want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    img, jimg = got["image"].numpy(), np.asarray(want["image"])
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 1), np.clip(jimg, 0, 1)) >= (40.0 if shadowed else 50.0)
    if shadowed:  # the sun's shadows are in the frame
        unshadowed = Renderer(scene, PipelineConfig(**OPTS, tile_raster=False)).render(cam)
        assert (np.abs(unshadowed["image"].numpy() - img).max(axis=-1) > 0.05).mean() > 0.01


def test_plain_frame_matches_tile_frame():
    _, scene = scenes()
    cam, _ = cameras([0.0, 1.2, 4.0])
    cfg = PipelineConfig(width=W, height=H, tri_capacity=4096)
    img_tile = Renderer(scene, cfg).render(cam)["image"].numpy()
    img_plain = Renderer(scene, dataclasses.replace(cfg, tile_raster=False)).render(cam)["image"]
    img_plain = img_plain.numpy()
    assert img_plain.mean() > 0.05
    err = np.abs(img_tile - img_plain)
    assert (err < 0.02).mean() > 0.95, (err.max(), err.mean())
    assert err.mean() < 0.005, err.mean()
    assert abs(img_tile.mean() - img_plain.mean()) < 0.01


def test_plain_config_checks_what_jax_checks():
    # no tile divisibility: the JAX plain configuration's sizes
    cfg = PipelineConfig(width=100, height=50, tri_capacity=384, shadow_size=96,
                         tile_raster=False)
    assert cfg.tri_capacity == 384
    with pytest.raises(ValueError):
        PipelineConfig(width=100, height=50)  # the tile raster's tiles
    for bad in (dict(tri_capacity=200), dict(width=99, shade_rate="checkerboard"),
                dict(height=49, shade_rate="quarter"),
                dict(shadow_progressive=3, shadow_update_budget=1)):
        with pytest.raises(ValueError):
            PipelineConfig(**{**dict(width=100, height=50, tile_raster=False), **bad})
    scene = textured_scene(SceneLimits.tiny(), 32, device="cpu")
    cam = Camera.create([0.0, 1.2, 4.0], fov_y=0.9, aspect=2.0, device="cpu")
    img = Renderer(scene, cfg).render(cam)["image"]
    assert img.shape == (50, 100, 3) and torch.isfinite(img).all()
    # cluster culling has no effect here, as in the JAX package (only the
    # tile configuration's build_draw_stream reads it)
    clustered = Renderer(scene, dataclasses.replace(cfg, cluster_cull=True)).render(cam)["image"]
    assert torch.equal(clustered, img)


def test_demo_scan_raster_takes_the_plain_configuration(tmp_path, monkeypatch):
    from renderer_tpu_torch import demo, runtime
    from renderer_tpu_torch.utils.image import read_png

    made = []
    renderer_cls = runtime.Renderer

    def recording(scene, cfg, *args, **kw):
        made.append(cfg)
        return renderer_cls(scene, cfg, *args, **kw)

    monkeypatch.setattr(runtime, "Renderer", recording)
    out = str(tmp_path / "plain.png")
    demo.main(["--scene", "mixed", "--size", "64", "--out", out, "--device", "cpu",
               "--scan-raster", "--rt"])
    assert made and not made[0].tile_raster and read_png(out).std() > 2.0
    demo.main(["--scene", "mixed", "--size", "64", "--out", out, "--device", "cpu"])
    assert made[1].tile_raster  # kernel 1 stays the default
    # without --device the demo renders on the card: here, with no CUDA, it raises
    with pytest.raises((AssertionError, RuntimeError)):
        demo.main(["--scene", "mixed", "--size", "64", "--out", out, "--scan-raster"])
