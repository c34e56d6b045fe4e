"""The frame's remaining tiers: the quarter shade rate with its fix, SSAA
with the resolve pass and Lambert shading, against the JAX package's.

Gates, with their reasons:
- _quarter_expand's frame and scores within 1e-6 of JAX's on seeded
  inputs (the same expressions; sums of three channels in other orders);
- the quarter frame's shaded (even x, even y) lattice, and every pixel the
  fix re-shades, within 1e-6 of the port's exact frame (aa none): the same
  closure shades them, but the CPU's vectorised and scalar-tail code may
  round a transcendental function differently by a sample's position (on
  the card they are equal bit for bit, chip_smoke.py);
- the pixels the quarter fix changes (fix on against fix off) the same set
  as the JAX package's on >= 99.9% of pixels, with fewer suspects above
  FIX_TAU than the capacity (then the set does not depend on how top-k
  orders equal scores);
- the SSAA 2 and Lambert frames against the JAX Renderer's (the Pallas
  raster in interpret mode): the visible (instance, library triangle)
  equal on >= 99.9% of pixels and display-clamped PSNR >= 50 dB.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models import textured_scene as jax_textured
from renderer_tpu.ops import pbr as jpbr
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.scene import SceneLimits as JaxLimits
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import textured_scene
from renderer_tpu_torch.ops import pbr as tpbr
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneLimits
from test_torch_pipeline import visible_identity

W, H = 128, 64
POS = [0.0, 1.2, 4.0]
CAM = dict(fov_y=0.9, near=0.1, far=60.0, aspect=W / H)
OPTS = dict(width=W, height=H, tri_capacity=4096, enable_normal_maps=True, trilinear=False)


@functools.lru_cache(maxsize=None)
def scenes():
    return jax_textured(JaxLimits.tiny(), 32), textured_scene(SceneLimits.tiny(), 32, device="cpu")


def test_config_takes_the_tiers():
    assert PipelineConfig(shade_rate="quarter").shade_rate == "quarter"
    assert PipelineConfig(ssaa=2, width=128, height=64).render_size == (256, 128)
    for bad in (dict(shading="lambert", aa="edge"), dict(shading="lambert", shade_rate="quarter"),
                dict(shading="phong"), dict(ssaa=0)):
        with pytest.raises(ValueError):
            PipelineConfig(**bad)


def test_quarter_expand_matches_jax():
    rng = np.random.default_rng(5)
    h, w = 32, 48
    tri_full = rng.integers(0, 5, (h // 4, w // 8)).repeat(4, 0).repeat(8, 1).astype(np.int32)
    tri_full[rng.random(tri_full.shape) < 0.1] = -1
    tri_full[rng.random(tri_full.shape) < 0.05] = 7
    tri_s = tri_full[0::2, 0::2]
    shaded = rng.uniform(0, 2, (3, h // 2, w // 2)).astype(np.float32)
    bg = np.float32([0.05, 0.05, 0.08])[:, None, None]
    want = jpbr._quarter_expand(jnp.asarray(shaded), jnp.asarray(tri_full), jnp.asarray(tri_s),
                                jnp.asarray(tri_s >= 0), jnp.asarray(bg))
    got = tpbr._quarter_expand(torch.from_numpy(shaded), torch.from_numpy(tri_full),
                               torch.from_numpy(tri_s), torch.from_numpy(tri_s >= 0),
                               torch.from_numpy(bg))
    for name, g, wnt in zip(("frame", "scores"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-6, atol=1e-6, err_msg=name)
    scores = got[1].numpy()
    assert (scores == 1e9).any() and (scores == -1.0).any() and ((scores > 0) & (scores < 1e9)).any()
    assert np.array_equal(got[0].numpy()[:, 0::2, 0::2], shaded)


@functools.lru_cache(maxsize=None)
def quarter_frames():
    """The port's exact, quarter and quarter+fix images (aa none)."""
    _, scene = scenes()
    cam = Camera.create(POS, **CAM, device="cpu")
    return {name: Renderer(scene, PipelineConfig(**OPTS, **kw)).render(cam)["image"].numpy()
            for name, kw in (("exact", {}), ("q", dict(shade_rate="quarter", shade_fix=False)),
                             ("q_fix", dict(shade_rate="quarter")))}


def test_quarter_frame_matches_exact_where_shaded():
    images = quarter_frames()
    exact, q, q_fix = images["exact"], images["q"], images["q_fix"]
    yy, xx = np.mgrid[0:H, 0:W]
    lattice = (xx % 2 == 0) & (yy % 2 == 0)
    np.testing.assert_allclose(q[lattice], exact[lattice], rtol=0, atol=1e-6)
    np.testing.assert_allclose(q_fix[lattice], exact[lattice], rtol=0, atol=1e-6)
    changed = (q_fix != q).any(axis=-1)
    assert not changed[lattice].any() and changed.sum() > 20
    np.testing.assert_allclose(q_fix[changed], exact[changed], rtol=0, atol=1e-6)
    assert np.abs(q - exact).max() > 0


def test_quarter_fix_reshades_the_pixels_jax_reshades():
    """The JAX package's shading closure run op by op on its own frame's
    visibility buffer and records, fix on and fix off, against the port's
    frames; the scores both fixes rank are captured on their way in."""
    jscene, _ = scenes()
    jcfg = JaxConfig(**OPTS, shading="pbr", use_pallas=True, pallas_interpret=True)
    jcam = JaxCamera.create(jnp.asarray(POS), **CAM)
    out = JaxRenderer(jscene, jcfg, outputs=("vis", "shade_rec", "prepared")).render(jcam)
    scores = []

    def jax_q(shade_fix):
        return np.asarray(jpbr.shade_pbr(
            out["vis"], out["shade_rec"], jscene, jcam.position, viewproj_inv=out["prepared"][7],
            enable_normal_maps=True, trilinear=False, bary_from_records=True,
            light_slots=int(jscene.lights.count), quarter=True, shade_fix=shade_fix))

    fix = jpbr._quarter_fix

    def recording_fix(color, s, *args):
        scores.append(np.asarray(s))
        return fix(color, s, *args)

    jpbr._quarter_fix = recording_fix
    try:
        want_changed = (jax_q(True) != jax_q(False)).any(axis=-1)
    finally:
        jpbr._quarter_fix = fix
    images = quarter_frames()
    got_changed = (images["q_fix"] != images["q"]).any(axis=-1)
    assert want_changed.sum() > 20
    assert (got_changed == want_changed).mean() >= 0.999, (got_changed != want_changed).sum()
    k = tpbr.quarter_fix_capacity(W * H)
    assert (scores[0] > jpbr.FIX_TAU).sum() < k


@pytest.mark.parametrize("tier", ["ssaa2", "lambert"])
def test_tier_frame_matches_jax_renderer(tier):
    jscene, scene = scenes()
    kw = dict(ssaa=2, aa="edge") if tier == "ssaa2" else dict(shading="lambert")
    outputs = ("image", "vis", "soup")
    cam = Camera.create(POS, **CAM, device="cpu")
    g = Renderer(scene, PipelineConfig(**OPTS, **kw), outputs=outputs).render(cam)
    jcfg = JaxConfig(**OPTS, **{"shading": "pbr", **kw}, use_pallas=True, pallas_interpret=True)
    wt = JaxRenderer(jscene, jcfg, outputs=outputs).render(JaxCamera.create(jnp.asarray(POS), **CAM))
    got_id, want_id = g["vis"].tri_id.numpy(), np.asarray(wt["vis"].tri_id)
    rw, rh = (2 * W, 2 * H) if tier == "ssaa2" else (W, H)
    assert got_id.shape == (rh, rw) and (got_id >= 0).mean() > 0.3
    same = visible_identity(g, got_id) == visible_identity(wt, want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    img = g["image"].numpy()
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 1), np.clip(np.asarray(wt["image"]), 0, 1)) >= 50.0
    if tier == "lambert":  # the Lambert frame is not the PBR one
        pbr = Renderer(scene, PipelineConfig(**OPTS)).render(cam)["image"].numpy()
        assert np.abs(pbr - img).max() > 0.05
