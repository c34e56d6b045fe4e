"""The checkerboard shade rate: the port's reconstruction and interleave
against the JAX package's, the port's checkerboard frame against its own
exact frame, and the fix's choice of pixels against the JAX package's.

Gates, with their reasons:
- reconstruction, score and interleave within 1e-6 of JAX on seeded
  inputs (the same expressions; sums of three channels in other orders);
- the shaded lattice, and every pixel the fix re-shades, within 1e-6 of
  the port's exact frame (aa none): the same closure shades both, but the
  CPU's vectorised and scalar-tail code may round a transcendental
  function differently by a sample's position (on the card the two are
  equal bit for bit, chip_smoke.py);
- the pixels the fix changes (fix on against fix off) are the same set as
  the JAX package's on >= 99.9% of pixels. Equal scores may be ordered
  differently by exact top-k and XLA's, so the test also asserts that
  fewer suspects than the capacity K score above FIX_TAU: then the set is
  {score > FIX_TAU} whatever the order.
"""

import dataclasses

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
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import textured_scene
from renderer_tpu_torch.ops import pbr as tpbr
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneLimits

W, H = 128, 64
POS = [0.0, 1.2, 4.0]
CAM = dict(fov_y=0.9, near=0.1, far=60.0, aspect=W / H)
CFG = PipelineConfig(width=W, height=H, tri_capacity=4096, aa="none", enable_normal_maps=True,
                     trilinear=False, shadow_size=128)


@pytest.mark.parametrize("y0", [0, 1])
def test_expand_and_interleave_match_jax(y0):
    rng = np.random.default_rng(3 + y0)
    h, w2 = 32, 48
    shaded = rng.uniform(0, 2, (3, h, w2)).astype(np.float32)
    # blocky triangle ids with slivers and holes
    tri_full = rng.integers(0, 5, (h // 4, w2 // 4)).repeat(4, 0).repeat(8, 1).astype(np.int32)
    tri_full[rng.random(tri_full.shape) < 0.1] = -1
    tri_full[rng.random(tri_full.shape) < 0.05] = 7
    rowpar = ((np.arange(h) + y0) & 1)[:, None]
    tri_s = np.where(rowpar == 0, tri_full[:, 0::2], tri_full[:, 1::2])
    bg = np.float32([0.05, 0.05, 0.08])[:, None, None]
    want = jpbr._checkerboard_expand(jnp.asarray(shaded), jnp.asarray(tri_full),
                                     jnp.asarray(tri_s), jnp.asarray(tri_s >= 0),
                                     jnp.asarray(rowpar.astype(np.int32)), jnp.asarray(bg))
    got = tpbr._checkerboard_expand(torch.from_numpy(shaded), torch.from_numpy(tri_full),
                                    torch.from_numpy(tri_s), torch.from_numpy(tri_s >= 0),
                                    torch.from_numpy(rowpar), torch.from_numpy(bg))
    for name, g, wnt in zip(("recon", "score", "tri_u"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-6, atol=1e-6, err_msg=name)
    score = got[1].numpy()
    assert (score == 1e9).any() and (score == -1.0).any() and ((score > 0) & (score < 1e9)).any()
    np.testing.assert_allclose(
        tpbr._cb_interleave(torch.from_numpy(shaded), got[0], torch.from_numpy(rowpar)).numpy(),
        np.asarray(jpbr._cb_interleave(jnp.asarray(shaded), want[0],
                                       jnp.asarray(rowpar.astype(np.int32)))),
        rtol=1e-6, atol=1e-6)


def port_frames(shadows: bool):
    """The port's exact, checkerboard and checkerboard+fix images, and the
    fix's scores (captured on its way in)."""
    scene = textured_scene(SceneLimits.tiny(), 32, device="cpu")
    cam = Camera.create(POS, **CAM, device="cpu")
    images, scores = {}, []
    fix = tpbr._checkerboard_fix

    def recording_fix(color, score, *args):
        scores.append(score)
        return fix(color, score, *args)

    for name, kw in (("exact", {}), ("cb", dict(shade_rate="checkerboard", shade_fix=False)),
                     ("cb_fix", dict(shade_rate="checkerboard"))):
        r = Renderer(scene, dataclasses.replace(CFG, **kw))
        r.set_config(shadows=shadows)
        r.apply_config_now()
        tpbr._checkerboard_fix = recording_fix
        try:
            images[name] = r.render(cam)["image"].numpy()
        finally:
            tpbr._checkerboard_fix = fix
    return images, scores[0].numpy()


@pytest.mark.parametrize("shadows", [False, True])
def test_checkerboard_frame_matches_exact_where_shaded(shadows):
    images, score = port_frames(shadows)
    exact, cb, cb_fix = images["exact"], images["cb"], images["cb_fix"]
    yy, xx = np.mgrid[0:H, 0:W]
    lattice = (xx + yy) % 2 == 0
    np.testing.assert_allclose(cb[lattice], exact[lattice], rtol=0, atol=1e-6)
    np.testing.assert_allclose(cb_fix[lattice], exact[lattice], rtol=0, atol=1e-6)
    changed = (cb_fix != cb).any(axis=-1)
    assert not changed[lattice].any() and changed.sum() > 20
    np.testing.assert_allclose(cb_fix[changed], exact[changed], rtol=0, atol=1e-6)
    assert np.abs(cb - exact).max() > 0  # rebuilt pixels are not shaded
    assert (score > tpbr.FIX_TAU).sum() < tpbr.fix_capacity(score.size)


def test_fix_reshades_the_pixels_jax_reshades():
    """The JAX package's shading closure run op by op on its own frame's
    visibility buffer and records (Pallas raster in interpret mode), fix on
    and fix off, against the port's frames."""
    jcfg = JaxConfig(width=W, height=H, tri_capacity=4096, shading="pbr", use_pallas=True,
                     pallas_interpret=True, enable_normal_maps=True, trilinear=False)
    jscene = jax_textured(JaxLimits.tiny(), 32)
    jcam = JaxCamera.create(jnp.asarray(POS), **CAM)
    out = JaxRenderer(jscene, jcfg, outputs=("vis", "shade_rec", "prepared")).render(jcam)
    jscores = []
    fix = jpbr._checkerboard_fix

    def recording_fix(color, score, *args):
        jscores.append(np.asarray(score))
        return fix(color, score, *args)

    def jax_cb(shade_fix):
        return np.asarray(jpbr.shade_pbr(
            out["vis"], out["shade_rec"], jscene, jcam.position, viewproj_inv=out["prepared"][7],
            enable_normal_maps=True, trilinear=False, bary_from_records=True,
            light_slots=int(jscene.lights.count), checkerboard=True, shade_fix=shade_fix))

    jpbr._checkerboard_fix = recording_fix
    try:
        want_changed = (jax_cb(True) != jax_cb(False)).any(axis=-1)
    finally:
        jpbr._checkerboard_fix = fix
    images, score = port_frames(False)
    got_changed = (images["cb_fix"] != images["cb"]).any(axis=-1)
    assert want_changed.sum() > 20
    assert (got_changed == want_changed).mean() >= 0.999, (got_changed != want_changed).sum()
    k = tpbr.fix_capacity(score.size)
    assert (score > tpbr.FIX_TAU).sum() < k and (jscores[0] > jpbr.FIX_TAU).sum() < k
