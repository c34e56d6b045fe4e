"""Skinning and the per-corner draw stream (renderer_tpu_torch/ops/skin.py,
geometry.expand_cull_sort_two_phase, the pose pass) against the JAX
package's, on the same scenes and times.

Gates, with their reasons:
- the skinned scene's tables equal to the JAX builder's, bit for bit;
- sample_clips (LINEAR, STEP, CUBICSPLINE, and a clip picked by
  set_active_clip) and pose_scene's positions and normals within 1e-5 of
  JAX's: the same expressions, the 4x4 products summed in another order;
- the two-phase soup against JAX's, run op by op on each package's posed
  scene: equal counts and triangle ids, clip and corner attributes within
  1e-5; its shade records within 1e-5 of each column's largest magnitude
  or of 1 (the corner attributes' gate; the edge columns are differences
  of products of pixel-scale coordinates); the per-corner caster
  stream's clip within 1e-5;
- the skinned frame against the JAX Renderer's (the Pallas raster in
  interpret mode) at three times, without and with shadows: the visible
  (instance, library triangle) equal on >= 99.9% of pixels and
  display-clamped PSNR >= 40 dB (the shadowed gate of PERF.md). The frame
  is 128x64, not 64x64: the JAX Pallas raster needs width % 128 == 0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.models.scenes import skinned_scene as jax_skinned
from renderer_tpu.ops import geometry as jgeo, skin as jskin
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits
from renderer_tpu.scene.builder import HostMesh as JaxHostMesh
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.models import skinned_scene
from renderer_tpu_torch.ops import geometry as tgeo, skin as tskin
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import HostMesh, SceneBuilder, SceneLimits, scene_from_numpy
from test_torch_pipeline import visible_identity
from test_torch_scene import assert_scenes_equal

W, H = 128, 64
POS = [0.0, 1.2, 4.0]
CAM = dict(fov_y=0.9, near=0.1, far=50.0, aspect=W / H)
TIMES = (0.0, 0.3, 0.65)
OPTS = dict(width=W, height=H, tri_capacity=1024, skinning=True, aa="edge", shadow_size=128,
            trilinear=False)


@functools.lru_cache(maxsize=None)
def scenes():
    """(JAX skinned scene, the port's, built by the port's builder)."""
    return jax_skinned(), skinned_scene(device="cpu")


def test_skinned_scene_equals_jax():
    jscene, scene = scenes()
    assert_scenes_equal(scene, scene_from_numpy(as_numpy_scene(jscene), device="cpu"))
    assert int(scene.skins.count) == 1 and scene.meshes.tri_rec is not None


def _clip_builders(mode):
    """A one-joint skinned triangle with a second clip in ``mode`` (random
    keys from a seed), built by both packages."""
    rng = np.random.default_rng(7)
    times = np.array([0.0, 0.4, 1.0], np.float32)
    vals = rng.normal(size=(3, 1, 3)).astype(np.float32)
    rot = rng.normal(size=(3, 1, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    scl = rng.uniform(0.5, 1.5, size=(3, 1)).astype(np.float32)
    kw = {}
    if mode == "CUBICSPLINE":  # (in, out) tangent pairs shaped like the keys
        kw = {name: tuple(rng.normal(size=shape).astype(np.float32) for _ in range(2))
              for name, shape in (("key_t_tangents", (3, 1, 3)), ("key_r_tangents", (3, 1, 4)),
                                  ("key_s_tangents", (3, 1)))}
    out = []
    for builder, mesh_cls, limits in ((JaxBuilder, JaxHostMesh, JaxLimits),
                                      (SceneBuilder, HostMesh, SceneLimits)):
        b = builder(limits.tiny())
        mesh = mesh_cls(positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                        indices=np.array([[0, 1, 2]], np.int32))
        mid = b.add_skinned_mesh(
            mesh, joints=np.zeros((3, 4), np.int32),
            weights=np.array([[1, 0, 0, 0]] * 3, np.float32), parents=np.array([-1], np.int32),
            inverse_bind=np.eye(4, dtype=np.float32)[None], key_times=times[[0, 2]],
            key_t=np.zeros((2, 1, 3), np.float32),
            key_r=np.tile(np.array([1, 0, 0, 0], np.float32), (2, 1, 1)))
        ci = b.add_skin_clip(mid, times, vals, rot, scl, interpolation=mode, **kw)
        b.add_instance(mid, b.add_material())
        b.add_light(position=(1, 2, 3), intensity=5.0)
        out.append((b, ci))
    return out


@pytest.mark.parametrize("mode", ["LINEAR", "STEP", "CUBICSPLINE"])
def test_sample_clips_matches_jax(mode):
    (jb, jci), (tb, tci) = _clip_builders(mode)
    jscene = jskin.set_active_clip(jb.build(), 0, jci)
    scene = tskin.set_active_clip(tb.build(device="cpu"), 0, tci)
    assert int(scene.skins.active_clip[0]) == tci == 1
    for t in (0.1, 0.4, 0.55, 0.93, 1.37):
        got = tskin.sample_clips(scene.skins, torch.tensor(t)).numpy()
        want = np.asarray(jskin.sample_clips(jscene.skins, t))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"t={t}")
    # the first clip (the rest keys) stays selectable
    rest = tskin.sample_clips(tskin.set_active_clip(scene, 0, 0).skins, torch.tensor(0.3))
    np.testing.assert_allclose(rest[0, 0].numpy(), np.eye(4), atol=1e-6)


@pytest.mark.parametrize("t", TIMES)
def test_pose_scene_matches_jax(t):
    jscene, scene = scenes()
    got = tskin.pose_scene(scene, torch.tensor(t)).meshes
    want = jskin.pose_scene(jscene, t).meshes
    assert got.tri_rec is None and got.cluster_data is None
    for f in ("positions", "normals"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    assert (got.positions - scene.meshes.positions).abs().max() > 0.05  # the arm is bent


@pytest.mark.parametrize("t", TIMES[1:])
def test_two_phase_soup_matches_jax(t):
    jscene, scene = scenes()
    posed = tskin.pose_scene(scene, torch.tensor(t))
    cam = Camera.create(POS, **CAM, device="cpu")
    prep = tgeo.prepare_frame_columns(posed, cam)
    soup, rec = tgeo.build_draw_stream(posed, prep, 2048, 1024, W, H)
    with jax.disable_jit():
        jposed = jskin.pose_scene(jscene, t)
        p = jgeo.prepare_frame_columns(jposed, JaxCamera.create(jnp.asarray(POS), **CAM))
        jsoup = jgeo.expand_cull_sort_two_phase(jposed, p[3], p[4], p[2], p[0], 2048, 1024, W, H)
    n = int(jsoup.count)
    assert int(soup.count) == n > 100
    for f in ("instance", "tri_idx"):
        assert np.array_equal(getattr(soup, f)[:n].numpy(), np.asarray(getattr(jsoup, f))[:n]), f
    np.testing.assert_allclose(soup.clip[:n].numpy(), np.asarray(jsoup.clip)[:n], rtol=0,
                               atol=1e-5)
    for f in ("normal", "uv", "tangent", "tex_lod"):
        np.testing.assert_allclose(getattr(soup, f)[:n].numpy(), np.asarray(getattr(jsoup, f))[:n],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # the shade records of the per-corner soup, and its caster stream
    want_rec = np.asarray(jgeo.build_shade_records(jsoup, jposed, render_size=(W, H)))[:n]
    scale = np.maximum(np.abs(want_rec).max(axis=0), 1.0)
    assert (np.abs(rec[:n].numpy() - want_rec) <= 1e-5 * scale).all()
    clip, valid, count = tgeo.expand_clip_only(posed, prep.visible, prep.lod, prep.clip_mats, 2048)
    with jax.disable_jit():
        jclip, _, jcount = jgeo.expand_clip_only(jposed, p[3], p[4], p[2], 2048)
    assert int(count) == int(jcount)
    np.testing.assert_allclose(clip[: int(count)].numpy(), np.asarray(jclip)[: int(count)],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shadows", [False, True])
def test_skinned_frames_match_jax_renderer(shadows):
    jscene, scene = scenes()
    outputs = ("image", "vis", "soup")
    r = Renderer(scene, PipelineConfig(**OPTS), outputs=outputs)
    jr = JaxRenderer(jscene, JaxConfig(**OPTS, shading="pbr", use_pallas=True,
                                       pallas_interpret=True), outputs=outputs)
    for rr in (r, jr):
        rr.set_config(shadows=shadows)
        rr.apply_config_now()
    cam = Camera.create(POS, **CAM, device="cpu")
    jcam = JaxCamera.create(jnp.asarray(POS), **CAM)
    images = []
    for t in TIMES:
        g, wt = r.render(cam, time_s=t), jr.render(jcam, time_s=t)
        got_id, want_id = g["vis"].tri_id.numpy(), np.asarray(wt["vis"].tri_id)
        assert (got_id >= 0).mean() > 0.1
        same = visible_identity(g, got_id) == visible_identity(wt, want_id)
        assert same.mean() >= 0.999, f"t={t}: visible triangle differs on {(~same).sum()} pixels"
        img = g["image"].numpy()
        assert np.isfinite(img).all()
        assert psnr(np.clip(img, 0, 1), np.clip(np.asarray(wt["image"]), 0, 1)) >= 40.0
        images.append(img)
    assert np.abs(images[1] - images[0]).max() > 0.05, "the pose must change the frame"
