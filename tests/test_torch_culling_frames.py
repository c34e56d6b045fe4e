"""The culling switches' frames: three-frame Renderer runs of each switch
against the JAX Renderer (the Pallas raster in interpret mode).

Gates, with their reasons:
- the visible (instance, library triangle) equal on >= 99.9% of pixels
  (compared by identity, as in test_torch_pipeline.py) and
  display-clamped PSNR >= 50 dB against the JAX Renderer's last frame;
- soup.count equal to the JAX package's cull of the same frame, run op
  by op. The JAX Renderer's jitted frame may cull a few borderline
  triangles differently (fused multiply-adds in its triangle tests: 583
  against 580 at one sponza pose, with no switch on), so its count is
  not the gate;
- the debug view's PSNR over the pixels whose visible triangle agrees
  (the identity gate bounds the others): its colours reach 5600 before
  the display clamp, against a 0.05 background, so one pixel that the
  two float32 rasterizers cover differently costs 42.7 dB at 256x64.
  That happens at the last pose: a pixel on the edge of the ground's flat
  box, a triangle reaching behind the eye, whose edge value is 0.53 in
  float64 (as JAX covers it) and -2.0 in the port's float32 (terms near
  1e7).

The occlusion run starts with the switch on at frame 1, where both
packages cull against the all-far depth under the identity viewproj
(instances at world z > 1 go: a fault shared by both, ROADMAP queue 3);
frame 3 culls against frame 2's depth. The freeze run freezes at frame 1 and renders frames 2 and
3 from behind the frozen view, turned by 180 degrees, so that frozen
triangles face away, straddle w = 0 or lie behind the camera. The
occlusion run is in test_torch_occlusion.py, which calls this file's
``check_switch_frames``.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.ops import geometry as jgeo, occlusion as jocc
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from test_torch_culling import BACK, cam_args, scenes
from test_torch_pipeline import visible_identity

OPTS = dict(tri_capacity=4096, aa="edge", enable_normal_maps=True, trilinear=False)


# name -> (scene, width, height, config changes, switches, camera (position, rotation) per
# frame, the frame from which the switches are on)
RUNS = {
    "occlusion": ("city", 256, 128, {}, dict(occlusion_culling=True),
                  [((0.0, 2.0, 10.0), None)] * 2 + [((0.1, 2.05, 10.1), None)], 0),
    "freeze": ("sponza", 256, 64, {}, dict(freeze_culling=True),
               [((4.0, 6.0, 18.0), None), ((4.0, 6.0, -6.0), BACK), ((3.0, 5.0, -8.0), BACK)], 1),
    "debug_aabbs": ("sponza", 256, 64, {}, dict(debug_aabbs=True),
                    [((4.0, 6.0, 18.0), None), ((3.5, 6.0, 17.0), None),
                     ((3.0, 6.0, 16.0), None)], 0),
    "cluster_cull": ("sponza", 256, 64, dict(cluster_cull=True), {},
                     [((4.0, 6.0, 18.0), None), ((3.5, 6.0, 17.0), None),
                      ((3.0, 6.0, 16.0), None)], 0),
}


def run_frames(renderer, make_cam, cams, switches, on_from):
    """Render the frames, the switches taken up at once before frame
    ``on_from``; returns every frame's outputs."""
    outs = []
    for k, (pos, rot) in enumerate(cams):
        if k == on_from and switches:
            renderer.set_config(**switches)
            renderer.apply_config_now()
        outs.append(renderer.render(make_cam(pos, rot)))
    return outs


def jax_count(name, jscene, cams, make_cam, prev_depth, cfg):
    """The final frame's soup.count by the JAX package's passes run op by
    op: the cull of the frame (of frame 1 under freeze), with the
    occlusion refinement against ``prev_depth`` (frame 2) or the cluster
    cull; 12 triangles per visible instance under debug_aabbs."""
    with jax.disable_jit():
        p = jgeo.prepare_frame_columns(jscene, make_cam(*cams[0 if name == "freeze" else -1]))
        visible = p[3]
        if name == "debug_aabbs":
            return min(12 * int(visible.sum()), cfg.tri_capacity)
        if name == "occlusion":
            prev = jgeo.prepare_frame_columns(jscene, make_cam(*cams[-2]))
            visible = jocc.occlusion_cull(jscene, p[0], prev[1], visible, prev_depth)
        soup, _ = jgeo.build_draw_stream(
            jscene, visible, p[4], p[2], p[0], cfg.expand_capacity, cfg.tri_capacity,
            cfg.width, cfg.height, camera_pos=p[8] if cfg.cluster_cull else None, vp=p[1])
    return int(soup.count)


def jax_camera(w, h):
    cam = cam_args(w, h)

    def make(p, r):
        return JaxCamera.create(jnp.asarray(p), None if r is None else jnp.asarray(r, jnp.float32),
                                **cam)

    return make


@functools.lru_cache(maxsize=None)
def switch_frames(name):
    """Every frame's outputs of the run ``name``: (the port's, the JAX
    Renderer's, the JAX config)."""
    which, w, h, changes, switches, cams, on_from = RUNS[name]
    jscene, scene = scenes(which)
    cam = cam_args(w, h)
    outputs = ("image", "vis", "soup")
    got = run_frames(Renderer(scene, PipelineConfig(width=w, height=h, **OPTS, **changes),
                              outputs=outputs),
                     lambda p, r: Camera.create(p, r, **cam, device="cpu"), cams, switches, on_from)
    jcfg = JaxConfig(width=w, height=h, shading="pbr", use_pallas=True, pallas_interpret=True,
                     **OPTS, **changes)
    want = run_frames(JaxRenderer(jscene, jcfg, outputs=outputs), jax_camera(w, h), cams,
                      switches, on_from)
    return got, want, jcfg


def check_switch_frames(name):
    which, w, h, changes, switches, cams, on_from = RUNS[name]
    jscene, scene = scenes(which)
    cam = cam_args(w, h)
    jax_cam = jax_camera(w, h)
    got, want, jcfg = switch_frames(name)
    g, wt = got[-1], want[-1]
    got_id, want_id = g["vis"].tri_id.numpy(), np.asarray(wt["vis"].tri_id)
    assert 0.05 < (got_id >= 0).mean()
    assert int(g["soup"].count) == jax_count(name, jscene, cams, jax_cam, want[-2]["vis"].depth,
                                             jcfg)
    same = visible_identity(g, got_id) == visible_identity(wt, want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    img = g["image"].numpy()
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    img, want_img = np.clip(img, 0, 1), np.clip(np.asarray(wt["image"]), 0, 1)
    if name == "debug_aabbs":  # PSNR where the visible triangle agrees: see the docstring
        img, want_img = img[same], want_img[same]
    assert psnr(img, want_img) >= 50.0
    counts = [int(o["soup"].count) for o in got]
    if name == "occlusion":  # frame 3 culls against frame 2's depth
        plain = Renderer(scene, PipelineConfig(width=w, height=h, **OPTS), outputs=("soup",))
        full = int(plain.render(Camera.create(cams[-1][0], **cam, device="cpu"))["soup"].count)
        assert counts[-1] < full
    if name == "freeze":  # the frozen list: frame 1's count, any camera
        assert counts[1] == counts[2] == counts[0]
    if name == "debug_aabbs":  # 12 boxes' triangles per visible instance, unsorted
        assert counts[-1] % 12 == 0 and (got_id == want_id).mean() >= 0.999


@pytest.mark.parametrize("name", ["cluster_cull", "debug_aabbs", "freeze"])
def test_switch_frames_match_jax_renderer(name):
    check_switch_frames(name)
