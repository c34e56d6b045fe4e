"""Occlusion culling and the city scene (renderer_tpu_torch/ops/occlusion.py,
mathx/transforms.py, models/scenes.py) against the JAX package's, on the
same inputs made from a seed.

Gates, with their reasons:
- subdivided_box and city_scene's tables equal to the JAX package's, bit
  for bit (the same numpy code and random stream);
- transform_aabb within 1 ulp-scale (rtol 1e-6, atol 1e-6) of JAX's
  einsum: the same products, summed in XLA's order;
- build_depth_pyramid exact (a max of the same values);
- occlusion_cull's mask exactly equal to JAX's on a depth the port
  rendered, with the JAX function run op by op on the same matrices: the
  level pick's log2 may differ by an ulp between the two frameworks, and a
  differing instance would be reported, not tolerated. One case puts a
  box that fills the view in front of the camera, so that its bbox is
  wider than the top level's 4x4 window (the too-big guard).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from renderer_tpu.mathx import transforms as jtransforms
from renderer_tpu.models.scenes import city_scene as jax_city
from renderer_tpu.ops import occlusion as jocc
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits
from renderer_tpu.scene import primitives as jprim
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu_torch.mathx import Camera, transform_aabb
from renderer_tpu_torch.models import city_scene
from renderer_tpu_torch.ops import geometry as tgeo, occlusion as tocc
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneLimits, primitives, scene_from_numpy
from test_torch_culling import scenes
from test_torch_culling_frames import OPTS, RUNS, check_switch_frames, switch_frames
from test_torch_pipeline import visible_identity
from test_torch_scene import assert_scenes_equal

W, H = 256, 128  # the pyramid's 6 levels need H, W % 64 == 0; W > 192 for the too-big guard
CAM = dict(fov_y=0.9, near=0.1, far=400.0, aspect=W / H)


def test_transform_aabb_matches_jax():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(2, 5, 4, 4)).astype(np.float32)
    mn = rng.normal(size=(2, 5, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.1, 2.0, size=(2, 5, 3)).astype(np.float32)
    got = transform_aabb(*(torch.from_numpy(a) for a in (m, mn, mx)))
    want = jtransforms.transform_aabb(*(jnp.asarray(a) for a in (m, mn, mx)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("segments,height", [(3, 1.0), (12, 3.0)])
def test_subdivided_box_equals_jax(segments, height):
    got = primitives.subdivided_box(segments=segments, height=height)
    want = jprim.subdivided_box(segments=segments, height=height)
    for f in ("positions", "normals", "uvs", "tangents", "indices"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_city_scene_equals_jax():
    got = city_scene(3, device="cpu")
    want = scene_from_numpy(as_numpy_scene(jax_city(3)), device="cpu")
    assert_scenes_equal(got, want)
    assert int(got.instances.count) == 10 and got.meshes.cluster_data is not None


def test_depth_pyramid_is_exact():
    d = np.random.default_rng(1).uniform(0, 1, (H, W)).astype(np.float32)
    got = tocc.build_depth_pyramid(torch.from_numpy(d), 6)
    want = jocc.build_depth_pyramid(jnp.asarray(d), 6)
    assert got[-1].shape == (H // 64, W // 64)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _wall_scene():
    """A box that fills a street camera's view (the too-big case) with two
    small boxes behind it."""
    b = JaxBuilder(JaxLimits.tiny())
    box = b.add_mesh(jprim.box())
    m = b.add_material()
    b.add_instance(box, m, translation=(0.0, 2.0, 6.0), scale=6.0)
    b.add_instance(box, m, translation=(0.0, 2.0, -4.0), scale=0.5)
    b.add_instance(box, m, translation=(30.0, 2.0, -40.0), scale=0.5)
    b.add_light(position=(2, 3, 4), intensity=20.0)
    return b.build()


# name -> (JAX scene, previous camera position, current camera position)
CASES = {
    # a street camera a metre from a building's face, which fills its view:
    # a 2x2 (4x4 at the top level) texel window must lie within the
    # occluder, and at 256x128 the top level's window is the whole image
    "city_face": (lambda: jax_city(3), [0.0, 2.0, 10.0], [0.0, 2.0, 10.0]),
    "city_face_moved": (lambda: jax_city(3), [0.0, 2.0, 10.0], [0.3, 2.1, 10.2]),
    "wall": (_wall_scene, [0.0, 2.0, 11.0], [0.2, 2.0, 11.0]),
}


@functools.lru_cache(maxsize=None)
def rendered(name):
    """(port scene, JAX scene, previous prepare, its depth, current prepare)."""
    build, prev_pos, pos = CASES[name]
    jscene = build()
    scene = scene_from_numpy(as_numpy_scene(jscene), device="cpu")
    cfg = PipelineConfig(width=W, height=H, tri_capacity=32768)
    prev_cam = Camera.create(prev_pos, **CAM, device="cpu")
    depth = Renderer(scene, cfg).render(prev_cam)["vis"].depth
    return (scene, jscene, tgeo.prepare_frame_columns(scene, prev_cam), depth,
            tgeo.prepare_frame_columns(scene, Camera.create(pos, **CAM, device="cpu")))


@pytest.mark.parametrize("name", sorted(CASES))
def test_occlusion_cull_mask_equals_jax(name):
    scene, jscene, prev, depth, cur = rendered(name)
    got = tocc.occlusion_cull(scene, cur.model, prev.vp, cur.visible, depth)
    want = np.asarray(jocc.occlusion_cull(
        jscene, jnp.asarray(cur.model.numpy()), jnp.asarray(prev.vp.numpy()),
        jnp.asarray(cur.visible.numpy()), jnp.asarray(depth.numpy())))
    differ = np.flatnonzero(got.numpy() != want)
    assert differ.size == 0, f"instances {differ.tolist()} differ from JAX"
    culled = cur.visible.numpy() & ~want
    assert culled.sum() >= 2, "the case culls almost nothing"
    if name == "wall":
        # the wall's projected bbox spans the image: wider than 3 top texels
        corners = np.stack(np.meshgrid(*([[-0.5, 0.5]] * 3), indexing="ij"), -1).reshape(8, 3)
        world = corners * 6.0 + np.float32([0.0, 2.0, 6.0])
        clip = np.c_[world, np.ones(8)] @ prev.vp.numpy().T
        px = (clip[:, 0] / clip[:, 3] + 1.0) * 0.5 * W
        assert (clip[:, 3] > 0).all() and np.ptp(np.clip(px, 0, W - 1)) > 3 * 64
        assert want[0] and culled[1]  # the wall stays, the box behind it goes


def test_occlusion_cull_at_the_jax_initial_state_equals_jax():
    """The JAX package's frame-1 inputs (identity viewproj, all-far depth):
    the port's function answers as JAX's does."""
    scene, jscene, _, _, cur = rendered("city_face")
    eye, far = np.eye(4, dtype=np.float32), np.ones((H, W), np.float32)
    got = tocc.occlusion_cull(scene, cur.model, torch.from_numpy(eye), cur.visible,
                              torch.from_numpy(far))
    want = jocc.occlusion_cull(jscene, jnp.asarray(cur.model.numpy()), jnp.asarray(eye),
                               jnp.asarray(cur.visible.numpy()), jnp.asarray(far))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_first_occluded_frames_match_jax_renderer():
    """Frames 1 and 2 of occlusion culling at the city_face camera, from the
    identity viewproj and the all-far depth as in the JAX package, against
    the JAX Renderer's (test_torch_culling_frames.py's occlusion run):
    equal soup counts, and the visible (instance, library triangle) equal on
    >= 99.9% of pixels. Both start from the same state; at this camera the
    identity culls nothing the frustum keeps (from (0, 2, 20) it culls two
    buildings at world z > 1, ROADMAP queue 3)."""
    assert RUNS["occlusion"][5][:2] == [(tuple(CASES["city_face"][2]), None)] * 2
    got, want, jcfg = switch_frames("occlusion")
    jscene, scene = scenes("city")
    start = Renderer(scene, PipelineConfig(width=W, height=H, **OPTS)).state
    jstart = JaxRenderer(jscene, jcfg).state
    for name in ("prev_vp", "vis"):
        for a, b in zip(jax.tree_util.tree_leaves(jstart[name]),
                        start[name] if name == "vis" else [start[name]]):
            assert np.array_equal(b.numpy(), np.asarray(a)), name
    for k in range(2):
        g, wt = got[k], want[k]
        assert int(g["soup"].count) == int(wt["soup"].count), f"frame {k + 1}"
        got_id, want_id = g["vis"].tri_id.numpy(), np.asarray(wt["vis"].tri_id)
        same = visible_identity(g, got_id) == visible_identity(wt, want_id)
        assert same.mean() >= 0.999, f"frame {k + 1}: differs on {(~same).sum()} pixels"


def test_occlusion_frames_match_jax_renderer():
    """Occlusion culling from frame 1 on the city, three frames against the
    JAX Renderer (test_torch_culling_frames.py)."""
    check_switch_frames("occlusion")
