"""The port's ray-traced shadow path (light cameras, caster expansion,
setup, binning, the occlusion walk's plain version, the upsample, the
per-slot planes, the rt plan and the device default) against the JAX
package's, at tiny sizes (tri_capacity <= 1024, grids <= 128x64).

Gates, with their reasons:
- light matrices, caster clip corners and scene bounds within rtol = atol
  = 1e-5 (float32 products summed in other orders); LODs, cull masks and
  valid masks equal;
- setup columns within rtol 1e-6 (same expressions, same order), ok equal;
- binning: the same ascending block set per tile as a numpy brute force;
- occlusion planes equal on >= 99.9% of live receivers against JAX
  ``occlusion_grid(interpret=True)`` (XLA may contract an FMA and flip a
  receiver within rounding of an edge) and equal to a float64 brute force
  wherever no caster's edge, w or depth margin is below 1e-5 relative.
  Background receivers (ld = +inf) are lit in the port; the JAX kernel
  tests those inside a walked 32x128 tile like live ones, so its answer
  there depends on its tiling and is not compared;
- the bilateral upsample within atol 1e-6; per-slot planes of
  ``rt_shadow_grid`` equal on >= 99.9% of covered pixels (at rt_scale 2 a
  covered pixel may take a background sample's value through the plain
  bilinear fallback, where the two packages differ as above).
The JAX functions run op by op (not jitted) unless stated.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.mathx import camera as jcam
from renderer_tpu.models import sponza_like_scene as jax_sponza
from renderer_tpu.ops import geometry as jgeo
from renderer_tpu.ops import rt_grid as jrt
from renderer_tpu.ops import shadow as jshadow
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits, primitives
from renderer_tpu.scene.types import as_numpy_scene
from renderer_tpu_torch.device import default_device
from renderer_tpu_torch.mathx import Camera, camera as tcam, orbit_camera, quat_from_axis_angle
from renderer_tpu_torch.models import textured_scene
from renderer_tpu_torch.ops import geometry as tgeo
from renderer_tpu_torch.ops import rt_grid as trt
from renderer_tpu_torch.ops import shadow as tshadow
from renderer_tpu_torch.ops.occlusion_cuda import O_BB, O_OK, occlusion_tiles_plain
from renderer_tpu_torch.ops.raster_cuda import BLOCK, TILE_H, TILE_W, rasterize_cuda
from renderer_tpu_torch.passes.pipeline import PipelineConfig, build_forward_plan
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, scene_from_numpy
from torch_occlusion_cases import CASES

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


def t(a):
    return torch.from_numpy(np.array(a))


def point_scene():
    """The point-light scene of tests/test_shadow.py (rt_grid_point_light)."""
    b = JaxBuilder(JaxLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)),
                   translation=(0.0, 1.0, 0.0), scale=0.6)
    b.add_light(position=(1.5, 4.0, 0.0), intensity=40.0, shadow_slot=0)
    return b.build()


def top_down(height):
    return dict(position=[0.0, height, 0.01],
                rotation=quat_from_axis_angle([1.0, 0.0, 0.0], -np.pi / 2, device=CPU).numpy(),
                fov_y=1.1, near=0.1, far=80.0)


# name -> (JAX scene, camera kwargs, width, height)
SCENES = {
    "sponza": (lambda: jax_sponza(64, area=24.0), top_down(20.0), 128, 64),
    "point": (point_scene, top_down(6.0), 128, 64),
}
_SETUPS = {}


def setup(name):
    """JAX scene and prepare, the port's scene, and the rt inputs of one
    frame made by the port at the CPU (world, normal, covered, tri)."""
    if name in _SETUPS:
        return _SETUPS[name]
    build, cam_kw, w, h = SCENES[name]
    jscene = build()
    tscene = scene_from_numpy(as_numpy_scene(jscene), device=CPU)
    cam_kw = dict(cam_kw, aspect=w / h)
    jprep = jgeo.prepare_frame_columns(
        jscene, jcam.Camera.create(**{k: jnp.asarray(v) for k, v in cam_kw.items()}))
    tprep = tgeo.prepare_frame_columns(tscene, Camera.create(**cam_kw, device=CPU))
    soup, rec = tgeo.build_draw_stream(tscene, tprep, 2048, 1024, w, h)
    vis = rasterize_cuda(soup.clip, soup.valid, w, h, with_bary=False)
    world = tgeo.unproject_depth(vis.depth, tprep.vp_inv, w, h)
    tri = vis.tri_id
    n = rec[tri.clamp(min=0).long(), 0:3].permute(2, 0, 1)  # corner-0 normal
    normal = n / torch.clamp(torch.sqrt((n * n).sum(0)), min=1e-8)
    _SETUPS[name] = (jscene, tscene, jprep, tprep, world, normal, tri >= 0, tri)
    return _SETUPS[name]


# --- light cameras, cull, expansion -----------------------------------------

def test_look_at_and_orthographic_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(4):
        eye, target = rng.uniform(-5, 5, 3).astype(np.float32), rng.uniform(-5, 5, 3).astype(np.float32)
        up = np.float32([0.0, 1.0, 0.0]) if rng.random() < 0.5 else rng.normal(size=3).astype(np.float32)
        np.testing.assert_allclose(tcam.look_at(t(eye), t(target), t(up)).numpy(),
                                   np.asarray(jcam.look_at(eye, target, up)), **TOL)
        hw, hh, near, far = rng.uniform(0.5, 30, 4).astype(np.float32)
        np.testing.assert_allclose(
            tcam.orthographic(t(hw), t(hh), t(near), t(near + far)).numpy(),
            np.asarray(jcam.orthographic(hw, hh, near, near + far)), **TOL)
    eyes = rng.uniform(-5, 5, (6, 3)).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    batched = tcam.look_at(t(eyes), t(eyes + dirs)).numpy()
    for k in range(6):
        np.testing.assert_allclose(batched[k], np.asarray(jcam.look_at(eyes[k], eyes[k] + dirs[k])),
                                   **TOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_light_matrices_lod_and_bounds_match_jax(name):
    jscene, tscene, jprep, tprep, *_ = setup(name)
    smin, smax = np.asarray(jprep[5]), np.asarray(jprep[6])
    np.testing.assert_allclose(tprep.scene_min.numpy(), smin, **TOL)
    np.testing.assert_allclose(tprep.scene_max.numpy(), smax, **TOL)
    want = np.asarray(jshadow.directional_light_matrices(jscene.lights, jprep[5], jprep[6]))
    got = tshadow.directional_light_matrices(tscene.lights, t(smin), t(smax)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # a point light with a shadow slot exercises the perspective branch
    lights = tscene.lights._replace(shadow_slot=torch.tensor([1, 0, -1, -1], dtype=torch.int32),
                                    alive=torch.tensor([True, True, False, False]))
    jlights = jscene.lights._replace(shadow_slot=jnp.asarray(lights.shadow_slot.numpy()),
                                     alive=jnp.asarray(lights.alive.numpy()))
    np.testing.assert_allclose(
        tshadow.directional_light_matrices(lights, t(smin), t(smax)).numpy(),
        np.asarray(jshadow.directional_light_matrices(jlights, jprep[5], jprep[6])), **TOL)
    for point in ([1.5, 4.0, 0.0], [30.0, 2.0, -20.0]):
        p = np.float32(point)
        want_lod = np.asarray(jshadow.lod_by_distance(jscene, jprep[0], jnp.asarray(p)))
        assert (tshadow.lod_by_distance(tscene, tprep.model, t(p)).numpy() == want_lod).all()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_coarse_cull_and_expand_clip_only_match_jax(name):
    jscene, tscene, jprep, tprep, *_ = setup(name)
    mats = np.asarray(jshadow.directional_light_matrices(jscene.lights, jprep[5], jprep[6]))
    for vp in (mats[0], np.asarray(jprep[1])):
        want = np.asarray(jgeo.coarse_cull(jscene, jprep[0], jnp.asarray(vp)))
        got = tgeo.coarse_cull(tscene, tprep.model, t(vp)).numpy()
        assert (got == want).all()
    assert (tgeo.coarse_cull(tscene, tprep.model, tprep.vp) == tprep.visible).all()
    visible = tprep.visible.numpy()
    lod = tprep.lod.numpy()
    clip_mats = np.einsum("ij,njk->nik", mats[0], np.asarray(jprep[0]).reshape(-1, 4, 4))
    mesh_id = tscene.instances.mesh_id.long()
    demand = int(torch.where(t(visible), tscene.meshes.lod_tri_count[mesh_id, t(lod)], 0).sum())
    for cap in (1024, 128):  # 128 truncates
        want = jgeo.expand_clip_only(jscene, jnp.asarray(visible), jnp.asarray(lod.astype(np.int32)),
                                     jnp.asarray(clip_mats), cap)
        got = tgeo.expand_clip_only(tscene, t(visible), t(lod), t(clip_mats), cap)
        assert (got[1].numpy() == np.asarray(want[1])).all()
        assert int(got[2]) == int(want[2])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
        assert int(got[2]) == min(demand, cap)


# --- setup, binning, the occlusion walk -------------------------------------

@pytest.mark.parametrize("case", ["perspective", "w_crossing"])
def test_setup_light_tris_matches_jax(case):
    clip, valid, *_ = CASES[case]()
    want, want_bb = jrt._setup_light_tris(jnp.asarray(clip), jnp.asarray(valid))
    got = trt._setup_light_tris(t(clip), t(valid))
    assert got.shape == (clip.shape[0], 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :20], rtol=1e-6, atol=0)
    assert ((got[:, O_OK] > 0.5).numpy() == np.asarray(want_bb[4])).all()


def test_binning_matches_brute_force():
    clip, valid, lx, ly, ld = CASES["w_crossing"]()
    rec = trt._setup_light_tris(t(clip), t(valid))
    plx, ply, pld = (trt._pad_to_tiles(t(a), f) for a, f in ((lx, 0.0), (ly, 0.0), (ld, np.inf)))
    tile_bbox = trt.tile_receiver_bboxes(plx, ply, pld)
    blist, bcount = trt.bin_blocks_by_bbox(rec, tile_bbox)
    # numpy: receiver bbox per tile, caster-block bbox unions, overlap
    h, w = plx.shape
    live = np.isfinite(pld.numpy())
    r = rec.numpy()
    ok = valid & (r[:, 19] > 0.5)
    n_blocks = len(r) // BLOCK
    tb = tile_bbox.numpy()
    for tile in range(tb.shape[0]):
        ty, tx = divmod(tile, w // TILE_W)
        sl = (slice(ty * TILE_H, (ty + 1) * TILE_H), slice(tx * TILE_W, (tx + 1) * TILE_W))
        m = live[sl]
        if m.any():
            box = [plx.numpy()[sl][m].min(), plx.numpy()[sl][m].max(),
                   ply.numpy()[sl][m].min(), ply.numpy()[sl][m].max()]
            np.testing.assert_array_equal(tb[tile], np.float32(box))
        else:
            box = tb[tile]
            assert box[0] > box[1]
        want = []
        for b in range(n_blocks):
            k = ok[b * BLOCK:(b + 1) * BLOCK]
            if not k.any():
                continue
            bb = r[b * BLOCK:(b + 1) * BLOCK, O_BB:O_BB + 4][k]
            if (bb[:, 0].min() <= box[1] and bb[:, 1].max() >= box[0]
                    and bb[:, 2].min() <= box[3] and bb[:, 3].max() >= box[2]):
                want.append(b)
        n = int(bcount[tile])
        assert blist[tile, :n].tolist() == want, tile


def brute_force_f64(clip, valid, lx, ly, ld, rel=1e-5):
    """(occ, decided): float64 point-in-triangle occlusion, and the
    receivers where no caster has an edge, w or depth margin below ``rel``
    relative (there the float32 answer must agree)."""
    c = clip.astype(np.float64)[valid]
    x, y, w = c[:, :, 0], c[:, :, 1], c[:, :, 3]
    e = []
    for a, b in ((1, 2), (2, 0), (0, 1)):
        e.append(np.stack([y[:, a] * w[:, b] - w[:, a] * y[:, b],
                           w[:, a] * x[:, b] - x[:, a] * w[:, b],
                           x[:, a] * y[:, b] - y[:, a] * x[:, b]], -1))
    e = np.stack(e, 1)  # (n, 3 edges, 3 coeffs)
    det = (e[:, 0] * np.stack([x[:, 0], y[:, 0], w[:, 0]], -1)).sum(-1)
    keep = det != 0
    e, c = e[keep] * np.sign(det[keep])[:, None, None], c[keep]
    px, py, d = (a.reshape(-1).astype(np.float64)[:, None] for a in (lx, ly, ld))
    lo = np.zeros(px.shape[0], bool)  # occluded with a clear margin
    hi = np.zeros(px.shape[0], bool)  # occluded or within the margin of it
    for k in range(len(c)):
        lam = [e[k, i, 0] * px + e[k, i, 1] * py + e[k, i, 2] for i in range(3)]
        scale = [np.abs(e[k, i, 0] * px) + np.abs(e[k, i, 1] * py) + abs(e[k, i, 2])
                 for i in range(3)]
        z_num = sum(lam[i] * c[k, i, 2] for i in range(3))
        w_den = sum(lam[i] * c[k, i, 3] for i in range(3))
        w_scale = sum(np.abs(lam[i] * c[k, i, 3]) for i in range(3))
        with np.errstate(invalid="ignore", divide="ignore"):
            dw = d * w_den
            depth = np.where(np.isinf(d), 1.0, (dw - z_num) / (np.abs(dw) + np.abs(z_num)))
        margin = np.minimum.reduce([lam[i] / np.maximum(scale[i], 1e-30) for i in range(3)]
                                   + [w_den / np.maximum(w_scale, 1e-30), depth])[:, 0]
        lo |= margin > rel
        hi |= margin >= -rel
    occ = np.where(lo, 0.0, 1.0).reshape(lx.shape)
    return occ, (lo == hi).reshape(lx.shape)


@pytest.mark.parametrize("case", sorted(CASES))
def test_occlusion_grid_matches_jax_and_float64(case):
    clip, valid, lx, ly, ld = CASES[case]()
    got = trt.occlusion_grid(t(clip), t(valid), t(lx), t(ly), t(ld)).numpy()
    assert got.shape == lx.shape and set(np.unique(got)) <= {0.0, 1.0}
    want = np.asarray(jrt.occlusion_grid(*(jnp.asarray(a) for a in (clip, valid, lx, ly, ld)),
                                         interpret=True))
    live = np.isfinite(ld)
    assert (got[~live] == 1.0).all()
    assert (got == want)[live].mean() >= 0.999, (got != want)[live].sum()
    ref, decided = brute_force_f64(clip, valid, lx, ly, ld)
    assert decided[live].mean() > 0.99
    bad = (got != ref) & decided & live
    assert not bad.any(), f"{bad.sum()} receivers differ from the float64 brute force"
    if valid.sum() > 100:
        assert 0.2 < (got[live] == 0).mean() < 0.95  # a real mix of lit and shadowed


def test_occlusion_plain_ignores_visiting_order():
    """The walk is an OR over casters: reversing every bin list gives the
    same plane."""
    args = trt.occlusion_inputs(*(t(a) for a in CASES["perspective"]()))
    rec, blist, bcount, *rest = args
    rev = blist.clone()
    for tile, n in enumerate(bcount.tolist()):
        rev[tile, :n] = blist[tile, :n].flip(0)
    assert torch.equal(occlusion_tiles_plain(*args), occlusion_tiles_plain(rec, rev, bcount, *rest))


def test_bilateral_upsample_matches_jax():
    rng = np.random.default_rng(5)
    for s in (2, 3):
        big_h, big_w = 64, 128
        off = s // 2
        tri = (rng.integers(0, 6, (big_h // 8, big_w // 16)).repeat(8, 0).repeat(16, 1)
               .astype(np.int32))
        tri[rng.random(tri.shape) < 0.05] = -1
        tri_lo = tri[off::s, off::s]
        low = (rng.random(tri_lo.shape) < 0.6).astype(np.float32)
        low_ext = np.concatenate([low, low[-1:]], 0)
        tri_ext = np.concatenate([tri_lo, tri_lo[-1:]], 0)
        want = np.asarray(jrt._bilateral_upsample(jnp.asarray(low_ext), jnp.asarray(tri_ext),
                                                  jnp.asarray(tri), s, off))
        got = trt._bilateral_upsample(t(low_ext), t(tri_ext), t(tri), s, off).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name, rt_scale", [("sponza", 1), ("sponza", 2), ("point", 1)])
def test_rt_shadow_grid_matches_jax(name, rt_scale):
    jscene, tscene, jprep, tprep, world, normal, covered, tri = setup(name)
    mats = np.asarray(jshadow.directional_light_matrices(jscene.lights, jprep[5], jprep[6]))
    radius = np.float32(np.linalg.norm(np.asarray(jprep[6]) - np.asarray(jprep[5])) * 0.5 + 1e-3)
    want = np.asarray(jrt.rt_shadow_grid(
        jscene, *(jnp.asarray(a.numpy()) for a in (world, normal, covered)), jnp.asarray(mats),
        jprep[4], jprep[0], jnp.asarray(radius), 1024, 2, interpret=True,
        tri=jnp.asarray(tri.numpy()), rt_scale=rt_scale))
    casts = tuple((int(s) if a else -1, bool(d)) for s, d, a in zip(
        tscene.lights.shadow_slot.tolist(), tscene.lights.directional.tolist(),
        tscene.lights.alive.tolist()))
    slots = trt.slot_lights(casts, 2)
    assert slots[0] == (0, name == "sponza") and slots[1] is None
    got = torch.stack(trt.rt_shadow_grid(
        tscene, world, normal, covered, t(mats), tprep.lod, tprep.model, torch.tensor(radius),
        1024, slots, tri=tri, rt_scale=rt_scale)).numpy()
    assert got.shape == want.shape == (2,) + tuple(tri.shape)
    assert (got[1] == 1.0).all()
    cov = covered.numpy()
    assert (got[0] == want[0])[cov].mean() >= 0.999, (got[0] != want[0])[cov].sum()
    shadowed = (got[0] < 0.5) & cov
    assert shadowed.sum() > 20, "no shadow traced"


# --- plan, latch, contract, device default ----------------------------------

def tiny_renderer(**kw):
    return Renderer(textured_scene(SceneLimits.tiny(), 32, device=CPU),
                    PipelineConfig(width=128, height=64, tri_capacity=1024, **kw))


def test_rt_plan_swaps_shade():
    cfg = PipelineConfig(width=128, height=64)
    names = [p.name for p in build_forward_plan(cfg, rt=True)]
    assert names == ["pose", "prepare", "cull", "raster", "shade_rt", "present"]
    assert "shade" not in names
    assert "shade_rt" not in [p.name for p in build_forward_plan(cfg)]
    r = tiny_renderer()
    with pytest.raises(AttributeError, match="unknown runtime switch"):
        r.set_config(spmd=True)
    assert r.light_casts == ((-1, False), (0, True))


def test_switch_latch_and_plan_cache():
    cam = Camera.create([0.0, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0, aspect=2.0, device=CPU)
    r = tiny_renderer()
    base = r.render(cam)["image"]
    r.set_config(rt=True)
    assert not r.config.rt
    latched = r.render(cam)["image"]  # this frame still runs the old switches
    assert torch.equal(latched, base) and r.config.rt
    traced = r.render(cam)["image"]
    assert not torch.equal(traced, base)
    r.set_config(rt=False)
    r.apply_config_now()  # at once
    assert torch.equal(r.render(cam)["image"], base)
    assert len(r._plans) == 2
    other = tiny_renderer()
    other.set_config(rt=True)
    other.apply_config_now()
    assert torch.equal(other.render(cam)["image"], traced)


def test_shadow_slots_and_caster_capacity():
    """shadow_slots bounds the slots traced (0: none, so the rt frame is the
    rt-off frame); a smaller shadow_tri_capacity keeps a prefix of the
    casters, so no pixel gets darker and some get lighter (no AA here, and
    the upsample's weights do not depend on the plane). Bad values raise."""
    cam = Camera.create([0.0, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0, aspect=2.0, device=CPU)

    def rt_frame(**kw):
        r = tiny_renderer(**kw)
        r.set_config(rt=True)
        r.apply_config_now()
        return r.render(cam)["image"]

    base = tiny_renderer().render(cam)["image"]
    full = rt_frame()
    assert torch.equal(rt_frame(shadow_slots=0), base)
    assert torch.equal(rt_frame(shadow_slots=1), full)  # the scene's shadow light is in slot 0
    cut = rt_frame(shadow_tri_capacity=BLOCK)
    assert (cut >= full).all()
    assert (cut - full).sum() > 1.0  # the full rt frame is 3.57 darker than base, summed
    for bad in (dict(shadow_tri_capacity=BLOCK + 1), dict(rt_scale=0), dict(shadow_slots=-1)):
        with pytest.raises(ValueError):
            PipelineConfig(width=128, height=64, **bad)


def test_changed_light_cast_pattern_raises():
    cam = Camera.create([0.0, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0, aspect=2.0, device=CPU)
    r = tiny_renderer()
    lights = r.scene.lights
    moved = lights._replace(shadow_slot=torch.tensor([1, -1, -1, -1], dtype=torch.int32))
    with pytest.raises(ValueError, match="light cast pattern"):
        r.render(cam, scene=r.scene._replace(lights=moved))
    kind = lights._replace(directional=~lights.directional)
    with pytest.raises(ValueError, match="light cast pattern"):
        r.render(cam, scene=r.scene._replace(lights=kind))
    same = lights._replace(intensity=lights.intensity * 2.0)  # same pattern: fine
    assert r.render(cam, scene=r.scene._replace(lights=same))["image"].shape == (64, 128, 3)


def test_entry_points_default_to_the_card():
    assert default_device() == torch.device("cuda")
    b = SceneBuilder(SceneLimits.tiny())
    b.add_instance(b.add_mesh(primitives.box()))
    calls = {
        "textured_scene": lambda: textured_scene(SceneLimits.tiny(), 32).meshes.positions,
        "SceneBuilder.build": lambda: b.build().instances.alive,
        "scene_from_numpy": lambda: scene_from_numpy(
            as_numpy_scene(jax_sponza(8))).instances.translation,
        "Camera.create": lambda: Camera.create([0.0, 1.0, 2.0]).position,
        "orbit_camera": lambda: orbit_camera(0.3, 2.0).rotation,
        "quat_from_axis_angle": lambda: quat_from_axis_angle([0.0, 1.0, 0.0], 0.5),
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            assert call().device.type == "cuda", name
        else:  # no CUDA here: the call raises instead of building on the CPU
            with pytest.raises((AssertionError, RuntimeError)):
                call()
