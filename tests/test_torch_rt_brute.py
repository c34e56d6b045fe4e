"""Exact ray-traced shadows by brute force (renderer_tpu_torch/ops/rt.py)
against the JAX package's ``renderer_tpu.ops.rt``, and the light-space
grid against them.

Gates, with their reasons:
- triangles_world within 1e-5 of JAX's (the same sums; XLA's dot may
  fuse its multiply-adds);
- ray_shadow_directional and rt_shadow_planes against JAX's on live
  receivers (a lit floor under a box and random receivers among random
  triangles, from a seed): planes equal but on at most 0.2% of the
  receivers, which lie within rounding of a triangle's edge (JAX sums the
  three-term dots in its dot product, the port left to right);
- on the scene of the JAX package's tests/test_shadow.py:220 the port's
  grid frame against its brute-force frame, the JAX test's own gate:
  within 0.04 on > 97% of pixels, and the grid frame darker than the
  unshadowed one;
- a slot with no light, or with a point light, is a plane of ones and
  traces nothing;
- bounded by the soup's count (0, 1, 127, 128, 129, the live count and
  the capacity) against JAX's bounded walk at the same share, and bit for
  bit against the soup cut after the walked blocks; count 0 is all lit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.ops import rt as jrt
from renderer_tpu.scene import SceneBuilder as JaxBuilder, SceneLimits as JaxLimits
from renderer_tpu.scene import primitives as jprims
from renderer_tpu_torch.mathx import Camera, quat_from_axis_angle
from renderer_tpu_torch.ops import rt as trt
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives

FLIP_SHARE = 0.002  # receivers whose answer may differ from JAX's


def box_world_triangles(centre, half):
    """The 12 world triangles of an axis-aligned box."""
    box = primitives.box()
    return (box.positions[box.indices.reshape(-1, 3)] * (2 * half) + np.asarray(centre)).astype(
        np.float32)


def floor_receivers(n: int, size: float):
    """(3, n, n) receivers on the plane y = 0 and their normals (up)."""
    g = np.linspace(-size, size, n, dtype=np.float32)
    x, z = np.meshgrid(g, g)
    world = np.stack([x, np.zeros_like(x), z])
    normal = np.stack([np.zeros_like(x), np.ones_like(x), np.zeros_like(x)])
    return world, normal


def random_case(seed: int, n_tri: int = 300, scale: float = 0.4):
    """Receivers spread over a slab and triangles above them, from a seed."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(-2, 2, (3, 24, 40)).astype(np.float32)
    world[1] *= 0.1
    normal = rng.normal(size=(3, 24, 40)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    centres = rng.uniform(-2, 2, (n_tri, 1, 3)) * np.float32([1, 0.5, 1]) + np.float32([0, 1.5, 0])
    tri = (centres + rng.normal(scale=scale, size=(n_tri, 3, 3))).astype(np.float32)
    valid = rng.random(n_tri) < 0.9
    return world, normal, tri, valid


def agree(got, want, live):
    """The share of live receivers on which two lit planes differ."""
    return float(((got != want) & live).sum()) / max(1, int(live.sum()))


def test_triangles_world_matches_jax():
    rng = np.random.default_rng(4)
    clip = rng.uniform(-3, 3, (64, 3, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(0.5, 4, (64, 3))
    vp_inv = rng.normal(size=(4, 4)).astype(np.float32) + 2 * np.eye(4, dtype=np.float32)
    got = trt.triangles_world(torch.from_numpy(clip), torch.from_numpy(vp_inv)).numpy()
    want = np.asarray(jrt.triangles_world(jnp.asarray(clip), jnp.asarray(vp_inv)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["box_on_floor", "random"])
def test_ray_shadow_directional_matches_jax(case):
    if case == "box_on_floor":
        world, normal = floor_receivers(48, 3.0)
        tri = box_world_triangles((0.2, 0.8, -0.1), 0.5)
        valid = np.ones(len(tri), bool)
        direction = np.float32([1.0, -1.0, 0.3])
    else:
        world, normal, tri, valid = random_case(9)
        direction = np.float32([-0.3, -1.0, 0.5])
    # pad to a soup whose tail is invalid, as a culled stream's is
    pad = 200
    tri_s = np.concatenate([tri, np.zeros((pad, 3, 3), np.float32)])
    valid_s = np.concatenate([valid, np.zeros(pad, bool)])
    got = trt.ray_shadow_directional(torch.from_numpy(world), torch.from_numpy(normal),
                                     torch.from_numpy(direction), torch.from_numpy(tri_s),
                                     torch.from_numpy(valid_s)).numpy()
    want = np.asarray(jrt.ray_shadow_directional(
        jnp.asarray(world), jnp.asarray(normal), jnp.asarray(direction), jnp.asarray(tri_s),
        jnp.asarray(valid_s), jnp.int32(len(tri))))
    assert got.shape == want.shape == (1,) + world.shape[1:]
    live = np.ones(got.shape, bool)
    assert agree(got, want, live) <= FLIP_SHARE
    assert 0.02 < (got == 0).mean() < 0.9  # shadowed and lit receivers both


COUNT_CASE_TRIS = 600  # past four blocks, so that 1, 127 and 129 cut a block
COUNT_CAPACITY = 768


@pytest.mark.parametrize("count", ["0", "1", "127", "128", "129", "live", "capacity"])
def test_count_bounded_ray_shadow_matches_jax(count):
    """The walk bounded by the count, as JAX bounds it: whole blocks below
    ceil(count / 128), so a live triangle past the count in the last
    walked block still occludes; count 0 leaves every receiver lit."""
    world, normal, tri, valid = random_case(11, COUNT_CASE_TRIS, scale=0.15)
    direction = np.float32([-0.3, -1.0, 0.5])
    pad = COUNT_CAPACITY - COUNT_CASE_TRIS
    tri_s = np.concatenate([tri, np.zeros((pad, 3, 3), np.float32)])
    valid_s = np.concatenate([valid, np.zeros(pad, bool)])
    c = {"live": COUNT_CASE_TRIS, "capacity": COUNT_CAPACITY}.get(count) or int(count)
    args = [torch.from_numpy(a) for a in (world, normal, direction, tri_s, valid_s)]
    got = trt.ray_shadow_directional(*args, count=torch.tensor(c, dtype=torch.int32)).numpy()
    want = np.asarray(jrt.ray_shadow_directional(
        *(jnp.asarray(a) for a in (world, normal, direction, tri_s, valid_s)), jnp.int32(c)))
    assert got.shape == want.shape == (1,) + world.shape[1:]
    assert agree(got, want, np.ones(got.shape, bool)) <= FLIP_SHARE
    walked = -(-c // trt.BLOCK) * trt.BLOCK
    # the same as the soup cut after the walked blocks, bit for bit
    cut = valid_s & (np.arange(len(valid_s)) < walked)
    want_cut = trt.ray_shadow_directional(*args[:4], torch.from_numpy(cut)).numpy()
    assert np.array_equal(got, want_cut)
    if c == 0:
        assert (got == 1).all()
    else:
        assert (got == 0).any()
        if walked < COUNT_CASE_TRIS:  # the cut leaves occluders unwalked
            full = trt.ray_shadow_directional(*args).numpy()
            assert (full == 0).sum() > (got == 0).sum()


def jax_lights(kinds):
    """A JAX light table with, per slot in order, a directional light, a
    point light or none (its lights' positions from the slot number)."""
    b = JaxBuilder(JaxLimits.tiny())
    for slot, kind in enumerate(kinds):
        if kind == "directional":
            b.add_light(position=(0.4 - 0.2 * slot, -1.0, 0.3), directional=True, shadow_slot=slot)
        elif kind == "point":
            b.add_light(position=(0.0, 3.0, 0.0), shadow_slot=slot)
    b.add_instance(b.add_mesh(jprims.box()), b.add_material())
    return b.build().lights


@pytest.mark.parametrize("rt_scale", [1, 2, 3])
def test_rt_shadow_planes_match_jax(rt_scale):
    world, normal = floor_receivers(30, 3.0)
    tri = np.concatenate([box_world_triangles((0.2, 0.8, -0.1), 0.5),
                          box_world_triangles((-1.2, 1.5, 0.8), 0.4)])
    valid = np.ones(len(tri), bool)
    kinds = ("directional", None, "point", "directional")
    jl = jax_lights(kinds)
    lights = jl._replace(**{f: torch.from_numpy(np.array(getattr(jl, f))) for f in jl._fields})
    casts = [(int(s) if a else -1, bool(d)) for s, d, a in
             zip(np.asarray(jl.shadow_slot), np.asarray(jl.directional), np.asarray(jl.alive))]
    slots = tuple(next(((li, d) for li, (s, d) in enumerate(casts) if s == k), None)
                  for k in range(len(kinds)))
    got = trt.rt_shadow_planes(torch.from_numpy(world), torch.from_numpy(normal), lights,
                               torch.from_numpy(tri), torch.from_numpy(valid), slots, rt_scale)
    want = np.asarray(jrt.rt_shadow_planes(jnp.asarray(world), jnp.asarray(normal), jl,
                                           jnp.asarray(tri), jnp.asarray(valid),
                                           jnp.int32(len(tri)), len(kinds), rt_scale))
    assert len(got) == len(kinds)
    live = np.ones(world.shape[1:], bool)
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        assert g.shape == w.shape == world.shape[1:]
        assert agree(g, w, live) <= FLIP_SHARE, k
        if kinds[k] != "directional":
            assert (g == 1).all()
        else:
            assert (g == 0).any()


def test_empty_and_point_slots_trace_nothing(monkeypatch):
    calls = []
    trace = trt.ray_shadow_directional

    def counting(*args, **kw):
        calls.append(1)
        return trace(*args, **kw)

    monkeypatch.setattr(trt, "ray_shadow_directional", counting)
    world, normal = floor_receivers(8, 1.0)
    lights = jax_lights(("directional",))
    lights = lights._replace(**{f: torch.from_numpy(np.array(getattr(lights, f)))
                                for f in lights._fields})
    tri = torch.from_numpy(box_world_triangles((0.0, 0.8, 0.0), 0.3))
    planes = trt.rt_shadow_planes(torch.from_numpy(world), torch.from_numpy(normal), lights,
                                  tri, torch.ones(len(tri), dtype=torch.bool),
                                  (None, (1, False), (0, True), None), 1)
    assert len(calls) == 1
    for k in (0, 1, 3):
        assert planes[k].shape == (8, 8) and (planes[k] == 1).all()
        assert planes[k].stride() == (0, 0)  # a fill, not a traced plane
    assert (planes[2] == 0).any()


def shadow_scene():
    """The scene of the JAX package's tests/test_shadow.py:220."""
    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=10.0))
    box = b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.8, 0.8, 0.8, 1), roughness=1.0))
    b.add_instance(box, b.add_material(base_color=(0.8, 0.2, 0.2, 1)), translation=(0, 0.8, 0))
    b.add_light(position=(1.0, -1.0, 0.0), directional=True, intensity=3.0, shadow_slot=0)
    return b.build(device="cpu")


def test_grid_matches_brute_force():
    scene = shadow_scene()
    rot = quat_from_axis_angle((1.0, 0.0, 0.0), -np.pi / 2, device="cpu")
    cam = Camera.create((0.0, 6.0, 0.01), rot.numpy(), near=0.1, far=50.0, device="cpu")

    def run(tile_raster, rt=True):
        cfg = PipelineConfig(width=128, height=64, tri_capacity=512, rt_scale=1,
                             tile_raster=tile_raster)
        r = Renderer(scene, cfg)
        r.set_config(rt=rt)
        r.apply_config_now()
        return r.render(cam)["image"].numpy()

    img_grid, img_brute = run(True), run(False)
    close = np.abs(img_grid - img_brute).max(-1) < 0.04
    assert close.mean() > 0.97, close.mean()
    lit = run(True, rt=False)
    assert (lit - img_grid).max() > 0.05
    assert ((lit - img_brute).max(-1) > 0.05).mean() > 0.005  # the brute force shadows too
