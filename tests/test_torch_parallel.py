"""The split frame (renderer_tpu_torch/parallel) on the CPU: the port's
n-shard frame against its single-shard frame and against the JAX
package's SPMD frame (tests/test_parallel.py's scene and size).

Gates. Against the single-shard frame, the JAX tests' rule: the same
covered mask and the image within atol 2e-6; and the port's tri_id equal
too, since the port puts the gathered soup back in the cull's order (the
JAX package keeps it in shard order). Against the JAX package's
2-device frame (Pallas in interpret mode, as tests/test_parallel.py runs
it), the port's single-shard bar of tests/test_torch_pipeline.py: the
visible (instance, library triangle) equal on >= 99.9% of pixels and
display-clamped PSNR >= 50 dB. The port's atlas slots are 128 (its tile
raster's multiple), where the JAX test's are 64.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from renderer_tpu.mathx.camera import Camera as JaxCamera
from renderer_tpu.parallel import make_mesh as jax_make_mesh
from renderer_tpu.passes.pipeline import PipelineConfig as JaxConfig
from renderer_tpu.runtime import Renderer as JaxRenderer
from renderer_tpu.utils.image import psnr
from renderer_tpu_torch.mathx import Camera
from renderer_tpu_torch.ops.overlay import hud_overlay
from renderer_tpu_torch.ops.rt_grid import _bilateral_upsample
from renderer_tpu_torch.parallel import make_mesh, render_frame_spmd, run_shards
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import Renderer
from renderer_tpu_torch.utils import tree
from test_parallel import small_scene as jax_small_scene

WIDTH, HEIGHT = 128, 256
ATOL = 2e-6
OPTS = dict(tri_capacity=8192, shadow_slots=2, shadow_size=128)

# name -> (shards, config changes, switches)
CASES = {
    "n2": (2, {}, {}),
    "n4": (4, {}, {}),
    "n8": (8, {}, {}),
    "n8_shadows_occlusion": (8, {}, dict(shadows=True, occlusion_culling=True)),
    "n8_ssaa2": (8, dict(ssaa=2, height=HEIGHT // 2), {}),
    "n8_rt": (8, {}, dict(rt=True)),
    "n8_checkerboard": (8, dict(shade_rate="checkerboard"), {}),
    "n8_quarter": (8, dict(shade_rate="quarter"), {}),
    "n8_edge_aa": (8, dict(aa="edge"), {}),
    "n8_freeze": (8, {}, dict(freeze_culling=True)),
    # past the JAX tests' switch sets: the other shading and soups
    "n8_lambert": (8, dict(shading="lambert"), {}),
    "n8_debug_aabbs": (8, {}, dict(debug_aabbs=True)),
    "n2_reference_image": (2, {}, dict(reference_image=True)),
    "n2_cluster_cull": (2, dict(cluster_cull=True), {}),
}


def small_scene():
    from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives

    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane = b.add_mesh(primitives.plane(size=16.0))
    sph = b.add_mesh(primitives.uv_sphere(rings=8, sectors=12))
    box = b.add_mesh(primitives.box())
    checker = b.add_texture(primitives.checkerboard_texture(16, squares=4))
    floor = b.add_material(roughness=0.6, base_color_tex=checker)
    red = b.add_material(base_color=(0.8, 0.2, 0.2, 1), roughness=0.4)
    b.add_instance(plane, floor, translation=(0, -0.6, 0))
    b.add_instance(sph, red, translation=(-0.9, 0, 0), scale=1.1)
    b.add_instance(box, red, translation=(0.9, 0, 0))
    b.add_light(position=(3.0, 5.0, 4.0), intensity=30.0)
    b.add_light(position=(-0.5, -1.0, -0.3), directional=True, intensity=0.5, shadow_slot=0)
    return b.build(device="cpu")


CAM = dict(position=[0.0, 1.2, 4.0], fov_y=0.9, near=0.1, far=60.0)


def camera():
    return Camera.create(**CAM, device="cpu")


@pytest.fixture(scope="module")
def scene():
    return small_scene()


def renderer(scene, shards, outputs=("image", "vis"), **changes):
    cfg = PipelineConfig(**{**dict(width=WIDTH, height=HEIGHT, **OPTS), **changes},
                         spmd_devices=shards)
    mesh = make_mesh(["cpu"] * shards) if shards > 1 else None
    return Renderer(scene, cfg, outputs=outputs, spmd_mesh=mesh)


def frame(scene, shards, changes, switches):
    """One frame with the switches on; freezing and occlusion culling after
    a frame without them (the latch), so they keep a culled list and read a
    depth."""
    r = renderer(scene, shards, **changes)
    r.set_config(**switches)
    if {"freeze_culling", "occlusion_culling"} & set(switches):
        r.render(camera())
    else:
        r.apply_config_now()
    return r, r.render(camera())


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_frame_matches_single_shard(scene, name):
    shards, changes, switches = CASES[name]
    _, one = frame(scene, 1, changes, switches)
    r, split = frame(scene, shards, changes, switches)
    covered = split["vis"].tri_id != -1
    assert torch.equal(one["vis"].tri_id, split["vis"].tri_id)
    assert 0.2 < covered.float().mean() < 1.0
    np.testing.assert_allclose(split["image"].numpy(), one["image"].numpy(), atol=ATOL, rtol=0)
    w, h = r.cfg.render_size
    assert split["vis"].depth.shape == (h, w)
    assert [tuple(s["vis"].depth.shape) for s in r.shard_states] == [(h // shards, w)] * shards
    # each shard's buffer is its band of rows of the joined one
    rows = h // shards
    for i, o in enumerate(r.shard_outputs):
        assert torch.equal(o["vis"].depth, split["vis"].depth[i * rows:(i + 1) * rows])


def test_split_soup_is_gathered_by_shard(scene, monkeypatch):
    """Each shard culls every n-th instance at 1/n of the capacity: the
    gathered valid mask is segmented by shard, instance ids lifted to
    global; put back in the cull's order, the soup is the single-shard one."""
    from renderer_tpu_torch.ops import geometry

    gathered = []
    order = geometry.draw_order

    def draw_order(soup, n):
        gathered.append(soup)
        return order(soup, n)

    monkeypatch.setattr(geometry, "draw_order", draw_order)
    soup = renderer(scene, 8, outputs=("image", "vis", "soup")).render(camera())["soup"]
    seg = gathered[0].valid.reshape(8, -1)
    assert int(soup.count) == int(seg.sum()) > 0
    assert not bool(gathered[0].valid[: int(soup.count)].all())
    for d in range(8):  # shard d holds instance d (of the scene's three) only
        inst = gathered[0].instance.reshape(8, -1)[d][seg[d]]
        assert bool((inst == d).all()) and (seg[d].any() == (d < 3))
    one = renderer(scene, 1, outputs=("image", "vis", "soup")).render(camera())["soup"]
    live = one.valid
    assert torch.equal(live, soup.valid)
    for f in ("clip", "instance", "tri_idx", "tex_lod"):
        assert torch.equal(getattr(one, f)[live], getattr(soup, f)[live]), f


def test_split_frame_breaks_depth_ties_as_single_shard():
    """Two copies of a box in one place, red and green: their triangles tie
    in depth everywhere, and the one lower in the cull's order wins (the
    red, instance 1). On two shards the green copy (instance 2) is culled
    by shard 0, so in the gathered order it would come first."""
    from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives

    b = SceneBuilder(SceneLimits.tiny(), atlas_size=16)
    plane, box = b.add_mesh(primitives.plane(size=16.0)), b.add_mesh(primitives.box())
    b.add_instance(plane, b.add_material(base_color=(0.5, 0.5, 0.5, 1)), translation=(0, -0.6, 0))
    b.add_instance(box, b.add_material(base_color=(0.9, 0.1, 0.1, 1)))
    b.add_instance(box, b.add_material(base_color=(0.1, 0.9, 0.1, 1)))
    b.add_light(position=(3.0, 5.0, 4.0), intensity=30.0)
    twins = b.build(device="cpu")
    one, split = (renderer(twins, n, outputs=("image", "vis", "soup")).render(camera())
                  for n in (1, 2))
    assert torch.equal(one["vis"].tri_id, split["vis"].tri_id)
    np.testing.assert_allclose(split["image"].numpy(), one["image"].numpy(), atol=ATOL, rtol=0)
    tri = split["vis"].tri_id
    on_box = (tri >= 0) & (split["soup"].instance[tri.clamp(min=0).long()] > 0)
    assert on_box.sum() > 100
    seen = split["image"][on_box]
    assert bool((seen[:, 0] > seen[:, 1]).all())  # the red copy


def test_render_frame_spmd_one_frame(scene):
    img, depth, tri_id = render_frame_spmd(scene, camera(), make_mesh(["cpu"] * 8), WIDTH,
                                           HEIGHT, tri_capacity_per_device=1024)
    assert img.shape == (HEIGHT, WIDTH, 3) and torch.isfinite(img).all()
    assert depth.shape == tri_id.shape == (HEIGHT, WIDTH)
    assert (tri_id != -1).any()


def test_hud_composites_after_the_gather(scene):
    r = renderer(scene, 8)
    r.set_config(hud=True)
    r.apply_config_now()
    img = r.render(camera(), overlay=hud_overlay("SPMD OK", WIDTH))["image"]
    base = renderer(scene, 8).render(camera())["image"]
    assert img.shape == (HEIGHT, WIDTH, 3) and torch.isfinite(img).all()
    assert img[6, 6].mean() < base[6, 6].mean() + 1e-6  # the panel darkened the corner


def visible_identity(soup, tri_id):
    inst = np.asarray(soup.instance).astype(np.int64)
    tri = np.asarray(soup.tri_idx).astype(np.int64)
    safe = np.maximum(tri_id, 0)
    return np.where(tri_id >= 0, (inst[safe] << 32) + tri[safe], -1)


def test_split_frame_matches_jax_spmd(scene):
    outputs = ("image", "vis", "soup")
    got = renderer(scene, 2, outputs=outputs).render(camera())
    jcfg = JaxConfig(width=WIDTH, height=HEIGHT, tri_capacity=8192, use_pallas=True,
                     pallas_interpret=True, shading="pbr", spmd_devices=2)
    want = JaxRenderer(jax_small_scene(), jcfg, outputs=outputs,
                       spmd_mesh=jax_make_mesh(jax.devices()[:2])).render(JaxCamera.create(
                           jnp.asarray(CAM["position"]), fov_y=0.9, near=0.1, far=60.0))
    got_id, want_id = got["vis"].tri_id.numpy(), np.asarray(want["vis"].tri_id)
    same = visible_identity(got["soup"], got_id) == visible_identity(want["soup"], want_id)
    assert same.mean() >= 0.999, f"visible triangle differs on {(~same).sum()} pixels"
    img = got["image"].numpy()
    assert img.shape == (HEIGHT, WIDTH, 3) and np.isfinite(img).all()
    assert psnr(np.clip(img, 0, 1), np.clip(np.asarray(want["image"]), 0, 1)) >= 50.0


def test_failing_shard_raises_not_hangs(scene):
    """A pass that raises on shard 1 releases the other shards from their
    collectives; render raises that error long before the timeout."""
    r = renderer(scene, 4)
    build = r.plan_builder

    def failing_plan(*args, **kw):
        from renderer_tpu_torch.parallel import current_shard

        passes = build(*args, **kw)
        shade = next(i for i, p in enumerate(passes) if p.name == "shade")
        shade_fn = passes[shade].fn

        def fn(**a):
            if current_shard().axis_index() == 1:
                raise RuntimeError("shard 1 failed")
            return shade_fn(**a)

        passes[shade] = passes[shade]._replace(fn=fn)
        return passes

    r.plan_builder = failing_plan
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        r.render(camera())
    assert time.perf_counter() - t0 < 30.0
    assert not [t for t in threading.enumerate() if t.name.startswith("shard-")]


def test_collective_timeout_raises():
    """A shard that never reaches a collective: the others time out and
    run_shards raises instead of waiting for ever."""
    release = threading.Event()

    def fn(s):
        if s.axis_index() == 0:
            release.wait(10.0)
            return None
        return s.psum(torch.ones(()))

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        run_shards(make_mesh(["cpu"] * 3), fn, timeout=0.5)
    release.set()
    assert time.perf_counter() - t0 < 5.0


def test_collectives_under_stress():
    """More shards than cores, a short switch interval, many rounds: every
    round's sum and gather hold each shard's value of that round."""
    n, rounds = 16, 50

    def fn(s):
        i = s.axis_index()
        for r in range(rounds):
            total = s.psum(torch.tensor(i * rounds + r))
            gathered = s.all_gather(torch.tensor([r, i]))
            if int(total) != rounds * n * (n - 1) // 2 + n * r or not torch.equal(
                    gathered, torch.stack([torch.arange(n) * 0 + r, torch.arange(n)], 1).flatten()):
                return False
        return True

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        assert run_shards(make_mesh(["cpu"] * n), fn, timeout=60.0) == [True] * n
    finally:
        sys.setswitchinterval(interval)


def test_collectives():
    def fn(s):
        i = s.axis_index()
        x = torch.full((2, 3), float(i))
        rows = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3) + 100 * i
        return (s.all_gather(x), s.all_gather({"a": x[0], "c": torch.tensor(i)}),
                s.psum(torch.tensor(i + 1)), s.halo_rows(rows))

    out = run_shards(make_mesh(["cpu"] * 4), fn)
    for i, (g, nested, total, ((above, below),)) in enumerate(out):
        assert torch.equal(g, torch.arange(4.0).repeat_interleave(2)[:, None].expand(8, 3))
        assert torch.equal(nested["a"], torch.arange(4.0).repeat_interleave(3))
        assert int(nested["c"]) == i  # 0-dim leaves are not gathered
        assert int(total) == 10
        own = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * i
        assert torch.equal(above, own[:1] if i == 0 else own[-1:] - 100)
        assert torch.equal(below, own[-1:] if i == 3 else own[:1] + 100)


@pytest.mark.parametrize("s", [2, 3, 4])
def test_rt_upsample_band_equals_whole_grid(s):
    """The rt upsample of a band of rows with its neighbours' halo rows
    equals the whole grid's rows, bit for bit (the JAX package passes the
    row below only, so its bands' first rows differ from the whole)."""
    rng = np.random.default_rng(s)
    n, h, w = 4, 8 * s, 16 * s
    off = s // 2
    tri = torch.from_numpy(rng.integers(0, 3, (n * h, w)).astype(np.int32))
    tri_lo = tri[off::s, off::s]
    occ = torch.from_numpy(rng.uniform(size=tri_lo.shape).astype(np.float32))

    def rows(a, lo, hi):  # rows lo..hi - 1 of a, clamped to its edges
        return a[torch.clamp(torch.arange(lo, hi), 0, a.shape[0] - 1)]

    total = occ.shape[0]
    whole = _bilateral_upsample(rows(occ, 0, total + 1), rows(tri_lo, 0, total + 1), tri, s, off)
    h_lo = h // s
    for d in range(n):
        lo, hi = d * h_lo, (d + 1) * h_lo
        band = _bilateral_upsample(rows(occ, lo, hi + 1), rows(tri_lo, lo, hi + 1),
                                   tri[d * h:(d + 1) * h], s, off, d * h, n * h_lo,
                                   above=(rows(occ, lo - 1, lo), rows(tri_lo, lo - 1, lo)))
        assert torch.equal(band, whole[d * h:(d + 1) * h])


def test_checkpoint_round_trip_of_a_split_renderer(scene, tmp_path):
    """A split renderer's checkpoint holds the whole frame's state in the
    single-shard layout: restored into a fresh 2-shard renderer or into a
    single-shard one, the next frame (occlusion culling reads the restored
    depth and viewproj, the cached atlas its restored slots) equals the
    frame rendered on without the round trip."""
    from renderer_tpu_torch.runtime.checkpoint import load_renderer, save_renderer

    moved = Camera.create(**{**CAM, "position": [0.4, 1.0, 3.6]}, device="cpu")
    prefix = str(tmp_path / "split")

    def start(shards):
        r = renderer(scene, shards, shadow_cache=True)
        r.set_config(shadows=True, occlusion_culling=True)
        r.apply_config_now()
        return r

    r = start(2)
    r.render(camera())
    saved = r.state
    assert saved["vis"].depth.shape == (HEIGHT, WIDTH)
    save_renderer(prefix, r)
    want = r.render(moved)
    for shards in (2, 1):
        back = start(shards)
        load_renderer(prefix, back)
        for k, v in back.state.items():
            assert all(torch.equal(a, b) for a, b in zip(tree.leaves(v), tree.leaves(saved[k])))
        if shards == 2:  # each shard holds its rows again
            assert torch.equal(back.shard_states[1]["vis"].depth,
                               saved["vis"].depth[HEIGHT // 2:])
        got = back.render(moved)
        assert torch.equal(got["vis"].tri_id, want["vis"].tri_id)
        np.testing.assert_allclose(got["image"].numpy(), want["image"].numpy(), atol=ATOL,
                                   rtol=0)


def test_split_config_checks(scene):
    with pytest.raises(ValueError, match="tile_raster"):
        PipelineConfig(width=WIDTH, height=HEIGHT, spmd_devices=2, tile_raster=False)
    with pytest.raises(ValueError, match="spmd_devices=3"):
        PipelineConfig(width=WIDTH, height=HEIGHT, tri_capacity=8192 * 3, spmd_devices=3)
    with pytest.raises(ValueError, match="shard"):
        Renderer(scene, PipelineConfig(width=WIDTH, height=HEIGHT, **OPTS, spmd_devices=2),
                 spmd_mesh=make_mesh(["cpu"] * 4))
    with pytest.raises(RuntimeError, match="spmd_mesh"):  # a split plan outside a mesh
        r = renderer(scene, 2)
        from renderer_tpu_torch.runtime.frame import execute_plan

        execute_plan(r.passes, r.outputs, r.state, **r._external(camera()))
