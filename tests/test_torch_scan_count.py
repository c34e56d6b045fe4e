"""The scan rasterizer bounded by the soup's count
(``renderer_tpu_torch.ops.raster_scan.rasterize_scan(..., count=)``, the
plain version on the CPU) against the JAX package's
``renderer_tpu.ops.raster_jax.rasterize(..., count=)``.

The soups are the plain configuration's own: expanded, culled and
compacted by the port's plain cull (a grid of boxes, and the JAX demo's
mixed scene), fed to both rasterizers as the same numpy arrays. The counts
are 0, 1, 127, 128, 129, the live count and the capacity. Both walk whole
128-triangle blocks below ceil(count / 128), so 1, 127 and 129 cut a block
that holds live triangles past the count, and those are still drawn.

Gates, with their reasons:
- depth within 2e-4: a triangle crossing w = 0 keeps its depth only to
  that (ROADMAP queue 3, fault 2), and XLA may fuse the edge functions'
  multiply-adds where the port rounds each product;
- the visible (instance, library triangle) equal on >= 99.9% of pixels: a
  pixel centre within rounding of an edge may flip for the same reason;
- barycentrics, where the visible triangle agrees, within 2e-3 of JAX's
  and within 1e-4 of a float64 evaluation of the same edge functions (mean
  within 1e-6), and no further from it than JAX's: JAX's XLA dot rounds
  the edge functions otherwise and strays further from float64 than the
  port (each product and sum rounded once, then one divide);
- on the compacted soups the bounded result equals the unbounded one bit
  for bit at the live count, and at any count it equals the unbounded
  result of the soup with every triangle past the walked blocks removed.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.ops.raster_jax import rasterize as jax_rasterize
from renderer_tpu_torch.demo import build_scene, make_camera
from renderer_tpu_torch.mathx import Camera, quat_from_axis_angle
from renderer_tpu_torch.ops import geometry
from renderer_tpu_torch.ops.cull import compact_soup
from renderer_tpu_torch.ops.raster_scan import rasterize_scan, scan_inputs
from renderer_tpu_torch.scene import SceneBuilder, SceneLimits, primitives

SIZES = [(128, 64), (256, 256)]
COUNTS = ["0", "1", "127", "128", "129", "live", "capacity"]
CAPACITY = 2048
DEPTH_TOL = 2e-4
SAME_SHARE = 0.999
BARY_JAX_TOL = 2e-3
BARY_F64_TOL = 1e-4
BARY_F64_MEAN = 1e-6


def box_grid_scene():
    """A 7x7 grid of boxes, each turned about y by its own angle."""
    b = SceneBuilder(SceneLimits.tiny())
    box = b.add_mesh(primitives.box())
    mat = b.add_material(base_color=(0.7, 0.6, 0.5, 1.0))
    for i in range(7):
        for j in range(7):
            rot = quat_from_axis_angle((0.0, 1.0, 0.0), 0.37 * (7 * i + j), device="cpu")
            b.add_instance(box, mat, translation=(1.6 * (i - 3), 0.0, 1.6 * (j - 3)),
                           rotation=rot.numpy())
    return b.build(device="cpu")


@functools.lru_cache(maxsize=None)
def soup(kind: str, width: int, height: int):
    """The plain configuration's compacted soup at this size: (clip, valid,
    instance, library triangle) as numpy, and the live count."""
    dev = torch.device("cpu")
    if kind == "boxes":
        scene = box_grid_scene()
        rot = quat_from_axis_angle((1.0, 0.0, 0.0), -0.6, device="cpu")
        cam = Camera.create((0.0, 7.0, 10.0), rot.numpy(), fov_y=0.9, aspect=width / height,
                            near=0.1, far=60.0, device=dev)
    else:
        scene, cam = build_scene("mixed", dev), make_camera("mixed", 0.5, dev)
    p = geometry.prepare_frame_columns(scene, cam)
    s = geometry.expand_draw_stream(scene, p.visible, p.lod, p.clip_mats, p.model, CAPACITY)
    s = compact_soup(geometry.cull_triangles(s, cull_backface=True))
    live = int(s.count)
    assert 256 < live < CAPACITY  # live triangles past the cut blocks, and room
    return (s.clip.numpy(), s.valid.numpy(), s.instance.numpy(), s.tri_idx.numpy()), live


def count_of(name: str, live: int) -> int:
    return {"live": live, "capacity": CAPACITY}.get(name) or int(name)


def bary_f64(clip, valid, width, height, tri_id, where):
    """(3, n) barycentrics of the pixels ``where`` for their triangles
    ``tri_id``: the port's float32 edge coefficients evaluated in float64."""
    adj = scan_inputs(torch.from_numpy(clip), torch.from_numpy(valid), width,
                      height).adj.numpy().astype(np.float64)
    ys, xs = np.nonzero(where)
    a = adj[tri_id[ys, xs]]  # (n, 3 edges, 3)
    lam = a[:, :, 0] * (xs[:, None] + 0.5) + a[:, :, 1] * (ys[:, None] + 0.5) + a[:, :, 2]
    return (lam / lam.sum(axis=1, keepdims=True)).T


def identity(tri_id, instance, tri_idx):
    safe = np.maximum(tri_id, 0)
    return np.where(tri_id >= 0, instance[safe].astype(np.int64) * (1 << 32) + tri_idx[safe], -1)


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["boxes", "mixed"])
def test_count_bounded_scan_matches_jax(kind, size, count):
    w, h = size
    (clip, valid, instance, tri_idx), live = soup(kind, w, h)
    c = count_of(count, live)
    got = rasterize_scan(torch.from_numpy(clip), torch.from_numpy(valid), w, h,
                         count=torch.tensor(c, dtype=torch.int32))
    want = jax_rasterize(jnp.asarray(clip), jnp.asarray(valid), w, h, count=jnp.int32(c))
    depth, tri_id, bary = (t.numpy() for t in got)
    jdepth, jtri_id, jbary = (np.asarray(t) for t in want)
    ident, jident = identity(tri_id, instance, tri_idx), identity(jtri_id, instance, tri_idx)
    same = ident == jident
    assert same.mean() >= SAME_SHARE, same.mean()
    np.testing.assert_allclose(depth[same], jdepth[same], rtol=0, atol=DEPTH_TOL)
    np.testing.assert_allclose(bary[:, same], jbary[:, same], rtol=0, atol=BARY_JAX_TOL)
    hit = same & (tri_id >= 0)
    exact = bary_f64(clip, valid, w, h, tri_id, hit)
    err, jerr = np.abs(bary[:, hit] - exact), np.abs(jbary[:, hit] - exact)
    if err.size:
        assert err.max() <= BARY_F64_TOL and err.mean() <= BARY_F64_MEAN, err.max()
        assert err.max() <= jerr.max() and err.mean() <= jerr.mean()
    covered = int((tri_id >= 0).sum())
    walked = min(math.ceil(c / 128) * 128, CAPACITY)
    if walked == 0:
        assert covered == 0 and (depth == 1.0).all() and not bary.any()
    else:
        assert covered > 0
        assert tri_id.max() < walked  # no triangle of a block past the count
    if c < live and walked < live:  # the cut leaves live triangles unwalked
        full = rasterize_scan(torch.from_numpy(clip), torch.from_numpy(valid), w, h)
        assert not np.array_equal(full.tri_id.numpy(), tri_id)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["boxes", "mixed"])
def test_bounded_equals_unbounded_on_compacted_soups(kind, size):
    w, h = size
    (clip, valid, _, _), live = soup(kind, w, h)
    c_, v_ = torch.from_numpy(clip), torch.from_numpy(valid)
    full = rasterize_scan(c_, v_, w, h)
    bounded = rasterize_scan(c_, v_, w, h, count=torch.tensor(live, dtype=torch.int32))
    for a, b in zip(bounded, full):
        assert torch.equal(a, b)
    # a count walks whole blocks: the same as the soup cut after them
    for c in (1, 129):
        walked = math.ceil(c / 128) * 128
        cut = rasterize_scan(c_, v_ & (torch.arange(len(valid)) < walked), w, h)
        got = rasterize_scan(c_, v_, w, h, count=c)
        for a, b in zip(got, cut):
            assert torch.equal(a, b)
        assert int((cut.tri_id >= c).sum()) > 0  # a triangle past the count is drawn
