"""The port's rasterizer (renderer_tpu_torch/ops/raster_cuda.py) on the CPU,
against the JAX package's rasterizers and the float64 numpy reference.

On the CPU ``rasterize_cuda`` runs the kernel's plain PyTorch version; the
CUDA kernel is held to the plain version bit for bit in
tests/test_torch_kernels.py (on the card) and by chip_smoke.py.

Gates against the JAX float32 rasterizers (``raster_jax.rasterize``, the
oracle of tests/test_raster_pallas.py, on every case; the Pallas kernel in
interpret mode on two small cases), as tests/test_raster_pallas.py states
them: tri_id exact, depth within 1e-5, barycentrics within 2e-3 (they
diverge most on sliver edges). The float64-reference gate is
``torch_raster_gate.reference_gate``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from renderer_tpu.ops.raster_jax import rasterize
from renderer_tpu.ops.raster_pallas import rasterize_pallas
from renderer_tpu.ops.raster_spec import NO_TRIANGLE
from renderer_tpu.ops.raster_ref import rasterize_ref
from renderer_tpu_torch.ops.raster_cuda import raster_inputs, rasterize_cuda
from torch_raster_cases import CASES, random_soup
from torch_raster_gate import BARY_ATOL, DEPTH_ATOL, reference_gate


def port_raster(clip, valid, w, h, cull, with_bary=True):
    return rasterize_cuda(torch.from_numpy(clip), torch.from_numpy(valid), w, h,
                          cull_backface=cull, with_bary=with_bary)


def check_vs_jax(got, want):
    got_id, want_id = got.tri_id.numpy(), np.asarray(want.tri_id)
    assert (got_id == want_id).all(), f"tri_id differs on {(got_id != want_id).sum()} pixels"
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), atol=DEPTH_ATOL)
    np.testing.assert_allclose(got.bary.numpy(), np.asarray(want.bary), atol=BARY_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_raster_matches_jax_and_reference(case):
    build, w, h, cull = CASES[case]
    clip, valid = build()
    got = port_raster(clip, valid, w, h, cull)
    check_vs_jax(got, rasterize(jnp.asarray(clip), jnp.asarray(valid), w, h, cull_backface=cull))
    reference_gate(got.tri_id.numpy(), got.depth.numpy(), got.bary.numpy(),
                   clip, valid, w, h, cull)
    ids = got.tri_id.numpy()
    if case == "empty":
        assert (ids == NO_TRIANGLE).all() and (got.depth.numpy() == 1.0).all()
    elif case in ("box", "sphere_torus"):
        assert (ids != NO_TRIANGLE).sum() > 100
    elif case == "tile_aligned":  # nothing dropped at tile seams
        assert set(np.unique(ids)) - {NO_TRIANGLE} == set(range(7))


@pytest.mark.parametrize("case", ["sphere_torus", "random_two_sided"])
def test_plain_raster_matches_pallas(case):
    build, w, h, cull = CASES[case]
    clip, valid = build()
    with_bary = case == "sphere_torus"
    got = port_raster(clip, valid, w, h, cull, with_bary=with_bary)
    check_vs_jax(got, rasterize_pallas(jnp.asarray(clip), jnp.asarray(valid), w, h,
                                       cull_backface=cull, interpret=True,
                                       with_bary=with_bary))


def test_row_band_matches_full_image():
    """y0/full_height render a row band of a taller image exactly."""
    clip, valid = CASES["sphere_torus"][0]()
    c, v = torch.from_numpy(clip), torch.from_numpy(valid)
    full = rasterize_cuda(c, v, 128, 64)
    top = rasterize_cuda(c, v, 128, 32, y0=0, full_height=64)
    bot = rasterize_cuda(c, v, 128, 32, y0=32, full_height=64)
    assert torch.equal(full.tri_id, torch.cat([top.tri_id, bot.tri_id]))
    assert torch.equal(full.depth, torch.cat([top.depth, bot.depth]))


def test_bins_are_conservative_and_ascending():
    """Every triangle that covers a pixel has its bit set in that pixel's
    tile mask, and bin lists hold exactly the nonzero blocks, ascending."""
    clip, valid = random_soup(5)
    _, masks, lists, counts, *_ = raster_inputs(
        torch.from_numpy(clip), torch.from_numpy(valid), 256, 64
    )
    nz = (masks != 0).numpy()
    for tile in range(masks.shape[0]):
        want = np.nonzero(nz[tile])[0]
        assert counts[tile] == len(want)
        assert (lists[tile, : len(want)].numpy() == want).all()
    t = len(clip)
    ref = rasterize_ref(clip.reshape(-1, 4), np.arange(3 * t).reshape(t, 3), 256, 64,
                        tri_valid=valid)
    for y, x in zip(*np.nonzero(ref.tri_id >= 0)):
        tri = int(ref.tri_id[y, x])
        word = int(masks[(y // 16) * 4 + x // 64, tri // 64])
        assert (word >> (tri % 64)) & 1


@pytest.mark.parametrize("case", ["tile_aligned", "hot_tile"])
def test_raster_work_counts(case):
    """chip_smoke's count of the raster kernel's work (the mask bits per
    tile, the triangles whose padded bbox reaches each region's pixel-centre
    box, the (pixel, triangle) pairs inside the bbox and the listed
    triangles, which set its bound) against a count triangle by triangle."""
    import chip_smoke

    build, w, h, cull = CASES[case]
    clip, valid = build()
    args = raster_inputs(torch.from_numpy(clip), torch.from_numpy(valid), w, h, cull)
    bits, regions, pixel_pairs, listed = chip_smoke.raster_work(args)
    rec, masks = args[0].numpy().astype(np.float64), args[1].numpy()
    n_tx = w // 64
    want_pairs, want_bits, want_listed = 0, np.zeros(len(masks), np.int64), set()
    want_regions = {s: np.zeros((len(masks), 16 // s[1], 64 // s[0]), np.int64) for s in regions}
    for tile in range(len(masks)):
        xs = (tile % n_tx) * 64 + np.arange(64) + 0.5
        ys = (tile // n_tx) * 16 + np.arange(16) + 0.5
        for tri in range(len(rec)):
            if not (int(masks[tile, tri // 64]) >> (tri % 64)) & 1:
                continue
            xmin, xmax, ymin, ymax = rec[tri, 15:19]
            in_x, in_y = (xs >= xmin) & (xs <= xmax), (ys >= ymin) & (ys <= ymax)
            want_bits[tile] += 1
            want_listed.add(tri)
            want_pairs += int(in_x.sum()) * int(in_y.sum())
            for (rw, rh), count in want_regions.items():
                cx, cy = xs.reshape(-1, rw), ys.reshape(-1, rh)  # regions' centres
                reach_x = (xmin <= cx[:, -1]) & (xmax >= cx[:, 0])
                reach_y = (ymin <= cy[:, -1]) & (ymax >= cy[:, 0])
                count[tile] += reach_y[:, None] & reach_x[None, :]
    assert (bits.numpy() == want_bits).all()
    assert pixel_pairs == want_pairs > 0
    assert listed == len(want_listed)
    for shape, count in regions.items():
        assert (count.numpy() == want_regions[shape].reshape(-1)).all(), shape


def test_only_cpu_tensors_take_the_plain_path(monkeypatch):
    """Dispatch is by device: CPU -> plain version, CUDA -> kernel, any
    other device raises; nothing falls back to the plain version."""
    import renderer_tpu_torch.ops.raster_cuda as rc

    def no_plain(*args):
        raise AssertionError("plain version reached")

    monkeypatch.setattr(rc, "raster_tiles_plain", no_plain)
    clip, valid = CASES["box"][0]()
    with pytest.raises(ValueError, match="no rasterizer"):
        rc.rasterize_cuda(torch.from_numpy(clip).to("meta"),
                          torch.from_numpy(valid).to("meta"), 128, 64)
