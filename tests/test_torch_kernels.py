"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Free of jax (the reference gate uses the JAX package's numpy
rasterizer only), so it also runs on a machine without jax:

    python -m pytest tests/test_torch_kernels.py -m gpu -q

Without a CUDA device every test here skips. Gates: the raster kernel
equals the plain version bit for bit (tri_id, depth, barycentrics) on the
whole image and on a row band of it (y0, as the shadow atlas renders),
and on the hot-tile case with every other tile's bin list emptied, and
both pass the float64-reference gate of torch_raster_gate; two-sided and
depth-only at the shadow atlas's view shapes (512x512 slot, 512x32 band,
256x128 cube face); the occlusion
kernel's plane equals its plain version's on every occlusion case (the CPU
tests hold the plain version to JAX and a float64 brute force), at the
default segment length and at one-block segments, so segments of a tile
combine; add_one and the transpose equal x + 1 and x.T.contiguous(); the
kernels launch on the current stream, not on a stream seen before. The
count-bounded scan raster (kernel 5) equals its plain version bit for bit
(depth, tri_id, barycentrics) on every raster case, with and without the
backface cull, at counts 0, 1, 127, 128, 129, the capacity and none, and
the count-bounded brute-force rt (kernel 6) equals its plain version's
lit plane at counts 0, 1, 129, the live count and none, its receivers as
one row and as the image's rows. Both do on the edge cases of their
designs (tests/torch_plain_kernel_cases.py: ties across blocks, more hits
than a stage in one region, sizes off the regions and tiles, counts at
block and group edges, whole tiles occluded and lit, a cell past its
list's capacity), and inside a captured CUDA graph replayed after the
count changed.
"""

import numpy as np
import pytest
import torch

from renderer_tpu_torch.ops import control, probe_cuda
from renderer_tpu_torch.ops.occlusion_cuda import (OCCLUSION_TILES, SEGMENT_BLOCKS, occlusion_kernel,
                                                   occlusion_tiles_plain)
from renderer_tpu_torch.ops.raster_cuda import (TILE_H, TILE_W, raster_inputs, raster_kernel,
                                                raster_tiles_plain)
from renderer_tpu_torch.ops.raster_scan import (SCAN_RASTER, kernel_design, scan_inputs,
                                                scan_raster_kernel, scan_raster_plain)
from renderer_tpu_torch.ops.raster_spec import NO_TRIANGLE
from renderer_tpu_torch.ops.rt import RT_BRUTE, brute_inputs, rt_brute_kernel, rt_brute_plain
from renderer_tpu_torch.ops.rt_grid import occlusion_inputs
from torch_occlusion_cases import CASES as OCCLUSION_CASES
from torch_plain_kernel_cases import BRUTE_CASES, OVERFLOW_SIZE, RASTER_CASES, many_hits_soup
from torch_raster_cases import CASES, HOT_TILE, random_soup
from torch_raster_gate import reference_gate


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("with_bary", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_raster_kernel_matches_plain(case, with_bary, cuda_device):
    build, w, h, cull = CASES[case]
    clip, valid = build()
    c, v = torch.from_numpy(clip).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    args = raster_inputs(c, v, w, h, cull)
    got = raster_kernel(*args, with_bary)
    want = raster_tiles_plain(*args, with_bary)
    # a row band that starts off the image's tile and region rows
    y0, band_h = h // 4 + 4, h // 2
    band_args = raster_inputs(c, v, w, band_h, cull, y0=y0, full_height=h)
    band = raster_kernel(*band_args, with_bary)
    band_want = raster_tiles_plain(*band_args, with_bary)
    torch.cuda.synchronize()
    for name, g, p, bg, bp in zip(("depth", "tri_id", "b0", "b1"), got, want, band, band_want):
        assert torch.equal(g, p), name
        assert torch.equal(bg, bp), f"band {name}"
        assert torch.equal(bg, g[y0:y0 + band_h]), f"band {name} against the image"
    depth, tri_id, b0, b1 = (t.cpu().numpy() for t in got)
    bary = torch.stack([got[2], got[3], 1.0 - got[2] - got[3]]).cpu().numpy() * (tri_id >= 0)
    reference_gate(tri_id, depth, bary if with_bary else None, clip, valid, w, h, cull)


@pytest.mark.gpu
@pytest.mark.parametrize("with_bary", [True, False])
def test_raster_kernel_on_one_hot_tile(with_bary, cuda_device):
    """The hot-tile case with every bin list emptied but the pile's tile's:
    the other tiles render empty, the pile as in the whole image."""
    build, w, h, cull = CASES["hot_tile"]
    clip, valid = build()
    args = raster_inputs(torch.from_numpy(clip).to(cuda_device),
                         torch.from_numpy(valid).to(cuda_device), w, h, cull)
    count = torch.zeros_like(args[3])
    count[HOT_TILE] = args[3][HOT_TILE]
    one = (*args[:3], count, *args[4:])
    got = raster_kernel(*one, with_bary)
    want = raster_tiles_plain(*one, with_bary)
    whole = raster_kernel(*args, with_bary)
    torch.cuda.synchronize()
    for name, g, p in zip(("depth", "tri_id", "b0", "b1"), got, want):
        assert torch.equal(g, p), name
    ty, tx = divmod(HOT_TILE, w // TILE_W)
    rows, cols = slice(ty * TILE_H, (ty + 1) * TILE_H), slice(tx * TILE_W, (tx + 1) * TILE_W)
    assert torch.equal(got[1][rows, cols], whole[1][rows, cols])
    assert (got[1][rows, cols] >= 0).sum() > 500
    got[1][rows, cols] = NO_TRIANGLE
    assert (got[1] == NO_TRIANGLE).all()


ATLAS_SHAPES = {"slot": (512, 512), "band": (512, 32), "face": (256, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(ATLAS_SHAPES))
def test_raster_kernel_at_atlas_shapes(shape, cuda_device):
    """The shadow atlas's views: two-sided, depth only, 4096 casters."""
    w, h = ATLAS_SHAPES[shape]
    clip, valid = random_soup(11, 4096)
    args = raster_inputs(torch.from_numpy(clip).to(cuda_device),
                         torch.from_numpy(valid).to(cuda_device), w, h, cull_backface=False)
    got = raster_kernel(*args, False)
    want = raster_tiles_plain(*args, False)
    torch.cuda.synchronize()
    for name, g, p in zip(("depth", "tri_id", "b0", "b1"), got, want):
        assert torch.equal(g, p), name
    assert (got[1] >= 0).float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("segment_blocks", [SEGMENT_BLOCKS, 1])
@pytest.mark.parametrize("case", sorted(OCCLUSION_CASES))
def test_occlusion_kernel_matches_plain(case, segment_blocks, cuda_device):
    args = occlusion_inputs(*(torch.from_numpy(a).to(cuda_device) for a in OCCLUSION_CASES[case]()))
    before = OCCLUSION_TILES.launches
    got = occlusion_kernel(*args, segment_blocks=segment_blocks)
    want = occlusion_tiles_plain(*args)
    torch.cuda.synchronize()
    assert OCCLUSION_TILES.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 128), (262144, 36), (1000, 16), (37, 5)])
def test_probe_kernels_match_plain(shape, cuda_device):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).to(cuda_device)
    assert torch.equal(probe_cuda.transpose(x), x.T.contiguous())
    assert torch.equal(probe_cuda.add_one(x), x + 1)


SPIN_CYCLES = 50_000_000  # keeps a stream busy for some tens of milliseconds


@pytest.mark.gpu
def test_kernels_launch_on_the_current_stream(cuda_device):
    """Inside ``torch.cuda.stream(side)`` the inputs are written on the side
    stream behind a spin: a kernel launched on any other stream would read
    them before they are written."""
    x_new = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32))
    x_new = x_new.to(cuda_device)
    args = occlusion_inputs(*(torch.from_numpy(a).to(cuda_device)
                              for a in OCCLUSION_CASES["orthographic"]()))
    want_occ = occlusion_tiles_plain(*args)
    assert (want_occ == 0).any()
    build, w, h, cull = CASES["hot_tile"]
    r_args = raster_inputs(*(torch.from_numpy(a).to(cuda_device) for a in build()), w, h, cull)
    want_ras = raster_tiles_plain(*r_args, True)
    assert (want_ras[1] != NO_TRIANGLE).any()
    probe_cuda.add_one(x_new)  # built, and launched on the default stream
    occlusion_kernel(*args)
    raster_kernel(*r_args, True)
    x = torch.zeros_like(x_new)
    ld = torch.full_like(args[6], float("inf"))  # all lit until the copy lands
    count = torch.zeros_like(r_args[3])  # nothing listed until the copy lands
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(SPIN_CYCLES)
        x.copy_(x_new)
        ld.copy_(args[6])
        count.copy_(r_args[3])
        y = probe_cuda.add_one(x)
        occ = occlusion_kernel(*args[:6], ld)
        ras = raster_kernel(*r_args[:3], count, *r_args[4:], True)
    torch.cuda.synchronize()
    assert torch.equal(y, x_new + 1)
    assert torch.equal(occ, want_occ)
    for g, p in zip(ras, want_ras):
        assert torch.equal(g, p)


@pytest.mark.gpu
@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_raster_kernel_matches_plain(case, cull, cuda_device):
    build, w, h, _ = CASES[case]
    clip, valid = build()
    inp = scan_inputs(torch.from_numpy(clip).to(cuda_device),
                      torch.from_numpy(valid).to(cuda_device), w, h, cull)
    t_cap = clip.shape[0]
    tri_block = min(128, t_cap)
    for count in (0, 1, 127, 128, 129, t_cap, None):
        c = None if count is None else torch.tensor(count, dtype=torch.int32, device=cuda_device)
        for with_bary in (True, False):
            before = SCAN_RASTER.launches
            got = scan_raster_kernel(inp, c, w, h, tri_block, with_bary)
            want = scan_raster_plain(inp, count, w, h, tri_block, with_bary)
            torch.cuda.synchronize()
            assert SCAN_RASTER.launches == before + 1
            for name, g, p in zip(("depth", "tri_id", "bary"), got, want):
                assert torch.equal(g, p), (name, count, with_bary)
            if count == 0:
                assert (got.tri_id == NO_TRIANGLE).all()


def brute_case(seed: int, n_tri: int = 600, capacity: int = 768):
    """Receivers (3, 24, 40) over a slab, their normals, and a soup of
    ``capacity`` slots whose first ``n_tri`` hold triangles above them."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(-2, 2, (3, 24, 40)).astype(np.float32)
    world[1] *= 0.1
    normal = rng.normal(size=(3, 24, 40)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=0, keepdims=True)
    tri = np.zeros((capacity, 3, 3), np.float32)
    centres = rng.uniform(-2, 2, (n_tri, 1, 3)) * np.float32([1, 0.5, 1]) + np.float32([0, 1.5, 0])
    tri[:n_tri] = centres + rng.normal(scale=0.15, size=(n_tri, 3, 3))
    valid = np.zeros(capacity, bool)
    valid[:n_tri] = rng.random(n_tri) < 0.9
    return world, normal, tri, valid


@pytest.mark.gpu
def test_rt_brute_kernel_matches_plain(cuda_device):
    world, normal, tri, valid = brute_case(3)
    direction = np.float32([-0.3, -1.0, 0.5])
    inp = brute_inputs(*(torch.from_numpy(a).to(cuda_device)
                         for a in (world, normal, direction, tri, valid)))
    for count in (0, 1, 129, 600, None):
        c = None if count is None else torch.tensor(count, dtype=torch.int32, device=cuda_device)
        want = rt_brute_plain(inp, count)
        for width in (world.shape[1] * world.shape[2], world.shape[2]):  # one row, the image
            before = RT_BRUTE.launches
            got = rt_brute_kernel(inp, c, width)
            torch.cuda.synchronize()
            assert RT_BRUTE.launches == before + 1
            assert torch.equal(got, want), (count, width)
        if count == 0:
            assert (got == 1).all()
        elif count in (600, None):
            assert (got == 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_scan_raster_kernel_on_edge_cases(case, cuda_device):
    build, w, h, cull, counts = RASTER_CASES[case]
    clip, valid = build()
    inp = scan_inputs(torch.from_numpy(clip).to(cuda_device),
                      torch.from_numpy(valid).to(cuda_device), w, h, cull)
    tri_block = min(128, clip.shape[0])
    for count in (*counts, None):
        c = None if count is None else torch.tensor(count, dtype=torch.int32, device=cuda_device)
        for with_bary in (True, False):
            before = SCAN_RASTER.launches
            got = scan_raster_kernel(inp, c, w, h, tri_block, with_bary)
            want = scan_raster_plain(inp, count, w, h, tri_block, with_bary)
            torch.cuda.synchronize()
            assert SCAN_RASTER.launches == before + 1
            for name, g, p in zip(("depth", "tri_id", "bary"), got, want):
                assert torch.equal(g, p), (name, count, with_bary)


@pytest.mark.gpu
def test_scan_raster_kernel_past_a_cells_capacity(cuda_device):
    """A cell listing more triangles than its list holds is walked from the
    group boxes: the same planes."""
    w, h = OVERFLOW_SIZE
    clip, valid = many_hits_soup(w, h)
    inp = scan_inputs(torch.from_numpy(clip).to(cuda_device),
                      torch.from_numpy(valid).to(cuda_device), w, h, False)
    assert kernel_design(clip.shape[0], w, h)["cell_capacity"] < int(valid.sum())
    for count in (400, None):
        c = None if count is None else torch.tensor(count, dtype=torch.int32, device=cuda_device)
        got = scan_raster_kernel(inp, c, w, h, 128, True)
        want = scan_raster_plain(inp, count, w, h, 128, True)
        torch.cuda.synchronize()
        for name, g, p in zip(("depth", "tri_id", "bary"), got, want):
            assert torch.equal(g, p), (name, count)
        assert (got.tri_id >= 0).sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BRUTE_CASES))
def test_rt_brute_kernel_on_edge_cases(case, cuda_device):
    build, counts = BRUTE_CASES[case]
    world, normal, direction, tri, valid = build()
    inp = brute_inputs(*(torch.from_numpy(a).to(cuda_device)
                         for a in (world, normal, direction, tri, valid)))
    for count in (*counts, None):
        c = None if count is None else torch.tensor(count, dtype=torch.int32, device=cuda_device)
        want = rt_brute_plain(inp, count)
        for width in (world.shape[1] * world.shape[2], world.shape[2]):  # one row, the image
            before = RT_BRUTE.launches
            got = rt_brute_kernel(inp, c, width)
            torch.cuda.synchronize()
            assert RT_BRUTE.launches == before + 1
            assert torch.equal(got, want), (count, width)


@pytest.mark.gpu
def test_plain_kernels_follow_the_count_in_a_graph(cuda_device):
    """Kernels 5 and 6 captured once in a CUDA graph with their counts on
    the card; each replay after the counts change equals the plain
    versions at the new counts."""
    build, w, h, cull, counts = RASTER_CASES["ties"]
    inp = scan_inputs(*(torch.from_numpy(a).to(cuda_device) for a in build()), w, h, cull)
    world, normal, direction, tri, valid = BRUTE_CASES["odd_receivers"][0]()
    b_inp = brute_inputs(*(torch.from_numpy(a).to(cuda_device)
                           for a in (world, normal, direction, tri, valid)))
    c = torch.zeros((), dtype=torch.int32, device=cuda_device)
    cb = torch.zeros((), dtype=torch.int32, device=cuda_device)

    def calls():
        return (scan_raster_kernel(inp, c, w, h, 128, True),
                rt_brute_kernel(b_inp, cb, world.shape[2]))

    calls()  # built, and warmed up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=control.own_stream(cuda_device, "test")):
        vis, lit = calls()
    for n, nb in zip((384, 1, 134, 0, 262), (768, 0, 129, 1, 600)):
        c.fill_(n)
        cb.fill_(nb)
        graph.replay()
        torch.cuda.synchronize()
        for name, g, p in zip(("depth", "tri_id", "bary"), vis,
                              scan_raster_plain(inp, n, w, h, 128, True)):
            assert torch.equal(g, p), (name, n)
        assert torch.equal(lit, rt_brute_plain(b_inp, nb)), nb
    graph.reset()
