"""The plain reference against the port at a tiny size on the CPU: the
raster bit for bit with the port's kernel-1 semantics (its plain version),
and whole frames of each cell through the harness, every compared number
0. The test imports both sides; the reference itself imports nothing of
the port."""

import pytest
import torch

from benchmark.harness import cell
from benchmark.reference import raster as ref_raster
from benchmark.tests.tiny import tiny


def _soup(n, seed, behind=False):
    g = torch.Generator().manual_seed(seed)
    clip = torch.rand((n, 3, 4), generator=g) * 2.4 - 1.2
    clip[..., 3] = 1.0 + torch.rand((n, 3), generator=g)  # w in [1, 2)
    clip[..., 2] = torch.rand((n, 3), generator=g) * clip[..., 3]
    clip[..., :2] *= clip[..., 3:4]
    if behind:  # corners behind the eye: whole-screen boxes, per-pixel w test
        clip[::5, 0, 3] = -0.5
    valid = torch.rand((n,), generator=g) < 0.9
    return clip, valid


@pytest.mark.parametrize("cull_backface", [True, False])
@pytest.mark.parametrize("behind", [False, True])
def test_raster_equals_the_ports_plain_kernel(cull_backface, behind):
    from renderer_tpu_torch.ops.raster_cuda import rasterize_cuda

    torch.set_num_threads(2)
    clip, valid = _soup(256, 3 + behind, behind)
    want = rasterize_cuda(clip, valid, 128, 64, cull_backface=cull_backface, with_bary=False)
    got = ref_raster.rasterize(clip, valid, 128, 64, cull_backface=cull_backface, band_rows=16)
    assert torch.equal(got.tri_id, want.tri_id)
    assert torch.equal(got.depth, want.depth)
    assert (got.tri_id >= 0).float().mean() > 0.5


def _run(cell_name, seed, override=tiny, **kw):
    torch.set_num_threads(2)
    return cell.run(cell_name, seed, 0.5, False, 0.0, device="cpu", override=override, **kw)


@pytest.mark.parametrize("cell_name", ["sponza10k.orbit_mover", "envelope16x4096.light_orbit"])
def test_a_tiny_run_is_correct(cell_name):
    line, table = _run(cell_name, 2**31 + 11)
    assert line["correct"] is True and line["failed"] == 0
    assert all(row["value"] == 0.0 for row in table.values()), table
    assert list(line)[-1] == "checks" and list(line)[:5] == [
        "correct", "attempted", "failed", "metrics", "device"]
    # untraced, on the CPU: the host-clock metrics (no card, so no peak memory)
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
