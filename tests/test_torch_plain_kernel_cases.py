"""The plain configuration's kernel edge cases (tests/torch_plain_kernel_cases.py)
through the port's plain versions on the CPU, against the JAX package:
``rasterize_scan(..., count=)`` against ``renderer_tpu.ops.raster_jax.rasterize(...,
count=)`` and ``ray_shadow_directional`` against ``renderer_tpu.ops.rt``'s.
The card tests (tests/test_torch_kernels.py) hold the kernels to these plain
versions bit for bit on the same cases.

Gates, with their reasons (those of test_torch_scan_count.py and
test_torch_rt_brute.py):
- the visible triangle equal on >= 99.9% of pixels and depth within 2e-4
  where it is: a pixel centre within rounding of an edge may flip, as XLA
  may fuse the edge functions' multiply-adds where the port rounds each
  product;
- on the tie case, the lowest id of each set of copies at one depth wins
  every pixel one of them wins, in both;
- lit planes equal but on at most 0.2% of the receivers (JAX sums the
  three-term dots in its dot product, the port left to right); count 0
  leaves every receiver lit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderer_tpu.ops import rt as jrt
from renderer_tpu.ops.raster_jax import rasterize as jax_rasterize
from renderer_tpu_torch.ops import rt as trt
from renderer_tpu_torch.ops.raster_scan import rasterize_scan
from torch_plain_kernel_cases import BRUTE_CASES, RASTER_CASES, TIE_IDS

SAME_SHARE = 0.999
DEPTH_TOL = 2e-4
FLIP_SHARE = 0.002


@pytest.mark.parametrize("case,count", [(c, n) for c, spec in RASTER_CASES.items()
                                        for n in spec[4]])
def test_scan_case_matches_jax(case, count):
    build, w, h, cull, _ = RASTER_CASES[case]
    clip, valid = build()
    got = rasterize_scan(torch.from_numpy(clip), torch.from_numpy(valid), w, h,
                         cull_backface=cull, count=torch.tensor(count, dtype=torch.int32))
    want = jax_rasterize(jnp.asarray(clip), jnp.asarray(valid), w, h, cull_backface=cull,
                         count=jnp.int32(count))
    depth, tri_id = got.depth.numpy(), got.tri_id.numpy()
    jdepth, jtri_id = np.asarray(want.depth), np.asarray(want.tri_id)
    same = tri_id == jtri_id
    assert same.mean() >= SAME_SHARE, same.mean()
    np.testing.assert_allclose(depth[same], jdepth[same], rtol=0, atol=DEPTH_TOL)
    walked = min(-(-count // min(128, len(valid))) * min(128, len(valid)), len(valid))
    assert tri_id.max() < walked if walked else (tri_id == -1).all()
    if case == "ties":
        for copies in TIE_IDS:
            for ids in (tri_id, jtri_id):
                won = np.isin(ids, copies)
                walked_copies = [i for i in copies if i < walked]
                if walked_copies:
                    assert (ids[won] == walked_copies[0]).all()
                    assert won.any()


@pytest.mark.parametrize("case,count", [(c, n) for c, spec in BRUTE_CASES.items()
                                        for n in spec[1]])
def test_brute_case_matches_jax(case, count):
    world, normal, direction, tri, valid = BRUTE_CASES[case][0]()
    args = [torch.from_numpy(a) for a in (world, normal, direction, tri, valid)]
    got = trt.ray_shadow_directional(*args, count=torch.tensor(count, dtype=torch.int32)).numpy()
    want = np.asarray(jrt.ray_shadow_directional(
        *(jnp.asarray(a) for a in (world, normal, direction, tri, valid)), jnp.int32(count)))
    assert got.shape == want.shape == (1,) + world.shape[1:]
    assert float((got != want).mean()) <= FLIP_SHARE
    if count == 0:
        assert (got == 1).all()
    elif case == "occluded_and_lit" and count >= 2:
        # the quad's shade: the floor's columns under x < -0.5 occluded
        # (but within rounding of its diagonal), those beyond it lit
        assert (got[0][:, world[0, 0] < -0.6] == 0).mean() > 0.99
        assert (got[0][:, world[0, 0] > -0.4] == 1).all()
