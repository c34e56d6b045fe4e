"""The Python side of the kernels' launch path, on the CPU: the occlusion
kernel's scratch size and work split, and the wrappers' routing and input
checks, which raise before anything is built or launched.
"""

import ctypes

import numpy as np
import pytest
import torch

from renderer_tpu_torch.ops import cuda_build, probe_cuda
from renderer_tpu_torch.ops import occlusion_cuda as oc
from renderer_tpu_torch.ops import raster_cuda as rc
from renderer_tpu_torch.ops.rt_grid import occlusion_inputs
from torch_occlusion_cases import CASES


def test_scratch_bytes_and_segments():
    # counters + bbox side copy + tile order (even count) + items
    assert oc.scratch_bytes(510, 2048, 32) == 16 + 16 * 2048 * 64 + 4 * 510 + 8 * 510 * 64
    assert oc.scratch_bytes(3, 1, 1) == 16 + 16 * 64 + 4 * 4 + 8 * 3
    assert oc.scratch_bytes(2, 5, 2) == 16 + 16 * 5 * 64 + 4 * 2 + 8 * 2 * 3
    counts = torch.tensor([0, 1, 31, 32, 33, 645], dtype=torch.int32)
    assert oc.segments(counts, 32).tolist() == [0, 1, 1, 1, 2, 21]
    assert oc.segments(counts, 1).tolist() == counts.tolist()
    # the items of every tile fit the scratch's item slots
    assert int(oc.segments(counts, 32).max()) <= -(-645 // 32)


@pytest.mark.parametrize("segment_blocks", [0, oc.SEGMENT_MAX + 1])
def test_occlusion_segment_length_is_checked(segment_blocks):
    args = occlusion_inputs(*(torch.from_numpy(a) for a in CASES["few_casters"]()))
    with pytest.raises(ValueError, match="segment_blocks"):
        oc.occlusion_kernel(*args, segment_blocks=segment_blocks)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper given CPU tensors raises; nothing is launched."""
    before = [k.launches for k in (oc.OCCLUSION_TILES, rc.RASTER_TILES)]
    args = occlusion_inputs(*(torch.from_numpy(a) for a in CASES["few_casters"]()))
    with pytest.raises(ValueError, match="CUDA device"):
        oc.occlusion_kernel(*args)
    clip = torch.zeros((64, 3, 4))
    r_args = rc.raster_inputs(clip, torch.zeros(64, dtype=torch.bool), 64, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        rc.raster_kernel(*r_args, True)
    assert [k.launches for k in (oc.OCCLUSION_TILES, rc.RASTER_TILES)] == before


def test_probe_wrappers_route_by_device():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(37, 5)).astype(np.float32))
    launches = (probe_cuda.ADD_ONE.launches, probe_cuda.TRANSPOSE.launches)
    assert torch.equal(probe_cuda.add_one(x), x + 1)
    assert torch.equal(probe_cuda.transpose(x), x.T.contiguous())
    assert (probe_cuda.ADD_ONE.launches, probe_cuda.TRANSPOSE.launches) == launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        probe_cuda.add_one(torch.empty((8, 128), device="meta"))


def test_check_inputs_names_what_it_wanted():
    with pytest.raises(ValueError, match=r"add_one kernel input: want a contiguous torch.float32 tensor"):
        cuda_build.check_inputs("add_one", (torch.zeros(3), torch.float32, None))
    with pytest.raises(ValueError, match=r"\(2, 4\)"):
        cuda_build.check_inputs("k", (torch.zeros(2, 4), torch.float32, (2, 4)))


def test_launcher_appends_the_stream_pointer():
    kernel = cuda_build.CudaKernel(probe_cuda.LIBRARY, "rtt_add_one", [ctypes.c_void_p, ctypes.c_int])
    assert kernel.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert kernel.launches == 0
    assert oc.OCCLUSION_TILES.argtypes[-1] is ctypes.c_void_p
