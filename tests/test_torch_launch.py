"""The Python side of the kernels' launch path, on the CPU: the occlusion
kernel's scratch size and work split, the wrappers' routing and input
checks, which raise before anything is built or launched, and
``cuda_build``'s registry of libraries and kernels under the kernel
reloader (a reloaded module keeps its objects; on the card, an edited
source rebuilt into the same CudaKernel).
"""

import ctypes
import os
import time

import numpy as np
import pytest
import torch

from renderer_tpu_torch.models import box_scene
from renderer_tpu_torch.ops import cuda_build, probe_cuda
from renderer_tpu_torch.ops import occlusion_cuda as oc
from renderer_tpu_torch.ops import raster_cuda as rc
from renderer_tpu_torch.ops.rt_grid import occlusion_inputs
from renderer_tpu_torch.passes.pipeline import PipelineConfig
from renderer_tpu_torch.runtime import KernelReloader, Renderer
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


def edit(path, text):
    time.sleep(0.01)
    path.write_text(text)
    os.utime(path)  # the mtime moves even on a coarse filesystem


def test_reload_of_a_kernel_module_keeps_its_kernel_objects():
    held = (probe_cuda.LIBRARY, probe_cuda.ADD_ONE, probe_cuda.TRANSPOSE)
    kernels = list(probe_cuda.LIBRARY.kernels)
    r = Renderer(box_scene(device="cpu"), PipelineConfig(width=64, height=64, tri_capacity=256))
    reloader = KernelReloader(r, rebuild=lambda: r.plan_builder, modules=[probe_cuda.__name__],
                              sources=[])
    path = probe_cuda.__file__
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 1.0))  # contents unchanged
    try:
        assert reloader.poll() is True and reloader.stats == {"reloads": 1, "failures": 0}
    finally:
        os.utime(path, (st.st_atime, st.st_mtime))
    assert all(a is b for a, b in zip((probe_cuda.LIBRARY, probe_cuda.ADD_ONE,
                                       probe_cuda.TRANSPOSE), held))
    assert cuda_build.LIBRARIES[os.path.abspath(probe_cuda.LIBRARY.source)] is held[0]
    assert held[0].kernels == kernels and held[1] in kernels and held[2] in kernels


@pytest.mark.gpu
def test_reload_swaps_an_edited_kernel_source(tmp_path, monkeypatch):
    """On the card: a copy of probe.cu built and launched, then edited so
    add_one adds 2: poll() rebuilds it and the same CudaKernel object
    launches the new code; a broken edit keeps it and counts a failure."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    text = open(os.path.join(cuda_build.CSRC, "probe.cu")).read()
    body = "__fadd_rn(x[i], 1.0f)"
    assert body in text
    source = tmp_path / "probe_copy.cu"
    source.write_text(text)
    monkeypatch.setattr(cuda_build, "LIBRARIES", {})
    lib = cuda_build.library(str(source))
    kernel = lib.kernel("rtt_add_one", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
    x = torch.arange(1024, dtype=torch.float32, device="cuda")

    def add():
        y = torch.empty_like(x)
        kernel.launch(x.get_device(), x.data_ptr(), y.data_ptr(), x.numel())
        return y

    assert torch.equal(add(), x + 1)
    first = lib.path
    r = Renderer(box_scene(device="cpu"), PipelineConfig(width=64, height=64, tri_capacity=256))
    reloader = KernelReloader(r, modules=[], sources=[str(source)])
    edit(source, text.replace(body, "__fadd_rn(x[i], 2.0f)"))
    assert reloader.poll() is True, reloader.last_error
    assert reloader.stats == {"reloads": 1, "failures": 0}
    assert lib.kernels == [kernel] and kernel.library is lib and lib.path != first
    assert torch.equal(add(), x + 2)
    edit(source, text.replace(body, "__fadd_rn(x[i], 2.0f"))  # does not compile
    assert reloader.poll() is False
    assert reloader.stats == {"reloads": 1, "failures": 1}
    assert "nvcc failed" in reloader.last_error
    assert torch.equal(add(), x + 2) and kernel.launches == 3
