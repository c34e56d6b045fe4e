"""Two kernels on no path of the renderer (``csrc/probe.cu``): ``add_one``,
the counterpart of the TPU compile-service probe in
``tests/test_tpu_hw.py``, and a shared-memory tiled ``transpose`` (E, k) ->
(k, E), the counterpart of ``scripts/prof_phasea.py``'s
``pallas_transpose``. Each takes its plain version for CPU tensors and its
kernel for CUDA tensors, and counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from renderer_tpu_torch.ops.cuda_build import CudaLibrary

LIBRARY = CudaLibrary("probe.cu")


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name} kernel input: want a contiguous 2D float32 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


class ProbeKernels:
    """Launches the kernels of ``csrc/probe.cu``; ``launches`` counts them
    by name."""

    def __init__(self):
        self.launches = {"add_one": 0, "transpose": 0}
        self._fns = {}

    @property
    def build_log(self) -> str:
        return LIBRARY.build_log

    def load(self):
        if not self._fns:
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            self._fns = {
                "add_one": LIBRARY.function("rtt_add_one", [ptr, ptr, i32, ptr]),
                "transpose": LIBRARY.function("rtt_transpose", [ptr, ptr, i32, i32, ptr]),
            }
        return self._fns

    def _launch(self, name, *args):
        rc = self.load()[name](*args)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
        self.launches[name] += 1

    def add_one(self, x: torch.Tensor) -> torch.Tensor:
        _check(x, "add_one")
        y = torch.empty_like(x)
        self._launch("add_one", x.data_ptr(), y.data_ptr(), x.numel(),
                     torch.cuda.current_stream(x.device).cuda_stream)
        return y

    def transpose(self, x: torch.Tensor) -> torch.Tensor:
        _check(x, "transpose")
        rows, cols = x.shape
        y = torch.empty((cols, rows), dtype=x.dtype, device=x.device)
        self._launch("transpose", x.data_ptr(), y.data_ptr(), rows, cols,
                     torch.cuda.current_stream(x.device).cuda_stream)
        return y


probe_kernels = ProbeKernels()


def _route(x: torch.Tensor, kernel, plain):
    if x.device.type == "cuda":
        return kernel(x)
    if x.device.type == "cpu":
        return plain(x)
    raise ValueError(f"no kernel for device {x.device}")


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1."""
    return _route(x, probe_kernels.add_one, add_one_plain)


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(E, k) -> (k, E), contiguous."""
    return _route(x, probe_kernels.transpose, transpose_plain)
