"""Two kernels on no path of the renderer (``csrc/probe.cu``): ``add_one``,
the counterpart of the TPU compile-service probe in
``tests/test_tpu_hw.py``, and a shared-memory tiled ``transpose`` (E, k) ->
(k, E), the counterpart of ``scripts/prof_phasea.py``'s
``pallas_transpose``. Each takes its plain version for CPU tensors and its
kernel for CUDA tensors; ``ADD_ONE.launches`` and ``TRANSPOSE.launches``
count the kernels' launches.
"""

from __future__ import annotations

import ctypes

import torch

from renderer_tpu_torch.ops.cuda_build import check_inputs, library

LIBRARY = library("probe.cu")
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
ADD_ONE = LIBRARY.kernel("rtt_add_one", [_PTR, _PTR, _I32])
TRANSPOSE = LIBRARY.kernel("rtt_transpose", [_PTR, _PTR, _I32, _I32])


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def transpose_plain(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()


def _plain(x: torch.Tensor, plain):
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return plain(x)


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 of a float32 tensor."""
    if not x.is_cuda:
        return _plain(x, add_one_plain)
    index = check_inputs("add_one", (x, torch.float32, None))
    y = torch.empty_like(x)
    ADD_ONE.launch(index, x.data_ptr(), y.data_ptr(), x.numel())
    return y


def transpose(x: torch.Tensor) -> torch.Tensor:
    """(E, k) -> (k, E), contiguous."""
    if not x.is_cuda:
        return _plain(x, transpose_plain)
    if x.dim() != 2:
        raise ValueError(f"transpose kernel input: want a 2D tensor, got {tuple(x.shape)}")
    index = check_inputs("transpose", (x, torch.float32, None))
    rows, cols = x.shape
    y = torch.empty((cols, rows), dtype=x.dtype, device=x.device)
    TRANSPOSE.launch(index, x.data_ptr(), y.data_ptr(), rows, cols)
    return y
