"""LOD chains from the native grid-clustering simplifier
(``renderer_tpu.scene.simplify``).

The C++ source is the JAX package's ``renderer_tpu/native/meshproc.cc``,
shared by both packages: it is compiled by path with g++ at first use
(``utils.native``), so the port imports nothing of the JAX package. LOD
indices reference the original vertex pool.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from renderer_tpu_torch.utils.native import NATIVE_DIR, load_shared

_lock = threading.Lock()
_fn = None


def _load():
    global _fn
    with _lock:
        if _fn is None:
            fn = load_shared(os.path.join(NATIVE_DIR, "meshproc.cc")).rtpu_simplify_cluster
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ]
            _fn = fn
        return _fn


def simplify(positions: np.ndarray, indices: np.ndarray, grid_size: int) -> np.ndarray:
    """Cluster-simplify -> (T', 3) i32 indices into the ORIGINAL vertices.
    Smaller grid_size is coarser."""
    fn = _load()
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(indices, np.int32).reshape(-1, 3)
    out = np.empty_like(idx)
    out_t = ctypes.c_int64(0)
    rc = fn(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pos),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(idx),
        grid_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ctypes.byref(out_t),
    )
    if rc != 0:
        raise ValueError(f"simplify_cluster failed (rc={rc})")
    return out[: out_t.value].copy()


def build_lod_chain(positions, indices, levels: int = 3, base_grid: int = 16) -> list:
    """LOD1..LODn index arrays, halving the grid per level; a level that
    does not reduce the triangle count is skipped."""
    lods = []
    prev_count = len(indices)
    grid = base_grid
    while len(lods) < levels and grid >= 2:
        idx = simplify(positions, indices, grid)
        if 0 < len(idx) < prev_count:
            lods.append(idx)
            prev_count = len(idx)
        grid //= 2
    return lods
