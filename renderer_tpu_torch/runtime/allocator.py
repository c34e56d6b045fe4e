"""The host staging arena (``renderer_tpu.runtime.allocator``): ctypes
bindings over the JAX package's ``renderer_tpu/native/arena.cc``, compiled
by path with g++ (``utils.native``).

``Arena`` hands out numpy arrays viewing one contiguous host block (zero
copy: a staged upload reads straight from it), best-fit with coalescing
frees, and ``stats()`` feeds the HUD. For a CUDA device the block is
page-locked once, at creation, with ``cudaHostRegister``, and unregistered
in ``close()``: a copy from it to the card is asynchronous (a copy from
pageable memory waits for the work queued on the stream), and tensors over
it report ``is_pinned()``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from renderer_tpu_torch.device import resolve_device
from renderer_tpu_torch.utils.native import NATIVE_DIR, load_shared

_lock = threading.Lock()
_lib = None


class ArenaStats(ctypes.Structure):
    _fields_ = [
        ("capacity", ctypes.c_uint64),
        ("used", ctypes.c_uint64),
        ("free_bytes", ctypes.c_uint64),
        ("peak_used", ctypes.c_uint64),
        ("live_allocs", ctypes.c_uint64),
        ("total_allocs", ctypes.c_uint64),
        ("failed_allocs", ctypes.c_uint64),
        ("largest_free_block", ctypes.c_uint64),
        ("free_block_count", ctypes.c_uint64),
    ]

    def as_dict(self) -> dict:
        return {name: getattr(self, name) for name, _ in self._fields_}


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = load_shared(os.path.join(NATIVE_DIR, "arena.cc"))
            lib.rtpu_arena_create.restype = ctypes.c_void_p
            lib.rtpu_arena_create.argtypes = [ctypes.c_uint64]
            lib.rtpu_arena_destroy.argtypes = [ctypes.c_void_p]
            lib.rtpu_arena_alloc.restype = ctypes.c_void_p
            lib.rtpu_arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
            lib.rtpu_arena_free.restype = ctypes.c_int
            lib.rtpu_arena_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.rtpu_arena_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ArenaStats)]
            _lib = lib
        return _lib


def _check(rc, what: str) -> None:
    if int(rc) != 0:
        raise RuntimeError(f"{what} failed: cudaError {int(rc)} "
                           f"({torch.cuda.cudart().cudaGetErrorString(rc)})")


class Arena:
    """A host staging arena of ``capacity`` bytes for uploads to ``device``
    (the CUDA card when None; page-locked there). Allocations come back as
    numpy arrays viewing arena memory; ``free()`` returns them to the
    pool."""

    def __init__(self, capacity: int, device=None):
        self.device = resolve_device(device)
        self._lib = _load()
        self._handle = self._lib.rtpu_arena_create(capacity)
        if not self._handle:
            raise MemoryError(f"failed to create arena of {capacity} bytes")
        self.capacity = capacity
        self._live: dict[int, int] = {}  # ptr -> nbytes
        # the block: arena.cc's Arena keeps its base pointer as its first
        # member, 64-byte aligned, capacity rounded up to 64 bytes
        self._base = ctypes.c_void_p.from_address(self._handle).value
        self._span = -(-capacity // 64) * 64
        self.pinned = False
        if self.device.type == "cuda":
            _check(torch.cuda.cudart().cudaHostRegister(self._base, self._span, 0),
                   "cudaHostRegister of the staging arena")
            self.pinned = True

    def alloc(self, shape, dtype=np.uint8, align: int = 64) -> np.ndarray:
        dtype = np.dtype(dtype)
        count = int(np.prod(shape))
        nbytes = count * dtype.itemsize
        ptr = self._lib.rtpu_arena_alloc(self._handle, max(nbytes, 1), align)
        if not ptr:
            raise MemoryError(f"arena alloc of {nbytes} bytes failed (stats: {self.stats()})")
        if not self._base <= ptr <= self._base + self._span - max(nbytes, 1):
            raise RuntimeError("arena block outside the arena's base and capacity")
        buf = (ctypes.c_uint8 * max(nbytes, 1)).from_address(ptr)
        arr = np.frombuffer(buf, dtype=dtype, count=count).reshape(shape)
        self._live[ptr] = nbytes
        return arr

    def free(self, arr: np.ndarray) -> None:
        """Return ``arr`` (the array ``alloc`` gave, not a view) to the pool."""
        ptr = arr.ctypes.data
        if ptr not in self._live:
            raise ValueError("array was not allocated from this arena")
        if self._lib.rtpu_arena_free(self._handle, ctypes.c_void_p(ptr)) != 0:
            raise ValueError("native free failed (double free?)")
        del self._live[ptr]

    def stats(self) -> dict:
        s = ArenaStats()
        self._lib.rtpu_arena_stats(self._handle, ctypes.byref(s))
        return s.as_dict()

    def close(self) -> None:
        """Unregister and release the block. Nothing may still read it: a
        streamer's ``close()`` waits for its copies first."""
        if self._handle:
            if self.pinned:
                _check(torch.cuda.cudart().cudaHostUnregister(self._base),
                       "cudaHostUnregister of the staging arena")
                self.pinned = False
            self._lib.rtpu_arena_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: nothing left to report to
            pass
