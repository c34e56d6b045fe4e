"""Frozen copy of the port's ``renderer_tpu_torch/ops/cull.py`` (the benchmark's plain
reference; it imports nothing of the port, and the port may change
without it). What follows is the original's docstring.

Draw-stream compaction and the Morton keys of its sort
(``renderer_tpu.ops.cull``)."""

from __future__ import annotations

import torch

# key of culled/invalid slots: sorts after every 20-bit Morton code
INVALID_KEY = 0xFFFFFFFF


def _morton2d(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Interleave the bits of x and y (each < 2^10) -> int64 Morton code."""

    def spread(v):
        v = v.to(torch.int64)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(x) | (spread(y) << 1)


def scatter_kept(dest: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """Rows of x to rows ``dest`` of an (n, ...) zero tensor; rows whose
    ``dest`` is n are dropped (they land in a trash row past the end)."""
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[dest] = x
    return out[:n]

