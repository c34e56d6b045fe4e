"""Morton keys for the draw-stream sort (``renderer_tpu.ops.cull``)."""

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
