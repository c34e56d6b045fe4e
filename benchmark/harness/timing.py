"""Window arithmetic: the frame time over the window and the percentile of
the intervals between consecutive frames' completions."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of ``values`` by linear
    interpolation between closest ranks (numpy's default, "linear")."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def frame_ms(wall_s: float, frames: int) -> float:
    """Milliseconds a frame: the window's wall time over the frames it
    completed."""
    if frames <= 0:
        raise ValueError("a window completes at least one frame")
    return wall_s * 1e3 / frames


def intervals_ms(start_ms: float, completions_ms) -> list:
    """The interval before each frame's completion: from the previous
    frame's completion, and for the first frame from the window's start
    (times in ms on one clock)."""
    out, prev = [], start_ms
    for t in completions_ms:
        out.append(t - prev)
        prev = t
    return out
