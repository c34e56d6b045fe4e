"""frame_p95_ms: the 95th percentile, over every frame of the window, of
the interval before the frame's completion (from the previous frame's
completion; the first frame's from the window's start)."""

from benchmark.harness.timing import percentile

UNIT = "ms"


def read(run):
    return percentile(run["intervals_ms"], 95.0) if run["intervals_ms"] else None
