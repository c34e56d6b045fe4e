"""frame_ms: the window's wall time, from the first frame's submission to
the last frame's completion, over the frames completed."""

from benchmark.harness.timing import frame_ms

UNIT = "ms"


def read(run):
    return frame_ms(run["wall_s"], run["frames"]) if run["frames"] else None
