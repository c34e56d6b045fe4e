"""cull_ms: the device time of the work the eager frame's ``forward.cull``
range launched (ops/geometry.py, ops/cull.py), per frame."""

from benchmark.metrics._eager import pass_ms

UNIT = "ms"


def read(run):
    return pass_ms(run, "cull")
