"""shade_ms: the device time of the work the eager frame's
``forward.shade_shadowed`` range launched (ops/pbr.py, ops/texture.py,
ops/aa.py), per frame."""

from benchmark.metrics._eager import pass_ms

UNIT = "ms"


def read(run):
    return pass_ms(run, "shade_shadowed")
