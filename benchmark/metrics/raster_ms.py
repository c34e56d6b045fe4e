"""raster_ms: the device time of the work the eager frame's
``forward.raster`` range launched (setup, binning, kernel 1 for the
camera view), per frame."""

from benchmark.metrics._eager import pass_ms

UNIT = "ms"


def read(run):
    return pass_ms(run, "raster")
