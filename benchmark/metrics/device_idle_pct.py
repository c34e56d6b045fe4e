"""device_idle_pct: 100 x (1 - the union of the device's activity / the
wall time) over the traced stretch of replayed frames. The stretch's wall
holds what the profiler costs the host's launches, so this is the idle
share of traced frames: at most, never below, that of untraced ones."""

UNIT = "%"


def read(run):
    t = run["trace"]
    if not t or not t.get("busy_s") or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
