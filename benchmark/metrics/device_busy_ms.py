"""device_busy_ms: the union of the device's activity over the traced
stretch, per replayed frame."""

UNIT = "ms"


def read(run):
    t = run["trace"]
    if not t or not t.get("busy_s"):
        return None
    return t["busy_s"] * 1e3 / t["stretch_frames"]
