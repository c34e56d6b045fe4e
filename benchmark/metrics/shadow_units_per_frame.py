"""shadow_units_per_frame: atlas units re-rendered per frame over the
frames after the window, from the signatures in the renderer's
``state["shadow_cache"]``."""

import statistics

UNIT = "units/frame"


def read(run):
    t = run["trace"]
    return statistics.mean(t["units_per_frame"]) if t and t.get("units_per_frame") else None
