"""render_call_ms: the host clock around each ``Renderer.render`` call
(copy-in, replay launch, copy-out) of the traced run's window, outside the
profiled stretch (the profiler slows every host call inside it), mean."""

import statistics

UNIT = "ms"


def read(run):
    t = run["trace"]
    return statistics.mean(t["render_call_ms"]) if t and t.get("render_call_ms") else None
