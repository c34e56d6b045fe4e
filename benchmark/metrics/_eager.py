"""Shared by the per-pass readers: a pass's device ms per eager frame, or
None where the trace holds no device time for it (a run without a card)."""


def pass_ms(run, name):
    t = run["trace"]
    if not t or t.get("device_kind") != "cuda":
        return None
    v = t.get("pass_ms", {}).get(name)
    return v if v else None
