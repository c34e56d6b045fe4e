"""Readings from a ``torch.profiler`` trace, on plain records so that they
can be checked without a card.

``records(prof)`` turns the profiler's events into ``Rec`` tuples: device
activity (kernels, copies, memsets) and host events (PyTorch ops, CUDA
runtime and driver calls, ``record_function`` ranges), in microseconds on
the profiler's one clock.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple


class Rec(NamedTuple):
    device: bool      # device activity (True) or a host event
    name: str
    start: float      # us
    end: float        # us
    corr: int         # the event's id (a device event: its correlation id)
    linked: int       # a device event's linked correlation id (-1: none)
    thread: int


def records(prof) -> list:
    """The profiler's events as ``Rec`` tuples."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        dev = e.device_type == DeviceType.CUDA
        out.append(Rec(dev, e.name, float(e.time_range.start), float(e.time_range.end),
                       int(e.id), int(getattr(e, "linked_correlation_id", -1) or -1),
                       int(getattr(e, "thread", 0) or 0)))
    return out


def device_intervals(recs, t0: float = float("-inf"), t1: float = float("inf")) -> list:
    """Device activity clipped to [t0, t1], as (start, end) pairs; the
    ``forward.`` and ``bench.`` ranges PyTorch mirrors onto the device are
    left out."""
    out = []
    for r in recs:
        if r.device and not r.name.startswith(("forward.", "bench.")):
            s, e = max(r.start, t0), min(r.end, t1)
            if e > s:
                out.append((s, e))
    return out


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def union_length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def host_range(recs, name: str):
    """(start, end) of the host range ``name`` (its first occurrence)."""
    for r in recs:
        if not r.device and r.name == name:
            return r.start, r.end
    raise KeyError(f"no host range {name!r} in the trace")


NAME_CHARS = 120  # a kernel's name is cut to this many characters in a breakdown


def device_ops(recs, t0: float, t1: float, n: int = 10) -> list:
    """The n device operations that took most time in [t0, t1], summed by
    name: [[name, seconds], ...]."""
    by = {}
    for r in recs:
        if r.device and not r.name.startswith(("forward.", "bench.")):
            s, e = max(r.start, t0), min(r.end, t1)
            if e > s:
                name = r.name[:NAME_CHARS]
                by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(recs, t0: float, t1: float, n: int = 10) -> list:
    """The device's idle time in [t0, t1] by what the host was doing: each
    gap between device activity goes to the innermost host event that holds
    its midpoint ("host idle" if none), summed by that name; the n largest,
    [[name, seconds], ...]."""
    busy = union(device_intervals(recs, t0, t1))
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    host = sorted(((r.start, r.end, r.name) for r in recs if not r.device), key=lambda x: x[0])
    starts = [h[0] for h in host]
    by = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        best = None  # the latest-starting host event still open at mid: the innermost
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0 and best is None:
            if host[i][1] >= mid:
                best = host[i]
            i -= 1
        name = best[2] if best else "host idle"
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def pass_device_us(recs, kernel=None) -> dict:
    """Per pass, the device microseconds of the work its ``forward.<pass>``
    range launched (summed over the trace): a device event belongs to the
    pass whose range holds the host call that launched it, the CUDA runtime
    or driver call with the event's correlation id, else the PyTorch op it
    is linked to. ``kernel(name)`` keeps only the device events it accepts.
    Device work no range launched is under the key ``None``."""
    ranges = sorted((r.start, r.end, r.name[len("forward."):]) for r in recs
                    if not r.device and r.name.startswith("forward."))
    starts = [r[0] for r in ranges]
    runtime_at, op_at = {}, {}
    for r in recs:
        if not r.device and not r.name.startswith(("forward.", "bench.")):
            (runtime_at if r.name.startswith("cu") else op_at)[r.corr] = r.start
    out = {r[2]: 0.0 for r in ranges}
    out[None] = 0.0
    for r in recs:
        if not r.device or r.name.startswith(("forward.", "bench.")):
            continue
        if kernel is not None and not kernel(r.name):
            continue
        t = runtime_at.get(r.corr, op_at.get(r.linked))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        key = ranges[i][2] if i >= 0 and t <= ranges[i][1] else None
        out[key] = out.get(key, 0.0) + (r.end - r.start)
    return out
