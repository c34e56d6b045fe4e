"""The trace readings on hand-made records: the device's busy union and
idle share, the idle gaps by host activity, per-pass device time by
correlation."""

import pytest

from benchmark.harness.trace import (
    Rec, device_intervals, device_ops, idle_gaps, pass_device_us, union, union_length,
)


def dev(name, s, e, corr=-1, linked=-1):
    return Rec(True, name, s, e, corr, linked, 0)


def host(name, s, e, corr=-1):
    return Rec(False, name, s, e, corr, -1, 0)


def test_union_counts_overlaps_once():
    assert union([(0, 10), (5, 12), (20, 30), (30, 31)]) == [(0, 12), (20, 31)]
    assert union_length([(0, 10), (5, 12), (20, 30), (2, 3)]) == 22


def test_busy_and_idle_share_over_a_window():
    recs = [dev("k1", 0, 40), dev("k2", 30, 60), dev("k3", 80, 100), dev("k4", 150, 250),
            dev("forward.cull", 0, 300)]  # a range mirrored on the device: not work
    busy = union_length(device_intervals(recs, 0.0, 200.0))
    assert busy == 60 + 20 + 50
    assert 100.0 * (1.0 - busy / 200.0) == pytest.approx(35.0)


def test_device_ops_sum_by_name():
    recs = [dev("a", 0, 10), dev("b", 10, 40), dev("a", 50, 80)]
    ops = device_ops(recs, 0, 100)
    assert [k for k, _ in ops] == ["a", "b"]
    assert [v for _, v in ops] == [pytest.approx(40e-6), pytest.approx(30e-6)]
    assert device_ops(recs, 0, 60, n=1) == [["b", pytest.approx(30e-6)]]


def test_idle_gaps_go_to_the_innermost_host_event():
    recs = [dev("k", 0, 10), dev("k", 50, 60), dev("k", 70, 100),
            host("bench.stretch", 0, 100), host("render", 5, 45), host("cudaGraphLaunch", 12, 20),
            host("wait", 61, 69)]
    gaps = dict((k, v) for k, v in idle_gaps(recs, 0, 100))
    assert gaps == {"render": pytest.approx(40e-6), "wait": pytest.approx(10e-6)}


def test_pass_device_time_by_correlation():
    recs = [host("forward.cull", 0, 100), host("forward.raster", 100, 200),
            host("cudaLaunchKernel", 10, 11, corr=1), host("cuLaunchKernel", 150, 151, corr=2),
            host("aten::add", 120, 130, corr=3), host("cudaLaunchKernel", 300, 301, corr=4),
            dev("cull_kernel", 500, 530, corr=1), dev("raster_walk_kernel<1>", 530, 600, corr=2),
            dev("add_kernel", 600, 605, corr=9, linked=3), dev("stray", 700, 701, corr=4)]
    per = pass_device_us(recs)
    assert per == {"cull": 30.0, "raster": 75.0, None: 1.0}
    k1 = pass_device_us(recs, kernel=lambda n: n.startswith("raster_walk_kernel"))
    assert k1["raster"] == 70.0
