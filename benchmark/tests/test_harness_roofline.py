"""Kernel 1's bytes against a hand count."""

import pytest

from benchmark.harness import roofline


def test_raster_bytes_by_hand():
    # 101059 culled triangles at 22 floats of record each, and a 1920x1088
    # visibility buffer of a 4-byte depth and a 4-byte triangle id
    n = 101059 * 22 * 4 + 1920 * 1088 * (4 + 4)
    assert roofline.raster_bytes(101059, 1920, 1088) == n == 25_604_872


def test_roofline_share():
    # 25.6 MB at 3.35 TB/s is 7.642 us; a call of 100 us reads 7.642%
    pct = roofline.roofline_pct(25_604_872, 100e-6)
    assert pct == pytest.approx(100.0 * 25_604_872 / 3.35e12 / 100e-6)
    assert 7.6 < pct < 7.7
    assert roofline.roofline_pct(1, 0.0) is None


def test_k1_reader_reports_nothing_without_a_card_trace():
    from benchmark.harness import spec

    readers = spec.metric_readers()
    run = {"trace": {"device_kind": "cpu", "k1_ms": 0.1, "k1_triangles": 10.0,
                     "width": 64, "height": 64}}
    assert readers["k1_roofline_pct"].read(run) is None
    run["trace"]["device_kind"] = "cuda"
    assert readers["k1_roofline_pct"].read(run) == pytest.approx(
        roofline.roofline_pct(roofline.raster_bytes(10, 64, 64), 0.1e-3))
