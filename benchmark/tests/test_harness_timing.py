"""The window arithmetic: the frame time and the percentile of the
intervals between frames' completions."""

import numpy as np
import pytest

from benchmark.harness import timing


@pytest.mark.parametrize("n", [1, 2, 7, 100, 401])
def test_percentile_matches_numpy_linear(n):
    xs = np.random.default_rng(n).exponential(15.0, size=n).tolist()
    for q in (5.0, 50.0, 95.0, 99.0):
        assert timing.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_intervals_and_frame_time():
    # completions at 10, 24, 40 ms after a window start at 0
    assert timing.intervals_ms(0.0, [10.0, 24.0, 40.0]) == [10.0, 14.0, 16.0]
    assert timing.frame_ms(0.045, 3) == pytest.approx(15.0)
    with pytest.raises(ValueError):
        timing.frame_ms(1.0, 0)


def test_p95_of_a_window_with_one_hitch_in_twenty():
    # 19 frames of 14 ms and one of 40 ms: the 95th percentile lies between
    # them (linear interpolation at rank 18.05 of 0..19)
    xs = [14.0] * 19 + [40.0]
    assert timing.percentile(xs, 95.0) == pytest.approx(14.0 + 0.05 * 26.0)
