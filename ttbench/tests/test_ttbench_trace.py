"""Busy, idle, launches and the breakdown from trace intervals."""
import math

import pytest

from ttbench.trace import REQUEST_RANGE, Interval, summarize


def test_union_of_overlapping_device_intervals():
    host = [Interval(REQUEST_RANGE, 0, 100), Interval(REQUEST_RANGE, 100, 200),
            Interval("aten::linalg_svd", 38, 72),
            Interval("cudaStreamSynchronize", 40, 70),
            Interval("aten::randn", 150, 200)]
    device = [Interval("k1", 0, 30), Interval("k2", 10, 40),  # overlap
              Interval("memcpy", 70, 100), Interval("k1", 100, 150),
              Interval("k3", 190, 260)]  # past the window: clipped
    t = summarize(device, host)
    assert t.n_requests == 2 and t.device_events == 5
    assert math.isclose(t.window_s, 200e-6)
    assert math.isclose(t.busy_s, (40 + 30 + 50 + 10) * 1e-6)
    assert math.isclose(t.idle_s, 70e-6)
    assert dict(t.device_ops) == {"k1": pytest.approx(80e-6),
                                  "k2": pytest.approx(30e-6),
                                  "memcpy": pytest.approx(30e-6),
                                  "k3": pytest.approx(10e-6)}
    # the gap 40-70 during the SVD's synchronisation (innermost on a tie),
    # 150-190 during randn
    assert dict(t.idle_gaps) == {
        "aten::randn": pytest.approx(40e-6),
        "cudaStreamSynchronize": pytest.approx(30e-6)}


def test_no_request_range_is_an_error():
    with pytest.raises(ValueError):
        summarize([], [Interval("aten::mm", 0, 1)])


def test_busy_is_averaged_over_the_cards():
    host = [Interval(REQUEST_RANGE, 0, 100)]
    device = [Interval("k", 0, 60, 0), Interval("k", 20, 40, 0),
              Interval("k", 50, 70, 1)]
    t = summarize(device, host, n_devices=2)
    assert math.isclose(t.busy_s, (60 + 20) / 2 * 1e-6)
    # idle only where no card works: 70-100
    assert dict(t.idle_gaps) == {"(no host operation)": pytest.approx(30e-6)}
