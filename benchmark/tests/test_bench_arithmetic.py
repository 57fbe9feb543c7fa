"""The readers' arithmetic on synthetic inputs: the window rate, the 95th
percentile over all calls, the idle share from a union of intervals, the
gaps' labels and the roofline bounds."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness, readers, roofline, trace


def run_of(**kw) -> harness.Run:
    base = dict(setup_s=1.0, window_s=2.0, steps=4, bases=8_000_000_000, latencies_s=[],
                spans=[], counters={})
    base.update(kw)
    return harness.Run(**base)


def test_window_rate_is_all_bases_over_the_whole_window():
    assert readers.window_gbps(run_of()) == pytest.approx(4.0)
    assert readers.window_gbps(run_of(steps=0)) is None


def test_p95_is_over_every_call():
    rng = np.random.default_rng(1)
    lat = rng.exponential(1.0, 1001).tolist()
    assert readers.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert readers.percentile([3.0], 95) == 3.0
    assert readers.percentile(list(range(101)), 95) == pytest.approx(95.0)


def test_busy_is_the_union_of_intervals():
    busy, merged = trace.device_busy([(0, 10), (5, 15), (20, 30), (29, 31), (40, 40)])
    assert busy == 26 and merged == [(0, 15), (20, 31), (40, 40)]


def test_idle_share_and_gap_labels():
    device = [("k", 1_000_000_000, 2_000_000_000), ("k", 1_500_000_000, 2_500_000_000),
              ("c", 3_000_000_000, 3_500_000_000)]
    host = [(2_600_000_000, 2_950_000_000, "cudaStreamSynchronize")]
    t = trace.reduce(device, host, wall_s=4.0)
    assert t.busy_s == pytest.approx(2.0)
    assert readers.idle_share(run_of(trace=t)) == pytest.approx(50.0)
    assert dict(t.device_ops) == pytest.approx({"k": 2.0, "c": 0.5})
    # One gap (2.5 s to 3.0 s); its middle lies in the synchronize.
    assert dict(t.idle_gaps) == pytest.approx({"cudaStreamSynchronize": 0.5})
    assert readers.idle_share(run_of()) is None


def test_roofline_share_and_bounds():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    # K1 on one [32, 2^20] batch of 700 k-stream elements a row.
    b = roofline.k1_bound_s(32, 1 << 20, 64, 32 * 5000, 32 * 700000, 32)
    nbytes = 32 * (1 << 20) + 8 * 32 + 32 * 5000 * 12 + 32 * 64 * 12
    assert b == pytest.approx(nbytes / 3.35e12)
    assert roofline.k2_bound_s(2, 4, 10, 100) == pytest.approx(
        (10 * 12 + 2 * 4 * 8 + 2 * 100 * 12 + 2 * 8) / 3.35e12)
    assert roofline.k3_bound_s(2, [10, 3], 5, 100) == pytest.approx(
        (13 * 4 + 6 * 8 + 2 * 96 * 17 + 2 * 8) / 3.35e12)
    t = trace.DeviceTrace(window_s=1.0, busy_s=0.5, kernel_s={"a": 0.2, "b": 0.2, "x": 9.0},
                          device_ops=[], idle_gaps=[])
    run = run_of(trace=t, counters={"k_bound_s": 0.1})
    assert readers.roofline(run, "k_bound_s", ("a", "b")) == pytest.approx(25.0)
    assert readers.roofline(run, "k_bound_s", ("missing",)) is None
    assert readers.roofline(run_of(counters={"k_bound_s": 0.1}), "k_bound_s", ("a",)) is None

