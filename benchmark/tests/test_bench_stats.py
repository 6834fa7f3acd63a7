"""Percentiles and rates take every sample of a window."""

import numpy as np
import pytest

from benchmark.core import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_matches_numpy_over_all_samples(q):
    xs = np.random.default_rng(3).exponential(size=257)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_sees_a_single_stall():
    xs = [10.0] * 99 + [1000.0]
    assert stats.percentile(xs, 100) == 1000.0
    assert stats.percentile(xs, 50) == 10.0


def test_rate_is_count_over_all_seconds():
    assert stats.rate(150, 30.0) == 5.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_frame_readers_use_every_frame():
    from benchmark.core.main import load_reader
    from benchmark.core.record import Run
    times = [0.04] * 97 + [0.2, 0.3, 0.4]
    run = Run(kind="serve", setup_s=1.0, window_s=5.0, attempted=100,
              failed=0, memory_peak_bytes=0, item_s=times)
    assert load_reader("frames_per_s")(run) == pytest.approx(20.0)
    assert load_reader("frame_p95_ms")(run) == pytest.approx(
        1e3 * np.percentile(times, 95))
    assert load_reader("train.step_ms")(run) is None
    train = Run(kind="train", setup_s=1.0, window_s=3.0, attempted=200,
                failed=0, memory_peak_bytes=0, steps=200)
    assert load_reader("train.step_ms")(train) == pytest.approx(15.0)


def test_train_device_ms_is_busy_time_over_the_profiled_steps():
    from benchmark.core.main import load_reader
    from benchmark.core.record import Run
    from benchmark.core.trace import TraceSummary
    # 62 profiled steps busy 0.155 s in all: 2.5 ms a step, whatever the
    # window's or the profiled tail's own length
    trace = TraceSummary(window_s=4.0, busy_s=0.155, n_device_ops=41168,
                         items=62)
    run = Run(kind="train", setup_s=1.0, window_s=51.0, attempted=4000,
              failed=0, memory_peak_bytes=0, steps=4000, trace=trace)
    read = load_reader("train_device_ms")
    assert read(run) == pytest.approx(2.5)
    # no device ran (the CPU): left out, never 0
    run.trace = TraceSummary(window_s=4.0, busy_s=0.0, n_device_ops=0,
                             items=62)
    assert read(run) is None
    run.trace = None
    assert read(run) is None
    serve = Run(kind="serve", setup_s=1.0, window_s=5.0, attempted=10,
                failed=0, memory_peak_bytes=0, trace=trace)
    assert read(serve) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_idle_share_sets_traced_busy_time_against_the_window(kind):
    from benchmark.core.main import load_reader
    from benchmark.core.record import Run
    from benchmark.core.trace import TraceSummary
    # a traced item is busy 50 ms; the untraced window takes 200 ms an
    # item; the traced window's own 4 s (the profiler's slow host) is
    # not the clock
    trace = TraceSummary(window_s=4.0, busy_s=0.5, n_device_ops=10,
                         items=10)
    run = Run(kind=kind, setup_s=1.0, window_s=20.0, attempted=100,
              failed=0, memory_peak_bytes=0, item_s=[0.2] * 100,
              steps=100, trace=trace)
    read = load_reader(f"device.idle_share.{kind}")
    assert read(run) == pytest.approx(75.0)
    run.trace = TraceSummary(window_s=4.0, busy_s=0.0, n_device_ops=0,
                             items=10)
    assert read(run) is None
