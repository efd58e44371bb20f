"""The window arithmetic: a rate over all the window's work, a tail over
every unit."""

import pytest

from h100bench.window import ms_per_unit, percentile


def test_rate_is_all_time_over_all_work():
    assert ms_per_unit(10.5, 42) == pytest.approx(250.0)
    with pytest.raises(ValueError):
        ms_per_unit(1.0, 0)


def test_p95_is_nearest_rank_over_every_value():
    xs = list(range(1, 201))            # 200 scenes: 10 lie beyond p95
    assert percentile(xs, 95) == 190
    assert percentile(reversed(xs), 95) == 190
    assert percentile([7.0], 95) == 7.0
    assert percentile([1, 2, 3, 100], 95) == 100
    with pytest.raises(ValueError):
        percentile([], 95)


def test_scene_driver_reports_p95_of_its_latencies():
    from types import SimpleNamespace

    from h100bench.drivers.scene_prep import Driver
    lat = [0.1] * 190 + [0.2] * 10
    e2e = Driver.end_to_end(SimpleNamespace(latencies=lat), 20.0, 200)
    assert e2e == {"scene_ms": pytest.approx(100.0),
                   "scene_ms_p95": pytest.approx(100.0)}
    e2e = Driver.end_to_end(SimpleNamespace(latencies=lat[:189] + [0.2] * 11),
                            20.0, 200)
    assert e2e["scene_ms_p95"] == pytest.approx(200.0)


def test_reservoir_samples_every_answer_alike():
    from h100bench.drivers.common import Reservoir
    counts = [0] * 20
    for seed in range(2000):
        r = Reservoir(4, seed)
        for i in range(20):
            r.offer(i)
        assert len(r.kept) == 4 and sorted(r.kept.values()) == \
            sorted(set(r.kept.values()))
        for i in r.kept.values():
            counts[i] += 1
    # each of the 20 answers is kept 4/20 of the time (400 of 2000)
    assert all(320 < c < 480 for c in counts), counts
    a, b = Reservoir(3, 9), Reservoir(3, 9)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.kept == b.kept
    short = Reservoir(3, 1)
    short.offer("x")
    assert list(short.kept.values()) == ["x"]
