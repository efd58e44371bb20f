"""The readers of the port's own spans, on a synthetic ``ctx``: each gives
its span's device ms per unit of the profiled sub-window, the host-gap
readers the idle time under the port's spans per unit, and each gives
None where its span is absent or the program has no spans."""

import sys
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile

from h100bench import manifest
from h100bench.trace import Summary
from panogrf_tpu_torch.utils import spans

SPAN_READERS = {
    "coarse_ms.walkthrough": "panogrf.render.coarse",
    "gather_ms.walkthrough": "panogrf.render.gather",
    "agg_ms.walkthrough": "panogrf.render.agg",
    "pool_ms.walkthrough": "panogrf.agg.pool",
    "mono_ms.scenes": "panogrf.mono",
    "sweep_ms.scenes": "panogrf.mvs.sweep",
    "reg3d_ms.scenes": "panogrf.mvs.reg",
    "forward_ms.mvs_train": "panogrf.train.forward",
    "backward_ms.mvs_train": "panogrf.train.backward",
    "update_ms.mvs_train": "panogrf.train.update",
}
GAP_READERS = ("host_gap_ms.scenes", "host_gap_ms.mvs_train")


def ctx(units=4, gaps=None):
    return SimpleNamespace(trace_items=units, summary=Summary(
        window_s=1.0, busy_s=0.8, launches=10, idle_gaps=gaps or {}))


def test_every_new_reader_is_in_the_manifest():
    names = {m["name"] for m in manifest.load_manifest()["per_layer"]}
    assert set(SPAN_READERS) | set(GAP_READERS) <= names


@pytest.mark.parametrize("metric,span", sorted(SPAN_READERS.items()))
def test_span_reader_gives_ms_per_unit(metric, span, monkeypatch):
    monkeypatch.setattr(spans, "device_ms", lambda: {
        span: [3.0, 5.0, 4.0], "panogrf.other": [100.0]})
    assert manifest.reader(metric)(ctx(units=4)) == pytest.approx(3.0)
    monkeypatch.setattr(spans, "device_ms", lambda: {"panogrf.other": [1.0]})
    assert manifest.reader(metric)(ctx()) is None


@pytest.mark.parametrize("metric", GAP_READERS)
def test_host_gap_reader_sums_gaps_under_the_port(metric, monkeypatch):
    gaps = {"panogrf.stack": 0.004, "panogrf.mvs.reg": 0.002,
            "cudaLaunchKernel": 0.5, "host": 0.25}
    monkeypatch.setattr(spans, "device_ms", lambda: {"panogrf.stack": [1.0]})
    assert manifest.reader(metric)(ctx(2, gaps)) == pytest.approx(3.0)
    # spans ran but the card never idled under one: zero, not absent
    assert manifest.reader(metric)(ctx(2, {"host": 0.1})) == 0.0
    monkeypatch.setattr(spans, "device_ms", lambda: {})
    assert manifest.reader(metric)(ctx(2, gaps)) is None


@pytest.mark.parametrize("metric", sorted(SPAN_READERS) + list(GAP_READERS))
def test_a_program_without_spans_reads_none(metric, monkeypatch):
    """The parent of the spans has no ``utils/spans.py``: the readers
    give nothing and raise nothing."""
    import panogrf_tpu_torch.utils
    every = {s: [1.0] for s in SPAN_READERS.values()}
    monkeypatch.setattr(spans, "device_ms", lambda: every)
    assert manifest.reader(metric)(ctx(gaps={"panogrf.mono": 1.0})) \
        is not None
    monkeypatch.setitem(sys.modules, "panogrf_tpu_torch.utils.spans", None)
    monkeypatch.delattr(panogrf_tpu_torch.utils, "spans")
    assert manifest.reader(metric)(ctx(gaps={"panogrf.mono": 1.0})) is None


def test_reader_of_real_spans_under_a_profiler():
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with spans.span("mono"):
                sum(range(1000))
    try:
        got = manifest.reader("mono_ms.scenes")(ctx(units=3))
        ms = spans.device_ms()["panogrf.mono"]
    finally:
        spans.reset()
    assert len(ms) == 3 and got == pytest.approx(sum(ms) / 3)
