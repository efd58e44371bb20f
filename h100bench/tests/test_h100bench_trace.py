"""The idle share, launches, time by kernel and idle gaps read from a
synthetic profiler event list."""

import pytest

from h100bench.trace import WINDOW, Event, chrome_events, summarize

HOST, DEV = 1, 7


def events():
    return [
        Event("user_annotation", WINDOW, 0.0, 1000.0, HOST),
        Event("cpu_op", "aten::mm", 10.0, 100.0, HOST),
        Event("cuda_runtime", "cudaLaunchKernel", 20.0, 20.0, HOST),
        Event("kernel", "gemm", 100.0, 200.0, DEV),
        Event("kernel", "mlp2_lanes_kernel", 250.0, 150.0, DEV),
        Event("gpu_memcpy", "Memcpy DtoD", 500.0, 100.0, DEV),
        Event("cpu_op", "aten::cat", 620.0, 300.0, HOST),
        Event("kernel", "gemm", 950.0, 100.0, DEV),   # runs past the end
        Event("kernel", "gemm", 1200.0, 10.0, DEV),   # after the window
        Event("cpu_op", "other_thread", 0.0, 1000.0, 99),
    ]


def test_busy_idle_and_launches():
    s = summarize(events())
    assert s.window_s == pytest.approx(1000e-6)
    # [100, 400] + [500, 600] + [950, 1000]
    assert s.busy_s == pytest.approx(450e-6)
    assert s.idle_share == pytest.approx(0.55)
    assert s.launches == 3               # a copy is no launch
    assert s.matching("mlp2") == (1, pytest.approx(150e-6))
    assert s.kernel_n["gemm"] == 2


def test_idle_gaps_by_innermost_host_activity():
    s = summarize(events())
    # gaps [0, 100] (mid 50: aten::mm), [400, 500] (mid 450: none),
    # [600, 950] (mid 775: aten::cat)
    assert s.idle_gaps == {"aten::mm": pytest.approx(100e-6),
                           "host": pytest.approx(100e-6),
                           "aten::cat": pytest.approx(350e-6)}
    b = s.breakdown()
    assert b["idle_gaps"][0][0] == "aten::cat"
    assert b["device_ops"][0] == ["gemm", pytest.approx(300e-6)]


def test_window_span_is_required():
    with pytest.raises(ValueError):
        summarize([Event("kernel", "k", 0.0, 1.0, DEV)])


def test_chrome_trace_file(tmp_path):
    import json
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 5,
         "dur": 10, "tid": 3},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 6, "dur": 2,
         "tid": 9},
        {"ph": "i", "cat": "marker", "name": "m", "ts": 7}]}))
    ev = chrome_events(str(path))
    assert [e.name for e in ev] == [WINDOW, "k"]
    assert summarize(ev).busy_s == pytest.approx(2e-6)
