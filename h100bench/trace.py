"""A profiled sub-window, and what its device trace says.

``profiled(fn, units)`` runs ``fn`` ``units`` times under
``torch.profiler`` inside a span named ``WINDOW`` and returns the trace's
complete events as plain tuples.  ``summarize`` reduces such a list,
whatever made it, to the device's busy time, the kernels launched, the
time by kernel and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW = "h100bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")


@dataclass(frozen=True)
class Event:
    cat: str
    name: str
    start_us: float
    dur_us: float
    tid: object = 0

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclass
class Summary:
    window_s: float
    busy_s: float
    launches: int
    kernel_s: dict = field(default_factory=dict)      # name -> seconds
    kernel_n: dict = field(default_factory=dict)      # name -> launches
    idle_gaps: dict = field(default_factory=dict)     # host activity -> s

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def matching(self, part: str) -> tuple:
        """(launches, seconds) of the kernels whose name holds ``part``."""
        n = sum(v for k, v in self.kernel_n.items() if part in k)
        s = sum(v for k, v in self.kernel_s.items() if part in k)
        return n, s

    def breakdown(self, top: int = 10, width: int = 96) -> dict:
        """The ``top`` kernels by time and idle gaps by host activity,
        names cut to ``width`` characters."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:width], v] for k, v in ops],
                "idle_gaps": [[k[:width], v] for k, v in gaps]}


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host: list, points: list) -> list:
    """For each of the sorted ``points``, the name of the innermost host
    event (the latest-starting one among those of one thread covering
    it; events of a thread nest), or None."""
    host = sorted(host, key=lambda e: (e.start_us, -e.dur_us))
    names, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i].start_us <= p:
            while stack and stack[-1].end_us < host[i].start_us:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end_us < p:
            stack.pop()
        names.append(stack[-1].name if stack else None)
    return names


def summarize(events: list, window: str = WINDOW) -> Summary:
    """Reduce a trace's complete events to the window's busy time,
    launches, time by kernel and idle gaps."""
    spans = [e for e in events if e.cat == "user_annotation"
             and e.name == window]
    if not spans:
        raise ValueError(f"the trace holds no {window!r} span")
    w = spans[0]
    w0, w1 = w.start_us, w.end_us
    dev = [e for e in events if e.cat in DEVICE_CATS
           and e.end_us > w0 and e.start_us < w1]
    busy = _union([[max(e.start_us, w0), min(e.end_us, w1)] for e in dev])
    kernel_s, kernel_n = {}, {}
    for e in dev:
        if e.cat == "kernel":
            kernel_s[e.name] = kernel_s.get(e.name, 0.0) + e.dur_us * 1e-6
            kernel_n[e.name] = kernel_n.get(e.name, 0) + 1
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = [e for e in events if e.cat in HOST_CATS and e.tid == w.tid
            and e is not w and e.end_us > w0 and e.start_us < w1]
    idle = {}
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), name in zip(gaps, _innermost(host, mids)):
        key = name or "host"
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    return Summary(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   launches=sum(kernel_n.values()), kernel_s=kernel_s,
                   kernel_n=kernel_n, idle_gaps=idle)


def chrome_events(path: str) -> list:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        raw = json.load(f)
    out = []
    for e in raw.get("traceEvents", raw if isinstance(raw, list) else []):
        if e.get("ph") == "X" and "dur" in e:
            out.append(Event(e.get("cat", ""), e.get("name", ""),
                             float(e["ts"]), float(e["dur"]),
                             e.get("tid", 0)))
    return out


def profiled(fn, units: int) -> list:
    """Run ``fn()`` ``units`` times under the profiler, inside the
    ``WINDOW`` span, synchronised at both ends; the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(units):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        return chrome_events(path)
