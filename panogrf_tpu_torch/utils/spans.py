"""Named spans at the port's layer boundaries, live only under a profiler.

``span(name)`` marks a region as ``panogrf.<name>``.  While no
``torch.profiler`` records, it returns one shared null context: no
allocation, no ``record_function``, no CUDA event, nothing stored.  So
there is nothing to turn on: run any entry point under ``torch.profiler``
and the spans are there.

While a profiler records, a span opens
``torch.profiler.record_function("panogrf.<name>")``, so the range sits on
the trace's own clock beside the kernels it launched; it times the
region's device work by a pair of CUDA events on the current stream (by
the host clock where CUDA is not in use: there the CPU is the device) and
appends ``(name, parent, start, end)`` to this module's store, the parent
being the enclosing open span.  Each name's entries are its call count.
The store grows while a profiler records; ``reset()`` empties it.

``device_ms()`` and ``summary()`` read the store.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "panogrf."

_OFF = contextlib.nullcontext()
_store: list = []     # (name, parent or None, start, end)
_open: list = []      # names of the open spans, innermost last


def span(name: str, note: str | None = None):
    """A context that marks ``panogrf.<name>`` while a profiler records
    (see the module's docstring), else the shared null context.  ``note``,
    a short text about the call (e.g. ``"sources=2"``), goes to the
    range's arguments in the trace."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(PREFIX + name, note)


class _Span:
    __slots__ = ("name", "note", "mark", "cuda", "start")

    def __init__(self, name: str, note: str | None):
        self.name, self.note = name, note

    def __enter__(self):
        self.mark = torch.profiler.record_function(self.name, self.note)
        self.mark.__enter__()
        self.cuda = torch.cuda.is_initialized()
        self.start = _stamp(self.cuda)
        _open.append(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        _open.pop()
        _store.append((self.name, _open[-1] if _open else None,
                       self.start, _stamp(self.cuda)))
        self.mark.__exit__(*exc)
        return False


def _stamp(cuda: bool):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def reset() -> None:
    """Forget every recorded span."""
    _store.clear()


def _ms(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e3
    return start.elapsed_time(end)


def device_ms() -> dict:
    """Full name -> [device ms of each call], in call order; synchronises
    once where any span timed CUDA work."""
    if any(not isinstance(e[2], float) for e in _store):
        torch.cuda.synchronize()
    out: dict = {}
    for name, _, start, end in _store:
        out.setdefault(name, []).append(_ms(start, end))
    return out


def summary() -> list:
    """One row per full name, in first-call order: ``calls``, ``ms``
    (device ms of all calls) and ``self_ms`` (``ms`` less the device ms
    of the spans opened directly inside it)."""
    per = device_ms()
    rows = {n: {"name": n, "calls": len(v), "ms": sum(v), "self_ms": sum(v)}
            for n, v in per.items()}
    seen: dict = {}
    for name, parent, _, _ in _store:
        i = seen[name] = seen.get(name, -1) + 1
        if parent is not None:
            rows[parent]["self_ms"] -= per[name][i]
    return list(rows.values())
