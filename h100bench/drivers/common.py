"""What the drivers share: seeds, span timers and the FLOP counter."""

from __future__ import annotations

import time

import numpy as np
import torch


def seeds(seed: int, n: int) -> list:
    """``n`` independent 31-bit seeds derived from ``seed`` (any size)."""
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(n) >> 1]


class Phases:
    """Host seconds of each named step of a set-up, for the log."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now


class Spans:
    """Device time of named spans by CUDA events, read once at the end
    (no synchronisation inside the window), each span also marked for the
    profiler as ``h100bench.<name>``; off, it records nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.pending: dict = {}

    def start(self, name: str):
        if not self.on:
            return None
        mark = torch.profiler.record_function(f"h100bench.{name}")
        mark.__enter__()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return name, ev, mark

    def reset(self) -> None:
        """Forget what set-up recorded."""
        self.pending = {}

    def stop(self, token) -> None:
        if token is None:
            return
        name, ev0, mark = token
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        mark.__exit__(None, None, None)
        self.pending.setdefault(name, []).append((ev0, ev1))

    def ms(self) -> dict:
        """name -> [ms of each span]; synchronises."""
        if not self.pending:
            return {}
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.pending.items()}


def count_flops(fn) -> tuple:
    """(result of ``fn()``, the FLOPs that ``torch``'s counter saw)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn()
    return out, int(fc.get_total_flops())


def relative_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The widest gap between ``p`` and ``r`` over the largest magnitude
    of ``r`` (float64 on the CPU); inf where ``p`` is not finite or the
    shapes differ."""
    p = p.detach().double().cpu()
    r = r.detach().double().cpu()
    if p.shape != r.shape or not bool(torch.isfinite(p).all()):
        return float("inf")
    return float((p - r).abs().max() / r.abs().max().clamp(min=1e-30))


def mean_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The mean absolute gap between ``p`` and ``r`` over the mean
    magnitude of ``r``; inf where ``p`` is not finite or the shapes
    differ."""
    p = p.detach().double().cpu()
    r = r.detach().double().cpu()
    if p.shape != r.shape or not bool(torch.isfinite(p).all()):
        return float("inf")
    return float((p - r).abs().mean() / r.abs().mean().clamp(min=1e-30))


def worst(values) -> float:
    """The largest of ``values``; inf if any is not finite or there is
    none."""
    xs = [float(x) for x in values]
    if not xs or any(x != x or x in (float("inf"), float("-inf"))
                     for x in xs):
        return float("inf")
    return max(xs)


class Reservoir:
    """A uniform sample of ``k`` of the answers offered, drawn from
    ``seed`` (Algorithm R): whatever the window's length, every answer due
    in it is as likely to be checked, and at most ``k`` are held."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng(seed)
        self.n, self.kept = 0, {}

    def offer(self, item) -> None:
        i, self.n = self.n, self.n + 1
        if len(self.kept) < self.k:
            self.kept[i] = item
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = item
