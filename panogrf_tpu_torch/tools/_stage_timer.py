"""One timer for the stage profilers and ``tools.bench``.

A stage is a unit of work iterated on its own output: ``run`` computes the
stage's outputs from the current input, ``feed`` folds them into the next
input (a data dependency, so no application can be skipped or reordered).
``time_chain`` times ``iters`` such applications by one of two methods,
fixed per stage where the stage is made:

* ``graph``: the iterations are captured as one CUDA graph and its replay
  is timed with events: the device's time without the host's cost of
  issuing each kernel (the JAX tools' single dispatch of a chain).
* ``events``: for a stage that cannot be captured (a host sync or a
  pageable host-to-device copy inside it, an optimizer step), CUDA events
  around ``iters`` eager applications after one warm-up: the device's
  time, or the host's where issuing the kernels takes longer.

On the CPU both methods are the host clock around ``iters`` applications.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from panogrf_tpu_torch.ops.kernels import fused_mlp
from panogrf_tpu_torch.utils.device import synchronize

GRAPH, EVENTS = "graph", "events"


@dataclasses.dataclass
class Stage:
    """``run(x)`` -> the stage's outputs; ``feed(x, outputs)`` -> the next
    input; ``init`` the first input; ``module`` the stage's net, if any
    (the tests load the JAX package's weights into it)."""
    run: Callable
    feed: Callable
    init: Any
    iters: int = 8
    method: str = GRAPH
    module: torch.nn.Module | None = None

    def step(self, x):
        return self.feed(x, self.run(x))


def time_chain(step, init, iters: int, dev: torch.device,
               method: str = GRAPH) -> float:
    """Seconds per call of ``step`` iterated ``iters`` times on its own
    output, by ``method`` (``graph`` or ``events``) on the card and by the
    host clock on the CPU; one warm-up call first."""
    if method not in (GRAPH, EVENTS):
        raise ValueError(f"unknown timing method {method!r}")
    out = step(init)                 # warm-up: builds, allocator, caches
    synchronize(dev)
    if dev.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(out)
        return (time.perf_counter() - t0) / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if method == EVENTS:
        start.record()
        for _ in range(iters):
            out = step(out)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = init
        for _ in range(iters):
            out = step(out)
    graph.replay()                   # the first replay uploads the graph
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def mlp2_launches(fn) -> int:
    """The ``mlp2`` kernel's launches in one call of ``fn`` (the counts
    go on accumulating, for a caller that reads a whole run's)."""
    before = fused_mlp.MLP2_LAUNCHES
    fn()
    return fused_mlp.MLP2_LAUNCHES - before


def time_stages(stages: dict, dev: torch.device, res: dict) -> dict:
    """Time each stage of ``stages`` ({key: Stage}) into ``res``: its ms
    per application under ``key``, ``<key>_timing`` for the stages timed
    by events, and its ``mlp2`` launches per application under
    ``res["mlp2_launches"][key]``."""
    launches = res.setdefault("mlp2_launches", {})
    for key, st in stages.items():
        print(f"[stage] {key} ...", flush=True)
        launches[key] = mlp2_launches(lambda: st.step(st.init))
        res[key] = time_chain(st.step, st.init, st.iters, dev,
                              st.method) * 1e3
        if st.method == EVENTS:
            res[key.removesuffix("_ms") + "_timing"] = EVENTS
    return res


def tf32_on() -> bool:
    """Whether TF32 may stand in for float32 in matmuls or convolutions
    (the caller's flags, which the profilers leave as they are)."""
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
