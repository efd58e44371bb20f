"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m h100bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Set-up (build, weights, inputs, warm-up) is timed from the start of
the process; the window then runs whole units for ``--seconds`` and ends
at a synchronisation.  ``--trace 1`` runs the window with the cell's spans
timed, then a profiled sub-window, and reports the per-layer metrics.
After the window the program's state is freed and the plain reference
checks the outputs the window kept.  The last lines of standard error
name each compared number beside its limit; the last line of standard
output is the result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from h100bench import guard, manifest  # noqa: E402

CACHE = manifest.ROOT / ".bench_cache"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    and one host thread for the CPU's own operators: the load is one
    process that launches work, and idle pool threads spinning on the
    shared host's cores make the window's time spread."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["OMP_NUM_THREADS"] = "1"


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float = T0, log=lambda s: None,
             fault: str | None = None, control: str | None = None) -> dict:
    """Set up, measure, trace (optionally) and check one run of ``cell``;
    returns the result's fields, every reading under ``readings``.
    ``device="cpu"`` (the tests) skips the look for a card and reports no
    device numbers.  For the calibration (never in the benchmark's own
    runs): ``fault``, one of ``faults.py``'s, is planted in the program
    from set-up until its state is freed; ``control`` (``tf32``, ``fp8``)
    also runs the reference one precision lower, its readings under
    ``control``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    drv = cell.driver().Driver(cell, seed, dev, trace)
    planted = contextlib.ExitStack()
    if fault:
        from h100bench import faults
        planted.enter_context(faults.plant(cell.traffic["kind"], fault))
    with planted:
        result, ctx = _measure(cell, drv, dev, seconds, trace, t0, log)
        drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = drv.reference(count=bool(trace))
    readings = drv.readings(drv.program_record(), ref)
    log(f"reference {time.perf_counter() - t_ref!r} s; readings {readings}")
    limits = cell.traffic["limits"]
    bad = [n for n in limits if not (math.isfinite(readings[n])
                                     and readings[n] <= limits[n])]
    # a number that is not finite is written as text: JSON has no inf
    check = {n: {"value": readings[n] if math.isfinite(readings[n])
                 else repr(readings[n]), "limit": limits[n]}
             for n in limits}
    if trace:
        result["metrics"] = {}
        for m in cell.per_layer():
            v = manifest.reader(m["name"], cell.root)(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["breakdown"] = ctx.summary.breakdown()
    result.update(correct=not bad, failed=len(bad), readings=readings)
    if control:
        result["control"] = drv.readings(drv.reference(lower=control), ref)
    result["check"] = check
    return result


def _measure(cell, drv, dev, seconds: float, trace: bool, t0: float, log):
    """Set-up, the window and, traced, the profiled sub-window: the
    result's fields so far and what the per-layer readers read."""
    import torch
    before = time.perf_counter() - t0
    drv.setup()
    _sync(dev)
    setup_s = time.perf_counter() - t0
    drv.spans.reset()
    log(f"set-up: {before!r} s to the driver, then {drv.phases.seconds}")

    items, start = 0, time.perf_counter()
    while True:
        items += drv.run_unit()
        if time.perf_counter() - start >= seconds:
            break
    _sync(dev)
    elapsed = time.perf_counter() - start
    e2e = drv.end_to_end(elapsed, items)
    log(f"setup_s {setup_s!r}; window {elapsed!r} s, {items} "
        f"{drv.unit}s; {e2e}")
    if hasattr(drv, "counters"):
        log(f"counters {drv.counters()}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": cell.chips}
    ctx = None
    if trace:
        from h100bench import trace as tr
        spans = drv.spans.ms()
        done = []
        events = tr.profiled(lambda: done.append(drv.run_unit()),
                             cell.traffic["trace_units"])
        summary = tr.summarize(events)
        del events
        ctx = SimpleNamespace(summary=summary, spans=spans, e2e=e2e,
                              seconds=elapsed, items=items,
                              trace_items=sum(done), driver=drv, cell=cell)
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    if dev.type == "cuda":
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            dev)
    metrics = {m["name"]: {"value": (setup_s if m["name"] == "setup_s"
                                     else e2e[m["name"]]),
                           "unit": m["unit"]}
               for m in cell.end_to_end()}
    return ({"correct": None, "attempted": items, "failed": None,
             "metrics": metrics, "device": device_info}, ctx)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_environment()
    cell = manifest.Cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      log=lambda s: print(s, file=sys.stderr, flush=True))
    found = guard.foreign()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
