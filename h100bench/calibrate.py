"""Read the numbers a cell's check compares, to set its limits.

    python -m h100bench.calibrate --workload <name> --seeds 1,2,3 \\
        --seconds 5 [--control tf32|fp8 --control-runs 3] [--fault NAME]

For each seed, one run of the cell as ``run.py`` makes it (set-up, a
window of ``--seconds``, the reference) and one JSON line of the
program's readings against the reference.  For the first
``--control-runs`` seeds it also reads the control: the reference one
precision lower in the program's place.  ``--fault`` plants one of
``faults.py``'s faults in the program.  The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from h100bench import guard, manifest
from h100bench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", default=None, choices=["tf32", "fp8"])
    ap.add_argument("--control-runs", type=int, default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    calibrate(manifest.Cell(args.workload),
              [int(s) for s in args.seeds.split(",")], args.seconds,
              args.control, args.control_runs, args.fault, args.device)
    found = guard.foreign()
    if found:
        print(f"foreign modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


def calibrate(cell, seeds: list, seconds: float, control=None,
              control_runs: int = 0, fault=None, device="cuda",
              out=print) -> list:
    """One record per seed (also passed to ``out`` as a JSON line)."""
    import torch
    records = []
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        res = run_cell(cell, seed, seconds, False, device, t0=t0,
                       fault=fault,
                       control=control if n < control_runs else None)
        line = {"workload": cell.name, "seed": seed,
                "items": res["attempted"], "fault": fault,
                "e2e": {k: v["value"] for k, v in res["metrics"].items()},
                "readings": res["readings"]}
        if "control" in res:
            line["control"] = {"kind": control, "readings": res["control"]}
        line["seconds"] = time.perf_counter() - t0
        out(json.dumps(line))
        records.append(line)
        del res
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    sys.exit(main())
