"""Find a cell's configuration, traffic, driver and metric readers by name.

Everything a cell needs is a file named after it in ``BENCHMARK.json``:
the configuration's ``file``, ``traffic/<traffic>.json`` (whose ``kind``
names ``drivers/<kind>.py``) and ``metrics/<metric>.py`` for each
per-layer metric.  Adding a cell adds files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of the manifest with everything it names, read."""

    def __init__(self, workload: str, root: Path = ROOT,
                 manifest: dict | None = None):
        self.root = Path(root)
        self.manifest = manifest or load_manifest(self.root)
        self.workload = by_name(self.manifest["workloads"], workload,
                                "workload")
        self.name = workload
        self.config_entry = by_name(self.manifest["configs"],
                                    self.workload["config"], "config")
        self.config = json.loads(
            (self.root / self.config_entry["file"]).read_text())
        self.traffic_name = self.workload["traffic"]
        self.traffic = json.loads((self.root / "h100bench" / "traffic"
                                   / f"{self.traffic_name}.json").read_text())
        self.chips = int(self.workload["chips"])

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics whose readers this cell runs: those that
        list it, and those without a list that move one of its end-to-end
        metrics."""
        e2e = {m["name"] for m in self.end_to_end()}

        def runs_here(m):
            return (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)
        return [m for m in self.manifest["per_layer"] if runs_here(m)]

    def driver(self):
        """The driver module of the traffic's kind."""
        return importlib.import_module(
            f"h100bench.drivers.{self.traffic['kind']}")


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = Path(root) / "h100bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench.metrics.{metric.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
