"""Cells of the manifest cut to a size the CPU runs in seconds.

``tiny_cell(workload, root)`` writes under ``root`` a copy of the
manifest, the cell's configuration at 64x128 (8 hypotheses) and its
traffic with smaller pools, and returns the ``manifest.Cell``; the code
is the package's own.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from h100bench import manifest

SMALL = {
    "gen2v_512x1024": {"height": 64, "width": 128, "depth_hw": [32, 64],
                       "mono_hw": [64, 128],
                       "mvs": {"num_hypotheses": 8},
                       "renderer": {"depth_sample_num": 16,
                                    "fine_depth_sample_num": 16}},
    "mvs_m3d_256x512": {"height": 64, "width": 128, "num_hypotheses": 8},
}
SMALL_TRAFFIC = {
    "depth_train": {"pool": 4},
    "scene_prep": {"pool": 3, "sampled": 2},
    "walkthrough": {"chunk": 2048, "sampled": 2, "path_poses": 8},
}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def tiny_cell(workload: str, root: Path, traffic: dict | None = None,
              config: dict | None = None) -> manifest.Cell:
    root = Path(root)
    src = manifest.ROOT
    man = manifest.load_manifest(src)
    (root / "h100bench" / "traffic").mkdir(parents=True, exist_ok=True)
    (root / "h100bench" / "configs").mkdir(parents=True, exist_ok=True)
    shutil.copytree(src / "h100bench" / "metrics",
                    root / "h100bench" / "metrics", dirs_exist_ok=True)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    w = manifest.by_name(man["workloads"], workload, "workload")
    c = manifest.by_name(man["configs"], w["config"], "config")
    cfg = json.loads((src / c["file"]).read_text())
    cfg = _merge(cfg, SMALL[c["name"]])
    cfg = _merge(cfg, config or {})
    (root / c["file"]).write_text(json.dumps(cfg))
    name = w["traffic"]
    tr = json.loads((src / "h100bench" / "traffic" / f"{name}.json")
                    .read_text())
    tr = _merge(tr, SMALL_TRAFFIC[tr["kind"]])
    tr = _merge(tr, traffic or {})
    (root / "h100bench" / "traffic" / f"{name}.json").write_text(
        json.dumps(tr))
    return manifest.Cell(workload, root)
