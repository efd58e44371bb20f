"""The manifest keeps the contract's names and units, and every cell's
files are found by name; a cell is added by files and an entry alone."""

import json
import re

import pytest

from h100bench import manifest
from h100bench.run import run_cell
from h100bench.tests.tiny import tiny_cell

MAN = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["h100bench"]
    assert MAN["command"][:3] == ["python3", "-m", "h100bench.run"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100bench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_every_cell_finds_its_files_by_name():
    used = set()
    for w in MAN["workloads"]:
        cell = manifest.Cell(w["name"])
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.driver(), "Driver")
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = cell.per_layer()
        assert layers
        for m in layers:
            assert m["moves"] in e2e
            assert callable(manifest.reader(m["name"]))
    assert used == {c["name"] for c in MAN["configs"]}
    for m in MAN["per_layer"]:
        for w in m["workloads"]:
            cell = manifest.Cell(w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end()}


def test_check_budget_fits_the_full_benchmark():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_cell_added_by_files_alone(tmp_path):
    cell = tiny_cell("gen2v.scenes", tmp_path)
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "gen2v.scenes_pool2",
                             "config": "gen2v_512x1024",
                             "traffic": "scene_prep_pool2", "chips": 1,
                             "why": "a pool of two scenes"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "gen2v.scenes" in m.get("workloads", []):
            m["workloads"].append("gen2v.scenes_pool2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    tr = dict(cell.traffic, pool=2)
    (tmp_path / "h100bench" / "traffic" / "scene_prep_pool2.json"
     ).write_text(json.dumps(tr))
    new = manifest.Cell("gen2v.scenes_pool2", tmp_path)
    assert new.traffic["pool"] == 2
    res = run_cell(new, 11, 0.2, False, device="cpu")
    assert set(res["metrics"]) == {"setup_s", "scene_ms", "scene_ms_p95"}
    assert res["attempted"] >= 1
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("bad", ["a b", "x,y", "a/b", "", "é"])
def test_name_rule_rejects(bad):
    assert not NAME.match(bad)
