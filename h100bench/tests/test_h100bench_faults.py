"""A run with the timed path broken underneath reads ``correct`` false,
for each fault the cell can have; a sound run reads true.  The look for a
card is skipped: the runs are at 64x128 on the CPU, under the cell's own
limits."""

import contextlib

import pytest

from h100bench import faults
from h100bench.run import run_cell
from h100bench.tests.tiny import tiny_cell

KIND = {"mvs_m3d.train": "depth_train", "gen2v.scenes": "scene_prep",
        "gen2v.walkthrough": "walkthrough"}
CASES = [(w, f) for w, k in KIND.items() for f in faults.KINDS[k]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_reads_incorrect(workload, fault, tmp_path):
    cell = tiny_cell(workload, tmp_path)
    with faults.plant(cell.traffic["kind"], fault):
        res = run_cell(cell, 2 ** 31 + 17, 1.0, False, device="cpu")
    assert res["correct"] is False, res["check"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("workload", sorted(KIND))
def test_sound_run_reads_correct(workload, tmp_path):
    cell = tiny_cell(workload, tmp_path)
    res = run_cell(cell, 2 ** 31 + 17, 1.0, False, device="cpu")
    assert res["check"], "the cell compares no number"
    assert res["correct"] is True, res["check"]


def test_fault_that_starts_after_setup_reads_incorrect(tmp_path,
                                                       monkeypatch):
    """A fault that only starts once set-up is over (as a change that
    captures the step after warm-up would) escapes the first checked
    steps, and the steps checked after the window catch it."""
    cell = tiny_cell("mvs_m3d.train", tmp_path)
    module = cell.driver()
    later = contextlib.ExitStack()
    setup = module.Driver.setup

    def setup_then_fault(self):
        setup(self)
        later.enter_context(faults.plant("depth_train", "altered_answer"))
    monkeypatch.setattr(module.Driver, "setup", setup_then_fault)
    with later:
        res = run_cell(cell, 2 ** 31 + 19, 1.0, False, device="cpu")
    r, lim = res["readings"], cell.traffic["limits"]
    assert all(r[n] <= lim[n] for n in ("loss_gap", "grad_gap",
                                        "change_gap")), res["check"]
    assert res["correct"] is False, res["check"]
    assert r["after_loss_gap"] > lim["after_loss_gap"], res["check"]
