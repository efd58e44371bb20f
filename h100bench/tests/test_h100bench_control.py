"""The control, the reference one precision lower in the program's place
(the traffic's ``control``: TF32 for float32, fp8 for bfloat16), reads
past a limit of the cell: the comparison can fail."""

import pytest

from h100bench.calibrate import calibrate
from h100bench.tests.tiny import tiny_cell


@pytest.mark.parametrize("workload", ["mvs_m3d.train", "gen2v.scenes",
                                      "gen2v.walkthrough"])
def test_control_fails_the_check(workload, tmp_path):
    cell = tiny_cell(workload, tmp_path)
    kind = cell.traffic["control"]
    rec = calibrate(cell, [2 ** 31 + 29], 1.0, control=kind,
                    control_runs=1, device="cpu", out=lambda s: None)[0]
    limits = cell.traffic["limits"]
    assert limits
    over = [n for n, lim in limits.items()
            if rec["control"]["readings"][n] > lim]
    assert over, (rec["control"]["readings"], limits)
