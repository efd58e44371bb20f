"""The plain reference against the port at 64x128 on the CPU, both in
float32: every compared number reads (nearly) nought."""

import pytest

from h100bench.calibrate import calibrate
from h100bench.tests.tiny import tiny_cell

FLOAT32 = {"renderer": {"compute_dtype": "float32"}}


@pytest.mark.parametrize("workload", ["mvs_m3d.train", "gen2v.scenes",
                                      "gen2v.walkthrough"])
def test_reference_matches_the_port_in_float32(workload, tmp_path):
    cell = tiny_cell(workload, tmp_path,
                     config=FLOAT32 if workload.startswith("gen2v") else None)
    rec = calibrate(cell, [2 ** 31 + 3], 1.0, device="cpu",
                    out=lambda s: None)[0]
    assert rec["readings"], rec
    for name, value in rec["readings"].items():
        assert value <= 1e-4, (name, value)
