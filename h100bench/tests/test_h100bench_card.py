"""Each cell on the card, as the check runs it (``card``: skips without
a CUDA device)."""

import json
import subprocess
import sys

import pytest
import torch

from h100bench import manifest

MAN = manifest.load_manifest()


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload", workload,
         "--seed", "2147483659", "--seconds", str(MAN["run_seconds"]),
         "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True,
        timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
