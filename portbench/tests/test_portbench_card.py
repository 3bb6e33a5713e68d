"""On the card: one short run of each cell, correct, with its result
line's keys.  Skips where there is no CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2**31 + 101), "--seconds", "3", "--trace",
         str(trace)], cwd=REPO, capture_output=True, text=True,
        timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]
    assert list(line)[-1] == "checks"
