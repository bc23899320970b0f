"""Runs on the card: each cell once through ``run.py`` at a short window,
correct and with its metrics.  Skips where there is no card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO

with open(f"{REPO}/BENCHMARK.json") as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]
