"""On the card: each cell as committed runs through `benchmark/run.py` with a
short window and proves correct, and the control at the cell's own size
fails the cell's limits. Run with `python -m pytest benchmark/tests -q -m card`."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from harness import check, runner, spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2**31 + 101), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name, card):
    cell = spec.load_cell(name, ROOT)
    cells = runner.KINDS[cell.kind](cell, 2**31 + 202, card, program=False)
    out = cells.control()
    correct, _ = check.verdict(out["control"] if "control" in out else out, cell.limits)
    assert not correct, out
