"""On the card: each cell of ``BENCHMARK.json`` runs through the command and
comes out correct, and at the cell's own size the control (the plain
reference in the program's place, one precision below the configuration's)
fails the cell's check where the program passes.  Skipped without a card;
the CPU tests of ``test_cellbench_control.py`` hold the same at test size."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT

from cellbench import spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
LIMITS = {"snn_sim": ("spike_margin_mv", "margin_limit_mv"),
          "serve_offline": ("logit_gap", "gap_limit")}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_command_runs_a_correct_cell(card, cell):
    out = subprocess.run([sys.executable, "cellbench/run.py", "--workload", cell, "--seed",
                          "2718281828", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    from cellbench import harness

    c = spec.find_cell(cell)
    number, limit = LIMITS[c.kind]
    ctx = harness.RunContext(cell=c, seed=1414213562, device=card, t0=0.0)
    got = spec.traffic_driver(c).readings(ctx, control=True)
    assert got[number] <= c.params[limit] < got[f"control_{number}"], got
