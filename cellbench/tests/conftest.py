"""Shared helpers of the benchmark's tests.

Run from the repository's root: ``python -m pytest -q cellbench/tests``.
The CPU tests drive every part of a run at tiny sizes (the cells under
``data/``); the tests marked ``cuda`` run the benchmark's cells on a card
and skip elsewhere, deciding inside the ``card`` fixture.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def card():
    """The card the benchmark runs on; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's cells run on the card)")
    return torch.device("cuda", 0)


def run_tiny(cell: str, seed: int, trace: int = 0, seconds: float = 0.3):
    """One run of a tiny cell of ``data/benchmark.json`` on the CPU, the
    look for a card skipped: (exit code, result line, standard error)."""
    import io
    import json

    from cellbench import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)], bench_file=DATA / "benchmark.json",
                     bench_dir=DATA, device="cpu", out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
