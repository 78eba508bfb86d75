"""The port stands alone: nothing in ``src/repro_torch/`` or
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``; its entry
points refuse to run without CUDA unless asked for the CPU; and a CPU
tensor never reaches a CUDA kernel."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
    return out


def test_port_files_found():
    assert len(PORT_FILES) > 20 and all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [
        mod for mod in _imported_modules(path)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_rule(no_cuda):
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)


def test_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.launch import run_brainsim
    from repro_torch.snn import DistributedSNN, LIFParams, SNNEngine

    w = np.zeros((8, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        SNNEngine(w_syn=w, params=LIFParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedSNN(mesh=(2,), w_syn=w, params=LIFParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        run_brainsim.main(["--populations", "16", "--steps", "1"])
    # the same calls run when the CPU is asked for
    SNNEngine(w_syn=w, params=LIFParams(), device="cpu").run(2)
    DistributedSNN(mesh=(2,), w_syn=w, params=LIFParams(), device="cpu").run(2)


def test_cpu_tensor_takes_the_plain_version():
    from repro_torch.kernels import LAUNCHES, reset_launches, spike_currents_blocks
    from repro_torch.kernels import spike_currents

    reset_launches()
    out = spike_currents_blocks(torch.ones(2, 4), torch.tensor([0, 1]),
                                torch.ones(2, 4, 3))
    assert torch.equal(out, torch.full((3,), 8.0))
    assert torch.equal(spike_currents(torch.ones(4), torch.ones(4, 3)),
                       torch.full((3,), 4.0))
    assert LAUNCHES == {"spike_accum_blocks": 0, "spike_accum": 0}
