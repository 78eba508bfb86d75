"""The port stands alone: nothing in ``src/repro_torch/`` or
``chip_smoke.py`` imports ``jax``, the JAX package ``repro`` or the
reference's ``benchmarks`` (which import ``repro``), not even inside a
function body; its entry
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
        if mod.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")
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
    from repro_torch.configs import ARCHS
    from repro_torch.launch import brainsim, run_brainsim, serve, train
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    from repro_torch.snn import DistributedSNN, LIFParams, SNNEngine, init_state

    w = np.zeros((8, 8), np.float32)
    cfg = ARCHS["deepseek-7b"].reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        SNNEngine(w_syn=w, params=LIFParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedSNN(mesh=(2,), w_syn=w, params=LIFParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        run_brainsim.main(["--populations", "16", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        brainsim.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(4, LIFParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg)
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            lm.init_cache(ARCHS[arch].reduced(), 1, 8)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "deepseek-7b", "--max-new", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "deepseek-7b", "--steps", "1"])
    # the same calls run when the CPU is asked for
    SNNEngine(w_syn=w, params=LIFParams(), device="cpu").run(2)
    DistributedSNN(mesh=(2,), w_syn=w, params=LIFParams(), device="cpu").run(2)
    assert init_state(4, LIFParams(), device="cpu").v.device.type == "cpu"
    assert len(ServeEngine(cfg, params, device="cpu").generate([[1, 2]], 2)[0]) == 2
    assert len(serve.main(["--arch", "deepseek-7b", "--max-new", "1", "--device", "cpu"])) == 2


def test_cpu_tensor_takes_the_plain_version():
    from repro_torch.kernels import LAUNCHES, reset_launches, spike_currents_blocks
    from repro_torch.kernels import spike_currents
    from repro_torch.kernels.ops import attention, decode_attention, rglru, ssd

    reset_launches()
    out = spike_currents_blocks(torch.ones(2, 4), torch.tensor([0, 1]),
                                torch.ones(2, 4, 3))
    assert torch.equal(out, torch.full((3,), 8.0))
    assert torch.equal(spike_currents(torch.ones(4), torch.ones(4, 3)),
                       torch.full((3,), 4.0))
    v = torch.arange(12.0).view(1, 1, 3, 4)
    out = attention(torch.zeros(1, 2, 3, 4), torch.zeros(1, 1, 3, 4), v)
    assert torch.equal(out[0, 1, 2], v[0, 0].mean(0))  # uniform over the causal prefix
    out = decode_attention(torch.zeros(1, 2, 4), torch.zeros(1, 1, 3, 4), v,
                           seq_lens=torch.tensor([2], dtype=torch.int32))
    assert torch.equal(out[0, 0], v[0, 0, :2].mean(0))
    out = decode_attention(torch.zeros(1, 2, 4), torch.zeros(1, 1, 3, 4), v,
                           slot_pos=torch.tensor([5, -1, 3], dtype=torch.int32), slot_lo=2)
    assert torch.equal(out[0, 0], v[0, 0, [0, 2]].mean(0))
    h = rglru(torch.full((1, 3, 2), 0.5), torch.ones(1, 3, 2))
    assert torch.equal(h[0, :, 0], torch.tensor([1.0, 1.5, 1.75]))
    y = ssd(torch.ones(1, 2, 1, 1), torch.ones(1, 2, 1), torch.ones(1, 2, 1, 1),
            torch.ones(1, 2, 1, 1))
    assert torch.equal(y.flatten(), torch.tensor([1.0, 2.0]))
    from repro_torch import random

    key = random.PRNGKey(0)
    assert random.normal(key, (3,)).shape == (3,) and random.split(key).shape == (2, 2)
    assert LAUNCHES == {"spike_accum_blocks": 0, "spike_accum": 0,
                        "flash_attention": 0, "decode_attention": 0,
                        "ssd_scan": 0, "rglru_scan": 0, "threefry": 0}
