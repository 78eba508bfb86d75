"""The port's launcher prints what the JAX launcher prints: the partition /
routing / latency line, the spike-count line and the slow-axis byte line.

The JAX launcher runs in a subprocess on 8 fake host devices; the port's
runs in process with ``--device cpu --ranks 8``.  100 steps, so that every
neuron has fired (the first volley comes after step 40)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--populations", "64", "--neurons-per-pop", "2", "--steps", "100"]


def _jax_launcher(exchange: str) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [env.get("PYTHONPATH"), "src"]))
    out = subprocess.run(
        [sys.executable, "-m", "repro.launch.run_brainsim", *ARGS,
         "--exchange", exchange],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _lines(text: str) -> dict[str, str]:
    keys = ("devices=", "simulated ", "slow-axis bytes/step:")
    return {k: line for line in text.splitlines() for k in keys if line.startswith(k)}


@pytest.mark.parametrize("exchange", ["ragged", "two_level"])
def test_port_launcher_prints_the_reference_lines(exchange, capsys):
    from repro_torch.launch import run_brainsim

    res = run_brainsim.main([*ARGS, "--exchange", exchange, "--device", "cpu",
                             "--ranks", "8"])
    port = _lines(capsys.readouterr().out)
    ref = _lines(_jax_launcher(exchange))
    want = 3 if exchange == "ragged" else 2
    assert len(ref) == want and port == ref
    assert res["raster"].sum() > 0
