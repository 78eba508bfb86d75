"""The port's launchers.

The brain-simulation launcher prints what the JAX launcher prints: the
partition / routing / latency line, the spike-count line and the
slow-axis byte line.  The JAX launcher runs in a subprocess on 8 fake host
devices; the port's runs in process with ``--device cpu --ranks 8``.  100
steps, so that every neuron has fired (the first volley comes after step
40).

The training launcher trains sharded over 4 gloo ranks, checkpoints and
resumes (``tests/_torch_dist.py:launcher_rank``)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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


def test_training_launcher_on_four_gloo_ranks_checkpoints_and_resumes(tmp_path, capsys):
    """``repro_torch.launch.train`` as ``torch.distributed.run`` starts it on
    4 gloo ranks (a ``(2, 2)`` ``("data", "model")`` mesh, ``make_policy``):
    3 steps and a checkpoint, then ``--resume`` for 3 more.  Only rank 0
    prints; its losses equal a one-process run's within the bf16 tolerance
    (2e-2 relative); rank 0 wrote the checkpoints in the reference's format
    and every rank read them back."""
    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ck
    from tests._torch_dist import launcher_rank, spawn

    ckpt = tmp_path / "ckpt"
    argv = ["--arch", "phi4-mini-3.8b", "--reduced", "--steps", "3", "--seq", "64",
            "--device", "cpu", "--ckpt-dir", str(ckpt), "--ckpt-every", "3"]
    first = spawn(launcher_rank, 4, tmp_path / "first", argv, timeout=300)
    assert sorted(ck._steps(str(ckpt))) == [0, 3]
    assert all(ck.verify_checkpoint(str(ckpt), s) for s in (0, 3))
    again = spawn(launcher_rank, 4, tmp_path / "again", argv + ["--resume"], timeout=300)
    lead = first[0]["lines"]
    assert lead[0].startswith("arch=phi4-mini-3.8b params=") and lead[0].endswith("devices=4")
    assert lead[-1].startswith("steps 1..3: loss ")
    assert "resumed from step 3" in again[0]["lines"]
    assert all(not r["lines"] for r in first[1:] + again[1:])
    for runs in (first, again):
        assert all(r["losses"] == runs[0]["losses"] for r in runs)  # one replicated loss
    assert first[0]["steps"] == [1, 2, 3] and again[0]["steps"] == [4, 5, 6]

    one = tmp_path / "one"
    single = [h.loss for h in train.main(argv[:-4] + ["--ckpt-dir", str(one), "--ckpt-every", "3"])]
    single += [h.loss for h in train.main(argv[:-4] + ["--ckpt-dir", str(one), "--ckpt-every",
                                                      "3", "--resume"])]
    assert capsys.readouterr().out.splitlines()[0].endswith("devices=1")
    np.testing.assert_allclose(first[0]["losses"] + again[0]["losses"], single, rtol=2e-2)
