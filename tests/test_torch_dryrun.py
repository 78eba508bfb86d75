"""The port's dry-run (``python -m repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``): the record of a CLI cell, its
resumption, and rank 0's argument bytes of a cell of each kind.

The reference lowers a cell on 512 fake XLA devices; the port counts it on
the ``fake`` process-group backend with meta DTensors.  Both run in
subprocesses (a process group, or XLA's device count, would outlive the
test in the worker).  Argument bytes are held exactly: the sum over the
reference's ``abstract_state``, ``abstract_cache`` and ``input_specs``
leaves of their ``sharding.shard_shape`` bytes, computed without compiling,
against the port's ``argument_bytes`` of the same cell.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun
from tests.conftest import run_devices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("memory", "hlo", "roofline", "netsim", "top_collectives", "tokens_per_step")


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, ["src", os.environ.get(
        "PYTHONPATH")])))


def _cli(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)


def test_cli_cell_record_and_resume(tmp_path):
    """``--arch mamba2-1.3b --shape decode_32k --mesh single`` writes the
    reference's record (``tests/test_system.py:74-95``'s asserts, the fit
    against the H100's 80 GB) priced with ``H100``; a rerun skips it."""
    out = tmp_path / "dr.jsonl"
    args = ("--arch", "mamba2-1.3b", "--shape", "decode_32k", "--mesh", "single",
            "--out", str(out))
    res = _cli(*args)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rec = json.loads(out.read_text().strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["tag"] == "baseline"
    assert all(k in rec for k in KEYS) and "xla_cost" not in rec
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["hlo"]["flops_per_chip"] > 0
    assert rec["memory"]["fits_80g"] and rec["memory"]["temp_is_estimate"]
    assert rec["hw"] == "h100_sxm" and rec["decode_weights"] == "replicated_over_dp"
    assert rec["tokens_per_step"] == 128
    assert "dry-run sweep: 1 ok, 0 skipped, 0 errors" in res.stdout
    again = _cli(*args)
    assert again.returncode == 0 and "dry-run sweep: 0 ok, 0 skipped, 0 errors" in again.stdout
    assert len(out.read_text().strip().splitlines()) == 1


def test_long_context_cell_is_skipped():
    rec = dryrun.run_cell("phi4-mini-3.8b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped" and "500k" in rec["reason"]


SHAPES = ("train_4k", "prefill_32k", "decode_32k")

REFERENCE = """
import dataclasses, json
import jax, numpy as np
from repro.configs import SHAPES, get_config
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
from repro.sharding.policies import make_policy

cfg = get_config("phi4-mini-3.8b")
mesh = make_production_mesh(multi_pod=False)
out = {{}}
for name in {shapes!r}:
    shape = SHAPES[name]
    pol = make_policy(mesh)
    if shape.global_batch < pol.dp_size:
        pol = dataclasses.replace(pol, batch_axes=())
    if shape.kind == "decode" and cfg.param_count() * 2 / max(pol.tp_size, 1) < 8e9:
        pol = dataclasses.replace(pol, fsdp_axes=())
    params, opt = D.abstract_state(cfg, pol)
    leaves = jax.tree.leaves(params)
    if shape.kind == "train":
        leaves += jax.tree.leaves(opt)
    if shape.kind == "decode":
        leaves += jax.tree.leaves(D.abstract_cache(cfg, shape.global_batch, shape.seq_len, pol))
    leaves += jax.tree.leaves(D.input_specs(cfg, shape, pol))
    out[name] = sum(int(np.prod(l.sharding.shard_shape(l.shape))) * l.dtype.itemsize
                    for l in leaves)
print("JSON" + json.dumps(out))
"""

PORT = """
import json
from repro_torch.launch import dryrun as D
print("JSON" + json.dumps({{s: D.argument_bytes(D.cell_arguments("phi4-mini-3.8b", s, False))
                           for s in {shapes!r}}}))
"""


@pytest.fixture(scope="module")
def argument_bytes():
    """(the reference's, the port's) rank-0 argument bytes by shape."""
    ref = run_devices(REFERENCE.format(shapes=SHAPES), 512, 600)
    port = subprocess.run([sys.executable, "-c", PORT.format(shapes=SHAPES)],
                          capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert port.returncode == 0, port.stderr[-3000:]
    return (json.loads(ref.split("JSON", 1)[1]), json.loads(port.stdout.split("JSON", 1)[1]))


@pytest.mark.parametrize("shape", SHAPES)
def test_argument_bytes_equal_the_reference(argument_bytes, shape):
    """phi4-mini-3.8b on the 16 × 16 mesh: params (and, for train, the
    moments, master and count), the decode cache (weights replicated over
    the batch axes, as the reference's rule has them) and the inputs, rank
    0's shard of each."""
    ref, port = argument_bytes
    assert ref[shape] > 0 and port[shape] == ref[shape]
