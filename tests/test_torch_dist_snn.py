"""The distributed engine with one rank per process: ``DistributedSNN``
over a gloo ``ProcessGroupComm`` on a ``(2, 2)`` mesh of 4 processes, for
every exchange, at ``noise_sigma`` 0 and 2.  Each process runs its own
rank; the gathered raster and the summed per-step slow-axis bytes equal
the loopback's (every rank in one process) bit for bit, and at noise 0 the
raster equals the JAX reference engine's.  Rank ``d``'s noise key is row
``d`` of ``split(PRNGKey(seed), n_dev)`` wherever it runs, the key the
reference's ``shard_map`` hands device ``d``: at ``noise_sigma=2`` under a
scalar drive (the reference's distributed engine takes no per-neuron one)
the processes' raster equals the reference's distributed engine's on 4
fake host devices.  Also: the launcher under ``torch.distributed.run``, and
the engine's refusals."""
from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.snn import BlockSynapses, DistributedSNN, LIFParams, LoopbackComm
from tests._torch_dist import snn_runs, spawn
from tests.test_snn_sparse import _clustered_w
from tests.test_torch_snn import (
    NOISY, STEPS, _assert_sustained, _drive, _jax_noisy_distributed, _jax_raster,
)

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 2)
N_BLOCKS = 4
M = 64
EXCHANGES = ("flat", "two_level", "sparse", "ragged")
CONFIGS = tuple((ex, noise) for ex in EXCHANGES for noise in (0.0, 2.0))
# noisy runs under the reference launcher's scalar drive, held to the
# reference's distributed engine
SCALAR = tuple((ex, 2.0, NOISY["lif"][2]) for ex in EXCHANGES)


def _engine(exchange: str, noise: float) -> DistributedSNN:
    w = _clustered_w(M, N_BLOCKS)
    kw = {"w_syn": w} if exchange in ("flat", "two_level") else {
        "syn": BlockSynapses.from_dense(w, N_BLOCKS)}
    return DistributedSNN(mesh=MESH, params=LIFParams(noise_sigma=noise), exchange=exchange,
                          i_ext=_drive(M), device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _loopback(exchange: str, noise: float) -> tuple[np.ndarray, list[int]]:
    comm = LoopbackComm(MESH, "cpu")
    raster = _engine(exchange, noise).run(STEPS, seed=3, comm=comm).numpy()
    return raster, comm.step_bytes


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    return spawn(snn_runs, N_BLOCKS, tmp_path_factory.mktemp("snn"), MESH,
                 _clustered_w(M, N_BLOCKS), _drive(M), CONFIGS + SCALAR, STEPS, timeout=240)


@pytest.mark.parametrize("exchange,noise", CONFIGS, ids=lambda v: str(v))
def test_raster_equals_loopback(processes, exchange, noise):
    want, _ = _loopback(exchange, noise)
    _assert_sustained(want)
    b = M // N_BLOCKS
    for rank, res in enumerate(processes):
        got = res[(exchange, noise)]
        np.testing.assert_array_equal(got["raster"], want, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["local"], want[:, rank * b:(rank + 1) * b])


@pytest.mark.parametrize("exchange,noise", CONFIGS, ids=lambda v: str(v))
def test_ledger_equals_loopback(processes, exchange, noise):
    _, want = _loopback(exchange, noise)
    assert len(want) == STEPS and want[0] > 0
    summed = np.sum([res[(exchange, noise)]["step_bytes"] for res in processes], axis=0)
    assert summed.tolist() == want
    for res in processes:
        assert res[(exchange, noise)]["ledger_total"] == want


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_noise_free_raster_equals_jax(processes, exchange):
    np.testing.assert_array_equal(processes[0][(exchange, 0.0)]["raster"],
                                  _jax_raster(M, N_BLOCKS))


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_noisy_raster_equals_jax(processes, exchange):
    """At ``noise_sigma=2`` every process gathers the reference's
    distributed raster for the same seed, bit for bit."""
    want = _jax_noisy_distributed(MESH, N_BLOCKS, STEPS)["lif", exchange]
    _assert_sustained(want)
    for rank, res in enumerate(processes):
        np.testing.assert_array_equal(res[(exchange, 2.0, NOISY["lif"][2])]["raster"], want,
                                      err_msg=f"rank {rank}")


def test_tiles_staged_for_the_rank_held(processes):
    """A process rank given its own rank's tiles (``tile_ranks``) runs on
    them; given another rank's, it refuses instead of computing the wrong
    currents."""
    want, _ = _loopback("sparse", 0.0)
    for rank, res in enumerate(processes):
        np.testing.assert_array_equal(res["own_tiles"], want, err_msg=f"rank {rank}")
        other = (rank + 1) % N_BLOCKS
        assert res["other_tiles"] == f"tiles hold ranks {other}..{other}, not {rank}..{rank}"


def test_tile_ranks_validation():
    """``tiles`` must hold exactly the rows ``tile_ranks`` names (every
    rank when omitted), and ``tile_ranks`` needs ``tiles``."""
    import torch

    from repro_torch import convert

    syn = BlockSynapses.from_dense(_clustered_w(M, N_BLOCKS), N_BLOCKS)
    one = convert.padded_tiles(syn, "cpu", ranks=range(1, 2))

    def make(**kw):
        return DistributedSNN(mesh=MESH, params=LIFParams(), exchange="sparse", syn=syn,
                              device="cpu", **kw)

    with pytest.raises(ValueError, match="do not hold these synapses"):
        make(tiles=one)  # one rank's row, read as every rank's
    with pytest.raises(ValueError, match="do not hold these synapses"):
        make(tiles=one, tile_ranks=range(1, 3))
    with pytest.raises(ValueError, match="a run of the mesh's 4 ranks"):
        make(tiles=one, tile_ranks=range(4, 5))
    with pytest.raises(ValueError, match="names the rows of tiles="):
        make(tile_ranks=range(1, 2))
    with pytest.raises(ValueError, match="tiles hold ranks 1..1, not 0..3"):
        make(tiles=one, tile_ranks=range(1, 2)).run(2)  # the loopback holds every rank
    every = convert.padded_tiles(syn, "cpu")
    got = make(tiles=every, i_ext=_drive(M)).run(STEPS, seed=3)
    np.testing.assert_array_equal(got.numpy(), _loopback("sparse", 0.0)[0])
    assert isinstance(got, torch.Tensor)


def test_noise_reaches_the_raster():
    """Channel noise changes the raster: the noisy parity above compares
    two runs that draw from the keys."""
    assert not np.array_equal(_loopback("ragged", 2.0)[0], _loopback("ragged", 0.0)[0])


def test_graph_needs_a_capturable_comm():
    """A communicator a CUDA graph cannot capture (gloo) refuses a
    replayed run instead of running it eagerly."""

    class Uncapturable(LoopbackComm):
        capturable = False
        backend = "gloo"

    eng = _engine("sparse", 0.0)
    object.__setattr__(eng, "graph", True)  # as on the card
    with pytest.raises(ValueError, match="cannot capture"):
        eng.run(2, comm=Uncapturable(MESH, "cpu"))
    with pytest.raises(ValueError, match="communicator mesh"):
        _engine("sparse", 0.0).run(2, comm=LoopbackComm((4,), "cpu"))


def test_launcher_under_torch_distributed_run(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.run_brainsim --device cpu --ranks 4`` prints the
    loopback launcher's lines plus the executed ledger, which equals the
    plan's bytes; ``--save`` holds the raster every rank gathered (the
    loopback's) and each rank's kernel launches."""
    import contextlib
    import io
    import json

    from repro_torch.launch import run_brainsim

    argv = ["--device", "cpu", "--ranks", "4", "--exchange", "ragged", "--noise", "2",
            "--steps", "60"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")]))}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.run_brainsim", *argv, "--save", str(tmp_path / "run.npz")],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = run_brainsim.main(argv)  # the loopback, in this process
    stats = res["stats"]
    assert lines[-1] == (f"executed slow-axis bytes/step over 4 processes (gloo): "
                         f"{stats['ragged']}")
    assert lines[:-1] == printed.getvalue().strip().splitlines()
    assert int(res["raster"].sum()) > 0
    with np.load(tmp_path / "run.npz") as saved:
        np.testing.assert_array_equal(saved["raster"], res["raster"])
        assert saved["ledger"].tolist() == res["ledger"] == [stats["ragged"]] * 60
        assert len(set(saved["digests"].tolist())) == 1
        launches = json.loads(str(saved["launches"]))
    # on the CPU K1's plain version runs and counts nothing (the card's
    # run, chip_smoke.py's phase comm, holds each rank to 60)
    assert [r["spike_accum_blocks"] for r in launches] == [0] * 4


def test_launcher_ranks_must_match_world(monkeypatch):
    from repro_torch.launch import run_brainsim

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--ranks 4 != WORLD_SIZE 2"):
        run_brainsim.main(["--device", "cpu", "--ranks", "4", "--steps", "1"])
