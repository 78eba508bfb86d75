"""Spawn ``n`` gloo ranks on the CPU for a test of the port's process-group
path, and the functions those ranks run.

:func:`spawn` runs ``fn(rank, n, *args)`` in ``n`` gloo ranks through
:func:`repro_torch.multiproc.spawn`, with the ``file://`` store in the
test's own directory (no TCP port, so parallel test workers never
collide) and a timeout per spawn: a rank that raises fails the test with
its traceback, and a run that outlasts ``timeout`` seconds (a collective
posted by some ranks only would otherwise hang) is killed and fails it.

The rank functions live here, not in the test modules, so that a spawned
rank imports torch and the port only — never JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import multiproc

__all__ = ["spawn", "COMM_CALLS", "comm_inputs", "comm_pairs", "comm_call", "comm_input",
           "comm_calls", "snn_runs", "hierarchical_calls"]


def spawn(fn, n: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """``[fn(rank, n, *args) for rank in range(n)]``, each in its own gloo
    rank on the CPU."""
    return multiproc.spawn(fn, n, *args, backend="gloo", device="cpu", timeout=timeout,
                           workdir=tmp_path)


# -- ProcessGroupComm, method by method --------------------------------------

#: ``(name, method, axis or pairs)`` — each call of :func:`comm_calls`,
#: one ledger step each
COMM_CALLS = (
    ("all_gather/inner", "all_gather", "inner"),
    ("all_gather/slow", "all_gather", "slow"),
    ("all_gather/joint", "all_gather", "joint"),
    ("psum/inner", "psum", "inner"),
    ("psum/slow", "psum", "slow"),
    ("psum/joint", "psum", "joint"),
    ("all_to_all/inner", "all_to_all", "inner"),
    ("all_to_all/slow", "all_to_all", "slow"),
    ("all_to_all/joint", "all_to_all", "joint"),
    ("psum_scatter/inner", "psum_scatter", "inner"),
    ("psum_scatter/slow", "psum_scatter", "slow"),
    ("psum_scatter/joint", "psum_scatter", "joint"),
    ("ppermute/slow", "ppermute", "slow"),
    ("ppermute/joint", "ppermute", "joint"),
    ("collect", "collect", None),
)


def comm_inputs(mesh: tuple[int, ...], seed: int = 0) -> dict[str, np.ndarray]:
    """Seeded rank-stacked inputs ``[n_dev, ...]`` for each call: integer
    values in float32, so every sum is exact in any order."""
    n = int(np.prod(mesh))
    rng = np.random.default_rng(seed)

    def ints(*shape):
        return rng.integers(-50, 50, size=(n, *shape)).astype(np.float32)

    blocks = 2 * n  # divisible by every axis group's size
    return {"flat": ints(3, 2), "sum": ints(blocks, 3), "blocks": ints(blocks, 2)}


def comm_pairs(mesh: tuple[int, ...]) -> dict[str, tuple]:
    """ppermute pairs: a shift across groups (``"slow"``) and a partial
    rank permutation that leaves some ranks untargeted (``"joint"``)."""
    g = mesh[0]
    n = int(np.prod(mesh))
    slow = tuple((s, (s + 1) % g) for s in range(g))
    joint = tuple((s, (s + 3) % n) for s in range(0, n, 2))
    return {"slow": slow, "joint": joint}


def comm_call(comm, method: str, arg, x: torch.Tensor, pairs: dict) -> torch.Tensor:
    """One call of :data:`COMM_CALLS` on ``x`` (the rows ``comm`` holds)."""
    if method == "collect":
        return comm.collect(x)
    if method == "ppermute":
        return comm.ppermute(x, pairs[arg], arg)
    if method == "all_to_all":
        k = len(comm.members(arg, comm.ranks.start))
        return getattr(comm, method)(x.reshape(x.shape[0], k, -1, *x.shape[2:]), arg)
    return getattr(comm, method)(x, arg)


def comm_input(inputs: dict, method: str) -> np.ndarray:
    return inputs["flat"] if method in ("all_gather", "ppermute", "collect") else (
        inputs["sum"] if method in ("psum", "psum_scatter") else inputs["blocks"])


def comm_calls(rank: int, n: int, mesh: tuple[int, ...], inputs: dict, pairs: dict) -> dict:
    """Every call of :data:`COMM_CALLS` through a gloo ``ProcessGroupComm``
    on this rank's row of ``inputs``; the results, the rank's ledger and
    the summed one."""
    from repro_torch.snn import ProcessGroupComm

    comm = ProcessGroupComm(mesh, "gloo", "cpu")
    assert comm.ranks == range(rank, rank + 1) and not comm.capturable
    out = {}
    for name, method, arg in COMM_CALLS:
        comm.new_step()
        x = torch.from_numpy(comm_input(inputs, method)[rank:rank + 1].copy())
        out[name] = comm_call(comm, method, arg, x, pairs).numpy()
    return {"results": out, "step_bytes": list(comm.step_bytes),
            "ledger_total": comm.ledger_total()}


# -- the distributed engine ---------------------------------------------------


def snn_runs(rank: int, n: int, mesh: tuple[int, ...], w: np.ndarray, drive: np.ndarray,
             configs: tuple, steps: int) -> dict:
    """``DistributedSNN`` over a gloo ``ProcessGroupComm`` for each
    ``(exchange, noise_sigma)`` of ``configs``: the rank's raster, the
    gathered global raster, the rank's ledger and the summed one."""
    from repro_torch import convert
    from repro_torch.snn import (
        BlockSynapses, DistributedSNN, LIFParams, ProcessGroupComm, gather_raster,
    )

    syn = BlockSynapses.from_dense(w, n)
    out = {}
    for exchange, noise in configs:
        kw = {"w_syn": w} if exchange in ("flat", "two_level") else {"syn": syn}
        eng = DistributedSNN(mesh=mesh, params=LIFParams(noise_sigma=noise),
                             exchange=exchange, i_ext=drive, device="cpu", **kw)
        comm = ProcessGroupComm(mesh, "gloo", "cpu")
        local = eng.run(steps, seed=3, comm=comm)
        out[(exchange, noise)] = {
            "local": local.numpy(), "raster": gather_raster(local, comm).numpy(),
            "step_bytes": list(comm.step_bytes), "ledger_total": comm.ledger_total(),
        }
    # tiles staged by the caller for the rank held (tile_ranks names them),
    # and another rank's tiles, which the engine must refuse
    held, other = range(rank, rank + 1), range((rank + 1) % n, (rank + 1) % n + 1)
    comm = ProcessGroupComm(mesh, "gloo", "cpu")
    own = DistributedSNN(mesh=mesh, params=LIFParams(), exchange="sparse", i_ext=drive,
                         syn=syn, device="cpu", tiles=convert.padded_tiles(syn, "cpu", ranks=held),
                         tile_ranks=held)
    out["own_tiles"] = gather_raster(own.run(steps, seed=3, comm=comm), comm).numpy()
    wrong = DistributedSNN(mesh=mesh, params=LIFParams(), exchange="sparse", i_ext=drive,
                           syn=syn, device="cpu", tiles=convert.padded_tiles(syn, "cpu", ranks=other),
                           tile_ranks=other)
    try:
        wrong.run(steps, seed=3, comm=comm)
        out["other_tiles"] = "ran"
    except ValueError as e:
        out["other_tiles"] = str(e)
    return out


# -- the hierarchical collectives ----------------------------------------------


def hierarchical_calls(rank: int, n: int, mesh: tuple[int, ...], a2a: np.ndarray,
                       grad: np.ndarray, shards: np.ndarray) -> dict:
    """``repro_torch.core.hierarchical`` over a gloo ``ProcessGroupComm``
    on this rank's part of ``tests/test_hierarchical.py``'s inputs."""
    from repro_torch.core import hierarchical as h
    from repro_torch.snn import ProcessGroupComm

    comm = ProcessGroupComm(mesh, "gloo", "cpu")
    flat, two = h.make_exchange_fns(comm)
    x = torch.from_numpy(a2a[rank:rank + 1].copy())
    g = torch.from_numpy(grad[None].copy())  # replicated on every rank
    s = torch.from_numpy(shards[rank:rank + 1].copy())
    return {"flat": flat(x).numpy(), "two_level": two(x).numpy(),
            "hierarchical_psum": h.hierarchical_psum(g, comm).numpy(),
            "flat_psum": h.flat_psum(g, comm).numpy(),
            "two_level_all_gather": h.two_level_all_gather(s, comm).numpy(),
            "ledger_total": comm.ledger_total()}
