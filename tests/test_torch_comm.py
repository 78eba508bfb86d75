"""The port's ``ProcessGroupComm`` — one rank per process over
``torch.distributed`` — against ``LoopbackComm``, every rank in one
process: each collective on gloo ``(4,)``, ``(2, 2)`` and ``(2, 4)`` meshes
gives every rank the row the loopback gives it, bit for bit, on the same
seeded integer-valued inputs; each rank's ledger sums to the loopback's,
and so does ``ledger_total()``.  The backend rules are checked in one
process."""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch.snn import LoopbackComm, ProcessGroupComm
from tests._torch_dist import (
    COMM_CALLS, comm_call, comm_calls, comm_input, comm_inputs, comm_pairs, spawn,
)

MESHES = [(4,), (2, 2), (2, 4)]
NAMES = [name for name, _m, _a in COMM_CALLS]


@functools.lru_cache(maxsize=None)
def _runs(mesh: tuple[int, ...], tmp: str):
    """(the loopback's results and ledger, each process rank's)."""
    inputs, pairs = comm_inputs(mesh), comm_pairs(mesh)
    loop = LoopbackComm(mesh, "cpu")
    want = {}
    for name, method, arg in COMM_CALLS:
        loop.new_step()
        x = torch.from_numpy(comm_input(inputs, method))
        want[name] = comm_call(loop, method, arg, x, pairs).numpy()
    n = int(np.prod(mesh))
    got = spawn(comm_calls, n, f"{tmp}/{'x'.join(map(str, mesh))}", mesh, inputs, pairs)
    return {"results": want, "step_bytes": loop.step_bytes}, got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("comm"))
    return lambda mesh: _runs(mesh, tmp)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_method_equals_loopback(runs, mesh, name):
    want, got = runs(mesh)
    full = want["results"][name]
    for rank, res in enumerate(got):
        row = full if name == "collect" else full[rank:rank + 1]
        np.testing.assert_array_equal(res["results"][name], row, err_msg=f"rank {rank}")


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_ledger_equals_loopback(runs, mesh):
    """Each rank charges what it receives across the slow axis: the ranks'
    ledgers sum to the loopback's step by step, and ``ledger_total()``
    gives that sum on every rank."""
    want, got = runs(mesh)
    summed = np.sum([res["step_bytes"] for res in got], axis=0).tolist()
    assert summed == want["step_bytes"]
    for res in got:
        assert res["ledger_total"] == want["step_bytes"]
    g = mesh[0]
    if g > 1:  # something crossed the slow axis
        assert want["step_bytes"][NAMES.index("all_gather/slow")] > 0
    assert want["step_bytes"][NAMES.index("all_gather/inner")] == 0


def test_loopback_interface():
    """The loopback holds every rank; its axis groups are ordered by rank."""
    comm = LoopbackComm((2, 4), "cpu")
    assert comm.ranks == range(8) and comm.capturable
    assert comm.members("inner", 5) == [4, 5, 6, 7]
    assert comm.members("slow", 5) == [1, 5]
    assert comm.members("joint", 5) == list(range(8))
    with pytest.raises(ValueError, match="unknown axis"):
        comm.psum(torch.zeros(8, 2), "bogus")
    with pytest.raises(ValueError, match="one block per member"):
        comm.all_to_all(torch.zeros(8, 3, 2), "inner")


def test_backend_rules(monkeypatch):
    """Only nccl on CUDA tensors and gloo on CPU or (staged) CUDA tensors;
    the process group must be initialised, run that backend and hold the
    mesh's ranks."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="does not take cpu"):
        ProcessGroupComm((2,), "nccl", "cpu")
    with pytest.raises(ValueError, match="does not take"):
        ProcessGroupComm((2,), "mpi", "cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        ProcessGroupComm((2,), "gloo", "cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    with pytest.raises(ValueError, match="runs 'gloo', not 'nccl'"):
        ProcessGroupComm((2,), "nccl", "cuda")
    with pytest.raises(ValueError, match="world size 4 != 2"):
        ProcessGroupComm((2,), "gloo", "cpu")


def test_rank_device(monkeypatch):
    """The card of a process rank: NCCL one per local rank (two ranks on a
    card refused), gloo the cards shared round robin, so ``--backend
    gloo`` under ``torch.distributed.run`` runs 4 ranks on one card."""
    from repro_torch.multiproc import rank_device

    assert rank_device("gloo", "cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [rank_device("gloo", "cuda", i) for i in range(4)] == [torch.device("cuda", 0)] * 4
    assert rank_device("nccl", "cuda", 0) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="one card per rank: local rank 1"):
        rank_device("nccl", "cuda", 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_device("gloo", "cuda", 5) == torch.device("cuda", 1)
    assert rank_device("nccl", "cuda", 3) == torch.device("cuda", 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="sees no card"):
        rank_device("gloo", "cuda", 0)
