"""The port's hierarchical collectives (``repro_torch.core.hierarchical``)
against the reference's (``repro.core.hierarchical``), on the inputs of
``tests/test_hierarchical.py``: the reference runs in ``shard_map`` on 8
fake devices of a ``(2, 4)`` mesh (``tests.conftest.run_devices``), the
port behind a ``LoopbackComm`` and over 8 gloo processes.  The inputs are
integer-valued float32, so every sum is exact: the results are compared
bit for bit.  At one rank each function is the identity."""
from __future__ import annotations

import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.core import hierarchical as h
from repro_torch.snn import LoopbackComm
from tests._torch_dist import hierarchical_calls, spawn
from tests.conftest import run_devices

MESH = (2, 4)
N = 8
#: tests/test_hierarchical.py:15 (the all-to-all) and :35 (the psum and
#: the all-gather)
A2A = np.arange(N * N * 3 * 5, dtype=np.float32).reshape(N, N, 3, 5)
GRAD = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
SHARDS = np.arange(N * 3, dtype=np.float32).reshape(N, 1, 3)
FUNCS = ("flat", "two_level", "hierarchical_psum", "flat_psum", "two_level_all_gather")

REFERENCE = """
import functools, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core.hierarchical import (make_exchange_fns, hierarchical_psum, flat_psum,
                                     two_level_all_gather)
mesh = make_mesh((2, 4), ("pod", "data"))
x = jnp.arange(8*8*3*5, dtype=jnp.float32).reshape(8, 8, 3, 5)
x = jax.device_put(x, NamedSharding(mesh, P(("pod","data"))))
flat, two = make_exchange_fns(mesh)
g = jnp.arange(16*4, dtype=jnp.float32).reshape(16, 4)
wrap = lambda f: jax.jit(functools.partial(
    shard_map, mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False)(f))
xs = jnp.arange(8*3, dtype=jnp.float32).reshape(8, 3)
ag = jax.jit(functools.partial(
    shard_map, mesh=mesh, in_specs=(P(("pod","data")),), out_specs=P(),
    check_vma=False)(lambda v: two_level_all_gather(v)))
out = {"flat": flat(x), "two_level": two(x),
       "hierarchical_psum": wrap(lambda v: hierarchical_psum(v))(g),
       "flat_psum": wrap(lambda v: flat_psum(v, ("pod", "data")))(g),
       "two_level_all_gather": ag(xs)}
print("OUT=" + json.dumps({k: np.asarray(v).tolist() for k, v in out.items()}))
"""


@functools.lru_cache(maxsize=None)
def _reference() -> dict[str, np.ndarray]:
    line = next(l for l in run_devices(REFERENCE).splitlines() if l.startswith("OUT="))
    return {k: np.asarray(v, dtype=np.float32) for k, v in json.loads(line[4:]).items()}


def _want(name: str, rank: int) -> np.ndarray:
    """What rank ``rank`` holds of the reference's result: its row of the
    exchanged array, or the replicated sum / gather."""
    ref = _reference()[name]
    return ref[rank:rank + 1] if name in ("flat", "two_level") else ref[None]


def _loopback() -> dict[str, np.ndarray]:
    comm = LoopbackComm(MESH, "cpu")
    flat, two = h.make_exchange_fns(comm)
    x = torch.from_numpy(A2A)
    g = torch.from_numpy(np.broadcast_to(GRAD, (N, *GRAD.shape)).copy())
    s = torch.from_numpy(SHARDS)
    return {"flat": flat(x).numpy(), "two_level": two(x).numpy(),
            "hierarchical_psum": h.hierarchical_psum(g, comm).numpy(),
            "flat_psum": h.flat_psum(g, comm).numpy(),
            "two_level_all_gather": h.two_level_all_gather(s, comm).numpy()}


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    return spawn(hierarchical_calls, N, tmp_path_factory.mktemp("hier"), MESH,
                 A2A, GRAD, SHARDS)


@pytest.mark.parametrize("name", FUNCS)
def test_loopback_equals_reference(name):
    got = _loopback()[name]
    for rank in range(N):
        np.testing.assert_array_equal(got[rank:rank + 1], _want(name, rank),
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", FUNCS)
def test_processes_equal_reference(processes, name):
    for rank, res in enumerate(processes):
        np.testing.assert_array_equal(res[name], _want(name, rank), err_msg=f"rank {rank}")


def test_two_level_equals_flat_and_transposes():
    """The reference test's own checks, on the port: the two schedules
    agree, and rank d's row s is what rank s sent to d."""
    got = _loopback()
    np.testing.assert_array_equal(got["flat"], got["two_level"])
    np.testing.assert_array_equal(got["flat"][3, 5], A2A[5, 3])
    np.testing.assert_array_equal(got["flat"][0, 7], A2A[7, 0])


def test_ledgers_agree(processes):
    """The gloo ranks' summed ledger equals the loopback's for the same
    calls, and the two-level all-to-all crosses the slow axis with the same
    bytes as the flat one (fewer messages, not fewer bytes)."""
    comm = LoopbackComm(MESH, "cpu")
    flat, two = h.make_exchange_fns(comm)
    x = torch.from_numpy(A2A)
    for fn in (flat, two):
        comm.new_step()
        fn(x)
    g = torch.from_numpy(np.broadcast_to(GRAD, (N, *GRAD.shape)).copy())
    for fn in (h.hierarchical_psum, h.flat_psum):
        comm.new_step()
        fn(g, comm)
    comm.new_step()
    h.two_level_all_gather(torch.from_numpy(SHARDS), comm)
    for res in processes:
        assert res["ledger_total"] == [sum(comm.step_bytes)]
    chunk = A2A[0, 0].nbytes
    assert comm.step_bytes[0] == comm.step_bytes[1] == N * 4 * chunk  # 4 remote ranks each


def test_one_rank_is_identity():
    comm = LoopbackComm((1, 1), "cpu")
    x = torch.arange(30, dtype=torch.float32).reshape(1, 1, 6, 5)
    flat, two = h.make_exchange_fns(comm)
    for out in (flat(x), two(x), h.flat_psum(x[0], comm), h.hierarchical_psum(x[0], comm),
                h.two_level_all_gather(x[0], comm)):
        np.testing.assert_array_equal(out.reshape(x.shape).numpy(), x.numpy())
    assert comm.step_bytes == [0]
