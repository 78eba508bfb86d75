"""The port's replanning layer and MoE expert placement against the JAX
package's, on the CPU: ``repro_torch.core.replan`` and
``repro_torch.core.placement`` are numpy copies, so the same seeded
inputs must give exactly equal tables (groups, bridges, shares and the
traffic CSR), evacuations, rejoins and placements.  The inputs are
``tests/test_replan.py``'s and ``tests/test_serve_placement.py``'s."""
from __future__ import annotations

import numpy as np
import pytest

from tests._torch_parity import assert_same, both

N, G = 64, 8


def _tables(n=N, g=G):
    """``_table()`` of ``tests/test_replan.py`` built by each package:
    ``[(table, traffic, weights)]`` for the reference, then the port."""
    out = []
    for core in both("core"):
        graph, _ = core.planted_partition_graph(n, n_blocks=g, avg_degree=16,
                                                p_in_frac=0.85, seed=0)
        tm = core.TrafficMatrix.from_coo(graph.rows(), graph.indices, graph.edge_traffic(),
                                         n).symmetrized(halve=True)
        wg = np.ones(n)
        out.append((core.two_level_routing(tm, wg, g, seed=0), tm, wg))
    assert_same(out[0][0], out[1][0])
    return out


@pytest.mark.parametrize("seed", range(5))
def test_edit_sequences_give_the_reference_tables(seed):
    """``TestReplanInvariants.test_random_edit_sequences``'s three rounds
    of symmetric edits inside a random region, replanned by each."""
    results = []
    for core, (tb, _tm, wg) in zip(both("core"), _tables()):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(3):
            mem = rng.choice(tb.n_devices, 12, replace=False)
            s, d = rng.choice(mem, 10), rng.choice(mem, 10)
            keep = s != d
            delta = core.symmetric_delta(s[keep], d[keep],
                                         rng.uniform(0.2, 1.5, int(keep.sum())))
            res = core.replan(tb, wg, delta)
            res.table.validate()
            out.append(res)
            tb = res.table
        results.append(out)
    assert_same(*results)
    assert any(r.reelected_groups.size for r in results[1])


def test_empty_delta_gives_the_reference_identity():
    res = []
    for core, (tb, _tm, wg) in zip(both("core"), _tables()):
        e = np.empty(0, dtype=np.int64)
        res.append(core.replan(tb, wg, (e, e, np.empty(0))))
    assert_same(*res)
    assert res[1].moved_devices == 0


@pytest.mark.parametrize("region", [(1, 4), (2,), (0, 3, 5)])
def test_local_regroup_matches_reference(region):
    got = []
    for core, (tb, tm, wg) in zip(both("core"), _tables()):
        got.append(core.local_regroup(tm, wg, tb.group_of,
                                      np.array(region, dtype=np.int64), G))
    assert_same(*got)


def test_evacuate_device_and_fault_replan_match_reference():
    got = []
    for core, (tb, _tm, wg) in zip(both("core"), _tables()):
        dead = int(tb.bridge[tb.bridge >= 0].ravel()[0])
        delta, wg2, host = core.evacuate_device(tb, wg, dead)
        res = core.replan(tb, wg2, delta, dead=[dead])
        got.append((dead, delta, wg2, host, res))
    assert_same(*got)
    dead, res = got[1][0], got[1][4]
    assert not np.any(res.table.bridge == dead)


def _dead_sets(tb, tm):
    bridges = np.unique(tb.bridge[tb.bridge >= 0].ravel())
    i = int(np.argmax(tm.data))
    return {"bridges": [int(bridges[0]), int(bridges[-1])],
            "talking_pair": [int(tm.rows()[i]), int(tm.indices[i])],
            "three": [3, 17, 42]}


@pytest.mark.parametrize("which", ["bridges", "talking_pair", "three"])
def test_evacuate_devices_and_batch_replan_match_reference(which):
    got = []
    for core, (tb, tm, wg) in zip(both("core"), _tables()):
        dead = _dead_sets(tb, tm)[which]
        ev = core.evacuate_devices(tb, wg, dead)
        res = core.replan(tb, ev.wg_after, ev.delta, dead=dead)
        res.table.validate()
        got.append((ev, res))
    assert_same(*got)


@pytest.mark.parametrize("case", ["bridges", "same_group_host", "one_bridge"])
def test_rejoin_devices_matches_reference(case):
    """``TestRejoin``'s three round trips: evacuate → replan → rejoin."""
    got = []
    for core, (tb, tm, wg) in zip(both("core"), _tables()):
        hosts = None
        if case == "bridges":
            dead = _dead_sets(tb, tm)["bridges"]
        elif case == "one_bridge":
            dead = [int(tb.bridge[tb.bridge >= 0].ravel()[0])]
        else:
            rows, cols = tm.rows(), tm.indices
            i = int(np.flatnonzero(tb.group_of[rows] == tb.group_of[cols])[0])
            dead, hosts = [int(rows[i])], [int(cols[i])]
        ev = core.evacuate_devices(tb, wg, dead, hosts=hosts)
        res = core.replan(tb, ev.wg_after, ev.delta, dead=dead)
        back = core.rejoin_devices(res.table, ev)
        back.table.validate()
        got.append((res, back))
        np.testing.assert_array_equal(back.table.device_traffic.data, tm.data)
    assert_same(*got)


@pytest.mark.parametrize("bad", [
    ([], None, "no devices"), ([3, 3], None, "duplicate"), ([3, 4], [5], "1:1"),
    ([3, 4], [4, 5], "itself being evacuated"),
])
def test_evacuate_devices_rejects_what_the_reference_rejects(bad):
    dead, hosts, match = bad
    for core, (tb, _tm, wg) in zip(both("core"), _tables()):
        with pytest.raises(ValueError, match=match):
            core.evacuate_devices(tb, wg, dead, hosts=hosts)


@pytest.mark.parametrize("n_edits", [16, 40])
def test_replan_bench_edit_batch_matches_reference(n_edits):
    """``_edit_batch`` of ``benchmarks/replan_bench.py`` and the port's
    copy give the same delta, and the replanned tables agree."""
    from benchmarks.replan_bench import _edit_batch as ref_batch
    from repro_torch.analysis._support import _edit_batch as port_batch

    got = []
    for core, (tb, _tm, wg), batch in zip(both("core"), _tables(256, 16),
                                          (ref_batch, port_batch)):
        delta = batch(tb, 0, n_edits)
        got.append((delta, core.replan(tb, wg, delta)))
    assert_same(*got)


# ---------------------------------------------------------------------------
# MoE expert placement (``tests/test_serve_placement.py::TestPlacement``)
# ---------------------------------------------------------------------------


def _coact(e=32, clusters=4, seed=0):
    rng = np.random.default_rng(seed)
    labels = np.arange(e) % clusters
    c = rng.random((e, e)) * 1.0
    c += (labels[:, None] == labels[None, :]) * rng.random((e, e)) * 20.0
    c = (c + c.T) / 2
    np.fill_diagonal(c, 0)
    return rng.uniform(0.5, 2.0, e), c


@pytest.mark.parametrize("seed", [0, 7, 23, 50])
def test_placements_match_reference(seed):
    load, c = _coact(seed=seed)
    got = []
    for pl in both("core.placement"):
        got.append((pl.place_experts(load, c, 4, seed=seed),
                    pl.random_placement(32, 4, load, c, seed=seed),
                    pl.contiguous_placement(32, 4, load, c)))
    assert_same(*got)
    greedy = got[1][0]
    assert (np.bincount(greedy.assign, minlength=4) == 8).all()
    for s in range(4):
        assert (greedy.assign[greedy.perm[s * 8:(s + 1) * 8]] == s).all()
