"""The port's planning layer against the JAX package's, on the CPU: the
multilevel partitioner, Algorithm 2 with the multilevel grouping, the
dense parity oracle behind the routing measurements, the dispatch
accounting, the out-of-core planner and the ``brainsim`` launcher.  The
modules are numpy copies, so the same seeded inputs must give exactly
equal outputs."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from tests._torch_parity import assert_same, both, findings


def _brain(pkg_snn, n_populations: int, seed: int, **kw):
    kw = {"n_regions": max(8, n_populations // 16), "total_neurons": 10**7, **kw}
    return pkg_snn.generate_brain_model(n_populations=n_populations, seed=seed, **kw)


def _graphs(kind: str, seed: int):
    """The same seeded communication graph built by each package."""
    out = []
    for core, snn in zip(both("core"), both("snn")):
        if kind == "brain":
            out.append(_brain(snn, 600, seed).graph)
        elif kind == "planted":
            out.append(core.planted_partition_graph(
                400, n_blocks=16, avg_degree=12, p_in_frac=0.8, seed=seed)[0])
        else:
            out.append(core.watts_strogatz_graph(300, k=6, beta=0.1, seed=seed))
    assert_same(*out)
    return out


# ---------------------------------------------------------------------------
# multilevel partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,seed,n_parts", [
    ("brain", 0, 8), ("brain", 1, 16), ("planted", 2, 16), ("planted", 3, 5),
    ("ring", 4, 12),
])
def test_multilevel_partition_matches_reference(kind, seed, n_parts):
    ref_g, port_g = _graphs(kind, seed)
    ref, port = (core.multilevel_partition(g, n_parts, seed=seed)
                 for core, g in zip(both("core"), (ref_g, port_g)))
    assert port.method == "multilevel" and port.assign.shape == (ref_g.num_vertices,)
    assert_same(ref, port)


def test_multilevel_partition_without_greedy_guard_matches_reference():
    ref_g, port_g = _graphs("brain", 5)
    ref, port = (core.multilevel_partition(g, 16, seed=5, compare_greedy=False,
                                           coarsen_to=64)
                 for core, g in zip(both("core"), (ref_g, port_g)))
    assert len(port.history) > 1
    assert_same(ref, port)


# ---------------------------------------------------------------------------
# Algorithm 2: the multilevel grouping and the dense parity oracle
# ---------------------------------------------------------------------------


def _device_traffic(seed: int, n_dev: int = 32):
    out = []
    for core, snn in zip(both("core"), both("snn")):
        bm = _brain(snn, 400, seed)
        part = core.greedy_partition(bm.graph, n_dev, seed=seed)
        out.append(core.device_traffic_csr(bm.graph, part.assign, n_dev))
    assert_same(*out)
    return out


@pytest.mark.parametrize("seed,n_groups", [(0, 4), (1, 8)])
def test_multilevel_grouping_matches_reference(seed, n_groups):
    tables = [core.two_level_routing(t, wg, n_groups, grouping="multilevel", seed=seed)
              for core, (t, wg) in zip(both("core"), _device_traffic(seed))]
    assert tables[1].n_groups == n_groups
    assert_same(*tables)


@pytest.mark.parametrize("seed,n_groups", [(0, 4), (1, 8), (2, None)])
def test_dense_table_measurements_match_reference(seed, n_groups):
    """Tables that carry a dense ``[N, N]`` matrix go to the dense oracle
    in both packages; every measurement agrees exactly."""
    out = []
    for (core, routing, dense), (t, wg) in zip(
            zip(both("core"), both("core.routing"), both("core.routing_dense")),
            _device_traffic(seed)):
        t = t.to_dense()
        tables = {"two_level": dense.two_level_routing_dense(t, wg, n_groups, seed=seed),
                  "p2p": dense.p2p_routing_dense(t, wg)}
        got = {}
        for name, tb in tables.items():
            assert isinstance(tb.device_traffic, np.ndarray)
            got[name] = {
                "table": tb,
                "components": routing.connection_components(tb),
                "components_thr": routing.connection_components(tb, threshold=1.0),
                "counts": routing.connection_counts(tb),
                "level1": routing.level1_egress(tb),
                "level2": routing.level2_egress(tb),
            }
            if name == "two_level":
                got[name]["group_pair"] = routing.group_pair_traffic(tb)
        out.append(got)
    assert_same(*out)


def test_dense_oracle_agrees_with_csr_path_in_the_port():
    from repro_torch.core import routing, routing_dense

    t, wg = _device_traffic(3)[1]
    sparse = routing.two_level_routing(t, wg, 4, seed=3)
    dense = routing_dense.two_level_routing_dense(t.to_dense(), wg, 4, seed=3)
    assert np.array_equal(sparse.group_of, dense.group_of)
    assert np.array_equal(sparse.bridge, dense.bridge)
    for fn in (routing.level1_egress, routing.level2_egress, routing.group_pair_traffic):
        assert np.allclose(fn(sparse), fn(dense))
    for a, b in zip(routing.connection_components(sparse),
                    routing.connection_components(dense)):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# dispatch accounting (the numpy half of core/hierarchical.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pods,inner,chunk", [(1, 4, 8), (2, 4, 64), (3, 5, 1000)])
def test_dispatch_counts_match_reference(pods, inner, chunk):
    out = []
    for h in both("core.hierarchical"):
        out.append({
            two: (h.dispatch_bytes(pods, inner, chunk, two_level=two),
                  h.dispatch_messages(pods, inner, two_level=two),
                  h.dispatch_rounds(pods, inner, chunk, two_level=two))
            for two in (False, True)
        })
    assert_same(*out)


def test_dispatch_messages_from_table_matches_reference():
    out = []
    for (core, h, dense), (t, wg) in zip(
            zip(both("core"), both("core.hierarchical"), both("core.routing_dense")),
            _device_traffic(4)):
        out.append([h.dispatch_messages_from_table(tb, threshold=thr)
                    for tb in (core.two_level_routing(t, wg, 4, seed=4),
                               core.p2p_routing(t, wg),
                               dense.two_level_routing_dense(t.to_dense(), wg, 4, seed=4))
                    for thr in (0.0, 2.0)])
    assert_same(*out)
    assert out[1][0] == out[1][4]  # CSR and dense tables count alike


# ---------------------------------------------------------------------------
# the out-of-core planner at N = 400, pods of 100
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plans():
    out = []
    for core, snn in zip(both("core"), both("snn")):
        bm = _brain(snn, 1600, 0, n_regions=20, total_neurons=10**8,
                    inter_degree=12.0, long_range_frac=0.5)
        out.append(core.plan_out_of_core(bm.graph, 400, 100, block_size=4, seed=0,
                                         sym_mode="both"))
    return out


def test_out_of_core_plan_matches_reference_shard_by_shard(plans):
    ref, port = plans
    assert port.n_pods == 4 and len(port.shards) == 4
    assert port.shard_lint_errors == 0
    assert not any(f.severity == "error" for f in port.dcn_findings)
    assert port.peak_dense_elems < 400 * 400
    assert sorted(port.wall_s) == sorted(ref.wall_s)
    for i, (a, b) in enumerate(zip(ref.shards, port.shards)):
        assert np.array_equal(np.bincount(b.table.group_of), np.bincount(a.table.group_of))
        assert b.mesh_shape == a.mesh_shape
        assert_same(a.ragged_plan, b.ragged_plan, f"shard {i} ragged plan")
        assert_same(a.flows, b.flows, f"shard {i} ledger row")
        assert findings(a.findings) == findings(b.findings)
        assert a.n_lint_errors == b.n_lint_errors == 0
    assert_same(ref, port, "plan", skip=("wall_s",))


@pytest.mark.parametrize("seed", [0, 1])
def test_corrupted_flow_trips_pl160_in_both(plans, seed):
    out = []
    for plan, analysis in zip(plans, both("analysis")):
        flows = plan.shard_flows.copy()
        s, t = map(int, np.argwhere(flows > 0)[seed])
        flows[s, t] *= 1.5
        ctx = dataclasses.replace(plan.dcn_context, shard_flows=flows)
        out.append(findings(analysis.run_lints(ctx)))
    assert out[0] == out[1]
    hits = [f for f in out[1] if f[0] == "PL160"]
    assert hits and all(sev == "error" for _, sev, _ in hits)
    assert any("disagree" in msg for _, _, msg in hits)


def test_out_of_core_helpers_match_reference():
    out = []
    for core, traffic in zip(both("core"), both("core.traffic")):
        rng = np.random.default_rng(7)
        dense = rng.random((24, 24)) * (rng.random((24, 24)) < 0.3)
        np.fill_diagonal(dense, 0.0)
        src, dst = np.nonzero(dense)
        tm = traffic.TrafficMatrix.from_coo(src, dst, dense[src, dst], 24)
        group_of = rng.integers(0, 4, 24)
        out.append((core.default_groups_per_pod(100), core.default_groups_per_pod(16),
                    core.equalize_groups(tm, group_of, 4)))
    assert_same(*out)


# ---------------------------------------------------------------------------
# the launcher, python -m repro_torch.launch.brainsim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["multilevel", "greedy"])
def test_brainsim_launcher_partition_and_rasters(method, capsys):
    from repro.core import greedy_partition, multilevel_partition
    from repro.snn import generate_brain_model
    from repro_torch.launch import brainsim

    exchanges = ["flat", "two_level"] + (["sparse", "ragged"] if method == "multilevel" else [])
    res = brainsim.main(["--device", "cpu", "--method", method, "--steps", "60",
                         "--exchanges", *exchanges])
    bm = generate_brain_model(n_populations=128, n_regions=8, total_neurons=1_000_000, seed=0)
    fn = multilevel_partition if method == "multilevel" else greedy_partition
    assert_same(fn(bm.graph, 8), res["partition"])
    rasters = res["rasters"]
    assert list(rasters) == exchanges
    assert rasters["flat"].shape == (60, 512) and rasters["flat"].sum() > 0
    for exch in exchanges[1:]:
        assert np.array_equal(rasters[exch], rasters["flat"])
    out = capsys.readouterr().out
    assert "exchanges produce identical rasters ✓" in out
    assert f"method={method}" in out
