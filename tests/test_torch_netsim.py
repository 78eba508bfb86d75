"""The port's interconnect simulator against the JAX package's, on the
CPU: the same seeded schedules (sparse ppermute rounds, ragged plans,
Algorithm-2 tables, the hierarchical all-to-all) replayed on every
topology give exactly equal results — critical-path time, per-link
bytes, conservation — as do ``estimate(model="netsim")``, the exact
critical-path attribution and the trace events of ``obs.timeline``."""
from __future__ import annotations

import numpy as np
import pytest

from tests._torch_parity import assert_same, both

TOPOLOGIES = [("single_switch", ()), ("two_tier", (4,)), ("ring", ()), ("fat_tree", (4,))]


def _topologies(netsim, n: int):
    return [getattr(netsim, kind)(n, *args) for kind, args in TOPOLOGIES]


def _artifacts(seed: int):
    """Per package: 16-rank synapse tiles on a (4, 4) mesh, their ragged
    plan, and a two-level table over the same network's device traffic."""
    out = []
    for core, snn in zip(both("core"), both("snn")):
        bm = snn.generate_brain_model(n_populations=64, n_regions=8,
                                      total_neurons=10**6, seed=seed)
        syn, _ = snn.expand_synapses_sparse(bm.graph, 4, 16, seed=seed)
        plan = snn.build_ragged_plan(syn, (4, 4))
        part = core.greedy_partition(bm.graph, 16, seed=seed)
        t, wg = core.device_traffic_csr(bm.graph, part.assign, 16)
        out.append({"syn": syn, "plan": plan, "table": core.two_level_routing(t, wg, 4),
                    "p2p": core.p2p_routing(t, wg)})
    assert_same(out[0]["plan"], out[1]["plan"])
    return out


def _rounds(netsim, art) -> dict:
    syn = art["syn"]
    bb = syn.block_size * 4
    return {
        "sparse": netsim.sparse_rounds(syn.mask(), (4, 4), bb),
        "flat": netsim.flat_rounds((4, 4), bb),
        "ragged": netsim.ragged_rounds(art["plan"]),
        "table": netsim.table_rounds(art["table"], bytes_per_unit=100.0),
        "p2p_table": netsim.table_rounds(art["p2p"], bytes_per_unit=100.0),
        "a2a_two_level": netsim.a2a_rounds(4, 4, 256, two_level=True),
        "a2a_flat": netsim.a2a_rounds(4, 4, 256, two_level=False),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_replayed_rounds_match_reference(seed):
    out = [_rounds(netsim, art) for netsim, art in zip(both("netsim"), _artifacts(seed))]
    assert_same(*out)
    ref_ns, port_ns = both("netsim")
    for name in out[0]:
        assert port_ns.total_bytes(out[1][name]) == ref_ns.total_bytes(out[0][name])


@pytest.mark.parametrize("kind", [k for k, _ in TOPOLOGIES])
@pytest.mark.parametrize("barriers", [False, True])
def test_simulate_matches_reference_on_every_topology(kind, barriers):
    results = []
    for netsim, art in zip(both("netsim"), _artifacts(2)):
        topo = dict(zip([k for k, _ in TOPOLOGIES], _topologies(netsim, 16)))[kind]
        got = {}
        for name, rounds in _rounds(netsim, art).items():
            res = netsim.simulate(rounds, topo, alpha_msg=2e-6, barriers=barriers,
                                  collect_events=True)
            res.assert_conserved()
            assert res.bytes_delivered == res.bytes_injected == netsim.total_bytes(rounds)
            got[name] = res
        results.append(got)
    ref, port = results
    for name in ref:
        assert port[name].t_total == ref[name].t_total, name
        assert np.array_equal(port[name].link_bytes, ref[name].link_bytes), name
    assert_same(ref, port)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_random_schedules_with_outage_matches_reference(seed):
    out = []
    for netsim in both("netsim"):
        rng = np.random.default_rng(seed)
        rounds = [[netsim.Message(int(s), int(d), int(rng.integers(64, 8192)), r)
                   for s, d in rng.integers(0, 8, (12, 2)) if s != d]
                  for r in range(3)]
        topo = netsim.fat_tree(8, 4)
        up = int(topo.params["leaf_up"][0][0])
        outage = [netsim.LinkOutage(link=up, t_down=0.0, t_up=2e-5)]
        out.append([netsim.simulate(rounds, topo, alpha_msg=1e-6, outages=outage,
                                    collect_hops=True),
                    netsim.simulate(rounds, netsim.two_tier(8, 4), barriers=True)])
    assert_same(*out)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_estimate_netsim_matches_reference(noise):
    out = []
    for (core, netsim), art in zip(zip(both("core"), both("netsim")), _artifacts(3)):
        cl = core.ClusterModel()
        out.append([core.estimate(art[k], cl, model="netsim", noise=noise, topology=topo)
                    for k in ("table", "p2p")
                    for topo in (None, netsim.two_tier(16, 4))]
                   + [core.estimate(art["table"], cl, model="closed_form", noise=noise)])
    assert_same(*out)
    sim = out[1][0]
    assert sim.t_total > sim.t_compute > 0


def test_estimate_netsim_rejects_a_mismatched_topology():
    from repro_torch import netsim
    from repro_torch.core import estimate

    tb = _artifacts(0)[1]["table"]
    with pytest.raises(ValueError, match="devices"):
        estimate(tb, model="netsim", topology=netsim.single_switch(5))


@pytest.mark.parametrize("barriers", [False, True])
def test_critical_path_and_trace_events_match_reference(barriers):
    out = []
    for (netsim, obs), art in zip(zip(both("netsim"), both("obs")), _artifacts(4)):
        got = {}
        for name, rounds in _rounds(netsim, art).items():
            for topo in _topologies(netsim, 16):
                res = netsim.simulate(rounds, topo, alpha_msg=2e-6, barriers=barriers,
                                      collect_hops=True)
                att = obs.attribute_critical_path(res)
                assert att.conserved
                got[f"{name}/{topo.name}"] = (att, obs.trace_events(res, anchor_us=5.0))
        out.append(got)
    assert_same(*out)


def test_simulation_spans_reach_only_the_port_tracer():
    """Each package has its own process-global tracer: a traced replay in
    the port emits into the port's tracer and leaves the reference's empty."""
    ref_obs, port_obs = both("obs")
    ref_ns, port_ns = both("netsim")
    for o in (ref_obs, port_obs):
        o.disable()
        o.clear()
    port_obs.enable()
    try:
        rounds = [[port_ns.Message(0, 1, 4096), port_ns.Message(2, 3, 4096)]]
        port_ns.simulate(rounds, port_ns.two_tier(4, 2))
    finally:
        port_obs.disable()
    assert port_obs.events() and not ref_obs.events()
    port_obs.clear()


def test_whatif_matches_reference():
    out = []
    for netsim, art in zip(both("netsim"), _artifacts(5)):
        plan = art["plan"]
        out.append((netsim.sharded_ragged_rounds(plan),
                    netsim.payload_sharding_whatif(plan, {"fat_tree": netsim.fat_tree(16, 4)},
                                                   alpha_msg=2e-6, byte_scale=64.0)))
    assert_same(*out)


def test_topology_config_matches_reference():
    cfg = {"kind": "two_tier", "n_devices": 16, "pod_size": 4, "dcn_oversub": 2.0}
    out = []
    for netsim in both("netsim"):
        topo = netsim.topology_from_config(cfg)
        out.append((topo, [topo.route(s, d) for s in range(16) for d in range(16)]))
    assert_same(*out)
