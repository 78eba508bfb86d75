"""Seeded benchmark scenarios as planlint contexts.

One constructor per benchmark family (fig3a / fig3b / table2 /
snn_throughput / replan_bench), each reproducing the corresponding
benchmark's seed pipeline at a reduced but structure-preserving scale
and returning the :class:`~repro_torch.analysis.context.PlanContext` list the
CLI lints.  CI runs ``python -m repro_torch.analysis --all`` as a blocking
job, so every artifact family the benchmarks measure is verified on
every push.

Constructors are deterministic (fixed seeds, same generators as the
benchmarks) and CPU-cheap — the whole suite lints in seconds.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.context import PlanContext

__all__ = ["SCENARIOS", "build_scenario", "scenario_names"]


def _fig3a() -> list[PlanContext]:
    """Partition-stage artifacts: brain model + random/greedy partitions
    + the device traffic they induce (the fig3a measurement chain)."""
    from repro_torch.analysis._support import build_device_traffic
    from repro_torch.core import greedy_partition, random_partition
    from repro_torch.snn import generate_brain_model

    n_dev = 32
    bm = generate_brain_model(
        n_populations=256, n_regions=16, total_neurons=10**6, seed=0
    )
    out = []
    parts = {
        "random": random_partition(bm.graph, n_dev, seed=0, balanced=True),
        "greedy": greedy_partition(bm.graph, n_dev, itermax=6, seed=0),
    }
    for label, part in parts.items():
        tm, wg = build_device_traffic(bm, part.assign, n_dev)
        out.append(
            PlanContext(
                name=f"fig3a/{label}",
                graph=bm.graph,
                partition=part.assign,
                n_parts=n_dev,
                traffic=tm,
                wg=wg,
            )
        )
    return out


def _fig3b() -> list[PlanContext]:
    """Routing-stage artifacts: P2P vs GA vs greedy Algorithm-2 tables
    on the same device traffic, over the paper's pod/DCN fabric."""
    from repro_torch.analysis._support import build_device_traffic, paper_fabric
    from repro_torch.core import greedy_partition, p2p_routing, two_level_routing
    from repro_torch.snn import generate_brain_model

    n_dev = 64
    bm = generate_brain_model(
        n_populations=256, n_regions=16, total_neurons=10**6, seed=0
    )
    part = greedy_partition(bm.graph, n_dev, itermax=6, seed=0)
    tm, wg = build_device_traffic(bm, part.assign, n_dev)
    topo = paper_fabric(n_dev)
    greedy = two_level_routing(tm, wg, 8, seed=0, grouping="greedy")
    ga = two_level_routing(tm, wg, 8, seed=0, grouping="genetic")
    return [
        PlanContext.from_table(
            p2p_routing(tm, wg), name="fig3b/p2p", wg=wg, topology=topo
        ),
        # GA grouping trades balance for cut (the paper's Fig. 3(b)
        # point) — lint it with a looser balance cap than the greedy's
        # constraint so PL130 flags genuine pathologies, not the method
        PlanContext.from_table(
            ga, name="fig3b/ga", wg=wg, topology=topo, balance_slack=1.0
        ),
        PlanContext.from_table(
            greedy, name="fig3b/greedy", wg=wg, topology=topo,
            balance_slack=0.25,
        ),
    ]


def _table2() -> list[PlanContext]:
    """The G-sweep of Table 2: one Algorithm-2 table per candidate group
    count, each over both evaluation fabrics."""
    from repro_torch import netsim
    from repro_torch.core.graph import planted_partition_graph
    from repro_torch.core.routing import sweep_candidates, two_level_routing
    from repro_torch.core.traffic import TrafficMatrix

    n = 64
    graph, _ = planted_partition_graph(
        n, n_blocks=8, avg_degree=16, p_in_frac=0.9, seed=0
    )
    tm = TrafficMatrix.from_coo(
        graph.rows(), graph.indices, graph.edge_traffic(), n
    ).symmetrized(halve=True)
    wg = np.ones(n)
    out = []
    topos = {"xbar": netsim.single_switch(n), "2tier": netsim.two_tier(n, 8)}
    for g in sweep_candidates(n):
        tb = two_level_routing(tm, wg, g, seed=0)
        for tl, topo in topos.items():
            out.append(
                PlanContext.from_table(
                    tb,
                    name=f"table2/G{g}/{tl}",
                    wg=wg,
                    topology=topo,
                    balance_slack=0.25,
                )
            )
    return out


def _snn_throughput() -> list[PlanContext]:
    """Execution-stage artifacts: block-CSR synapses with their sparse
    schedule + ragged plans on the 1-D and (8, 4) meshes (the
    snn_throughput model)."""
    from repro_torch.analysis._support import paper_fabric
    from repro_torch.snn import build_ragged_plan, expand_synapses_sparse, generate_brain_model

    bm = generate_brain_model(
        n_populations=128, n_regions=16, total_neurons=10**7, seed=0
    )
    syn, _ = expand_synapses_sparse(bm.graph, 4, 32, seed=0)
    topo = paper_fabric(32)
    # toy-scale payloads pad heavily (max observed per-round waste ~80%;
    # wide payloads are where sharding would help — ROADMAP); the golden
    # threshold sits above that so PL140 flags *regressions*, not the
    # known toy-scale baseline
    waste = 0.85
    return [
        PlanContext.from_synapses(
            syn,
            (32, 1),
            name="snn_throughput/1d",
            plan=build_ragged_plan(syn, (32, 1)),
            topology=topo,
            waste_threshold=waste,
        ),
        PlanContext.from_synapses(
            syn,
            (8, 4),
            name="snn_throughput/8x4",
            plan=build_ragged_plan(syn, (8, 4)),
            topology=topo,
            waste_threshold=waste,
        ),
    ]


def _replan_bench() -> list[PlanContext]:
    """Replan-stage artifacts: the replan_bench seed table, the table
    after one incremental edit batch, and the fault path (bridge device
    evacuated and barred via ``replan(dead=...)``)."""
    from repro_torch.analysis._support import _edit_batch
    from repro_torch.core.graph import planted_partition_graph
    from repro_torch.core.replan import evacuate_device, replan
    from repro_torch.core.routing import two_level_routing
    from repro_torch.core.traffic import TrafficMatrix

    n, g = 256, 16
    graph, _ = planted_partition_graph(
        n, n_blocks=g, avg_degree=32, p_in_frac=0.9, seed=0
    )
    tm = TrafficMatrix.from_coo(
        graph.rows(), graph.indices, graph.edge_traffic(), n
    ).symmetrized(halve=True)
    wg = np.ones(n)
    tb = two_level_routing(tm, wg, g, seed=0)
    edited = replan(tb, wg, _edit_batch(tb, 0, 16)).table
    dead = int(tb.bridge[tb.bridge >= 0].ravel()[0])
    delta, wg2, _host = evacuate_device(tb, wg, dead)
    fault = replan(tb, wg2, delta, dead=[dead]).table
    slack = 0.25
    return [
        PlanContext.from_table(
            tb, name="replan_bench/base", wg=wg, balance_slack=slack
        ),
        PlanContext.from_table(
            edited, name="replan_bench/edited", wg=wg, balance_slack=slack
        ),
        PlanContext.from_table(
            fault,
            name="replan_bench/fault",
            wg=wg2,
            dead=[dead],
            balance_slack=slack,
        ),
    ]


def _outofcore() -> list[PlanContext]:
    """Out-of-core pipeline artifacts: a reduced two-tier plan (64
    devices in 4 pods, the ``paper_scale`` pipeline at toy size) — every
    pod shard's self-contained context plus the cross-shard DCN context
    carrying the PL160 bridge-flow ledger."""
    from repro_torch.core.outofcore import plan_out_of_core
    from repro_torch.snn import generate_brain_model

    bm = generate_brain_model(
        n_populations=600,
        n_regions=10,
        total_neurons=10**7,
        inter_degree=8.0,
        long_range_frac=0.3,
        seed=0,
    )
    # lint=False: the CLI *is* the linter here — no point double-linting
    plan = plan_out_of_core(
        bm.graph, 64, 16, block_size=4, seed=0, sym_mode="both", lint=False
    )
    out = [sh.context for sh in plan.shards]
    out.append(plan.dcn_context)
    return out


SCENARIOS = {
    "fig3a": _fig3a,
    "fig3b": _fig3b,
    "table2": _table2,
    "snn_throughput": _snn_throughput,
    "replan_bench": _replan_bench,
    "outofcore": _outofcore,
}


def scenario_names() -> list[str]:
    return list(SCENARIOS)


def build_scenario(name: str) -> list[PlanContext]:
    """Build the contexts of one named scenario."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r} (have: {', '.join(SCENARIOS)})"
        ) from None
    return fn()
