"""planlint Layer 1 of the port against the JAX package's, on the CPU:
the same clean contexts lint silent in both, and each planted fault (the
mutations of ``tests/test_planlint.py``, applied to each package's own
artifacts) gives the same findings — rule id, severity and message — in
both, including the rule the fault is planted for.  The command line
(``python -m repro_torch.analysis``): ``--rules-md`` equals
``docs/RULES.md``, each seeded scenario gives the reference's findings
and exits 0, and ``--table`` files round-trip between the packages."""
from __future__ import annotations

import collections
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from tests._torch_parity import both, findings


@pytest.fixture(scope="module")
def arts():
    """Per package: a two-level table over a planted-partition graph's
    traffic, and 16-rank synapse tiles on (4, 4) with their ragged plan."""
    out = []
    for core, snn in zip(both("core"), both("snn")):
        n, g = 64, 8
        graph, _ = core.planted_partition_graph(n, n_blocks=g, avg_degree=16,
                                                p_in_frac=0.9, seed=0)
        tm = core.TrafficMatrix.from_coo(graph.rows(), graph.indices,
                                         graph.edge_traffic(), n).symmetrized(halve=True)
        wg = np.ones(n)
        bm = snn.generate_brain_model(n_populations=64, n_regions=8, total_neurons=10**6,
                                      seed=0)
        syn, _ = snn.expand_synapses_sparse(bm.graph, 4, 16, seed=0)
        out.append({"table": core.two_level_routing(tm, wg, g, seed=0), "tm": tm, "wg": wg,
                    "syn": syn, "plan": snn.build_ragged_plan(syn, (4, 4))})
    return out


def _table_ctx(a, **kw):
    return a["PlanContext"].from_table(a["table"], **kw)


def _plan_ctx(a, plan, **kw):
    return a["PlanContext"].from_synapses(a["syn"], (4, 4), plan=plan,
                                          **{"waste_threshold": 1.0, **kw})


def _with_round(plan, i, **changes):
    rounds = list(plan.rounds)
    rounds[i] = dataclasses.replace(rounds[i], **changes)
    return dataclasses.replace(plan, rounds=tuple(rounds))


def _live_round(plan, min_width=2):
    return next(i for i, rnd in enumerate(plan.rounds) if rnd.pairs and rnd.width >= min_width)


# each planted fault makes the faulty context in one package; its key in
# FAULTS names the rule it must trip
def _bridge_out_of_group(a):
    tb = a["table"]
    bad = np.array(tb.bridge, copy=True)
    bad[0, 1] = tb.members(1)[0]
    return a["PlanContext"].from_table(dataclasses.replace(tb, bridge=bad))


def _dropped_round(a):
    ctx = _table_ctx(a)
    live = next(i for i, pairs in enumerate(ctx.schedule) if pairs)
    ctx.schedule = [[] if i == live else p for i, p in enumerate(ctx.schedule)]
    return ctx


def _unmasked_pair(a):
    ctx = _table_ctx(a)
    gs, gd = ctx.schedule[0][0]
    ctx.gmask = np.array(ctx.gmask, copy=True)
    ctx.gmask[gs, gd] = False
    return ctx


def _duplicate_send(a):
    ctx = _table_ctx(a)
    ctx.schedule = [list(p) for p in ctx.schedule]
    ctx.schedule[0].append(ctx.schedule[0][0])
    return ctx


def _too_many_rounds(a):
    ctx = _table_ctx(a)
    ctx.schedule = list(ctx.schedule) + [[(0, 1)]]
    return ctx


def _dead_bridge(a):
    tb = a["table"]
    return _table_ctx(a, dead=[int(tb.bridge[tb.bridge >= 0].ravel()[0])])


def _share_desync(a):
    tb = a["table"]
    dev, grp, frac = tb.share_coo
    return a["PlanContext"].from_table(dataclasses.replace(tb, share_coo=(dev, grp, frac * 0.5)))


def _unbalanced(a):
    tb = a["table"]
    wg = np.ones(tb.n_devices)
    wg[tb.members(0)] = 10.0
    return _table_ctx(a, wg=wg)


def _empty_group(a):
    tb = a["table"]
    group_of = np.array(tb.group_of, copy=True)
    group_of[group_of == 7] = 6
    return a["PlanContext"].from_table(dataclasses.replace(tb, group_of=group_of))


def _unroutable(a):
    return _table_ctx(a, topology=a["netsim"].single_switch(32))


def _inflated_width(a):
    plan = a["plan"]
    i = _live_round(plan)
    return _plan_ctx(a, _with_round(plan, i, width=plan.rounds[i].width + 5))


def _dropped_plan_pair(a):
    plan = a["plan"]
    i = next(j for j, rnd in enumerate(plan.rounds) if len(rnd.pairs) >= 2)
    rnd = plan.rounds[i]
    return _plan_ctx(a, _with_round(plan, i, pairs=rnd.pairs[1:], perm=rnd.perm[1:]))


def _trash_collision(a):
    plan, rb = a["plan"], 4 * a["syn"].block_size
    i = _live_round(plan)
    recv = np.array(plan.rounds[i].recv_idx, copy=True)
    row = next(d for d in range(recv.shape[0]) if np.count_nonzero(recv[d] < rb) >= 2)
    live = np.flatnonzero(recv[row] < rb)
    recv[row, live[1]] = recv[row, live[0]]
    return _plan_ctx(a, _with_round(plan, i, recv_idx=recv))


def _column_out_of_bounds(a):
    plan, rb = a["plan"], 4 * a["syn"].block_size
    i = _live_round(plan)
    send = np.array(plan.rounds[i].send_idx, copy=True)
    send[0, 0] = rb
    return _plan_ctx(a, _with_round(plan, i, send_idx=send))


def _padding_waste(a):
    return _plan_ctx(a, a["plan"], waste_threshold=0.0)


def _traffic_diagonal(a):
    tm = a["TrafficMatrix"](indptr=np.array([0, 1, 1]), indices=np.array([0]),
                            data=np.array([1.0]))
    return a["PlanContext"](traffic=tm)


def _partition_out_of_range(a):
    return a["PlanContext"](partition=np.array([0, 1, 5]), n_parts=2)


def _bottleneck(a):
    return _table_ctx(a, topology=a["netsim"].two_tier(64, 8), bottleneck_threshold=0.0)


FAULTS = {
    "PL005": _bridge_out_of_group,
    "PL101": _dropped_round,
    "PL101/unmasked": _unmasked_pair,
    "PL110": _duplicate_send,
    "PL110/rounds": _too_many_rounds,
    "PL120": _dead_bridge,
    "PL121": _share_desync,
    "PL130": _unbalanced,
    "PL131": _empty_group,
    "PL150": _unroutable,
    "PL102": _inflated_width,
    "PL102/pair": _dropped_plan_pair,
    "PL141": _trash_collision,
    "PL142": _column_out_of_bounds,
    "PL140": _padding_waste,
    "PL002": _traffic_diagonal,
    "PL003": _partition_out_of_range,
    "PL180": _bottleneck,
}


def _packages(arts):
    out = []
    for a, analysis, netsim, core in zip(arts, both("analysis"), both("netsim"), both("core")):
        out.append({**a, "PlanContext": analysis.PlanContext, "run_lints": analysis.run_lints,
                    "netsim": netsim, "TrafficMatrix": core.TrafficMatrix})
    return out


def test_clean_contexts_are_silent_in_both(arts):
    for a in _packages(arts):
        assert a["run_lints"](_table_ctx(a, name="good", wg=a["wg"], balance_slack=0.25)) == []
        assert a["run_lints"](_plan_ctx(a, a["plan"], name="good")) == []
        assert a["run_lints"](a["PlanContext"].from_table(
            a["table"], topology=a["netsim"].two_tier(64, 8))) == []


@pytest.mark.parametrize("fault", list(FAULTS), ids=list(FAULTS))
def test_planted_fault_gives_the_reference_findings(arts, fault):
    got = []
    for a in _packages(arts):
        got.append(findings(a["run_lints"](FAULTS[fault](a))))
    ref, port = got
    assert port == ref
    assert fault.split("/")[0] in {rule for rule, _, _ in port}


def test_catalog_matches_reference():
    ref, port = ([(r.id, r.severity, r.summary, r.fix_hint) for r in a.catalog()]
                 for a in both("analysis"))
    assert port == ref and len(port) > 20


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = ("fig3a", "fig3b", "table2", "snn_throughput", "replan_bench", "outofcore")


def test_rules_md_equals_the_committed_catalog(capsys):
    from repro_torch.analysis import cli

    assert cli.main(["--rules-md"]) == 0
    assert capsys.readouterr().out == (ROOT / "docs" / "RULES.md").read_text(encoding="utf-8")


def test_list_rules_prints_the_reference_catalog(capsys):
    outs = []
    for cli in both("analysis.cli"):
        assert cli.main(["--list-rules"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[1].count("\n") > 20


def _counts(contexts, run_lints) -> list:
    """Per context: its name and its findings as (rule id, severity, count)."""
    out = []
    for ctx in contexts:
        c = collections.Counter((f.rule_id, f.severity) for f in run_lints(ctx))
        out.append((ctx.name, sorted((rule, sev, n) for (rule, sev), n in c.items())))
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_gives_the_reference_findings(name, capsys):
    got, printed = [], []
    for scenarios, analysis, cli in zip(both("analysis.scenarios"), both("analysis"),
                                        both("analysis.cli")):
        got.append(_counts(scenarios.build_scenario(name), analysis.run_lints))
        assert cli.main(["--scenario", name, "--stats"]) == 0
        printed.append(capsys.readouterr().out)
    assert got[0] == got[1] and got[1]
    assert printed[0] == printed[1]


def test_scenario_names_and_unknown_name_match_reference():
    msgs = []
    for scenarios in both("analysis.scenarios"):
        assert scenarios.scenario_names() == list(SCENARIOS)
        with pytest.raises(ValueError) as err:
            scenarios.build_scenario("nope")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("which", ["base", "edited", "fault"])
def test_table_npz_round_trips_between_the_packages(which, tmp_path, capsys):
    """Each package saves the replan scenario's table; each file loads in
    both as the same table, and ``--table`` lints it as the reference does."""
    tables, files = [], []
    for pkg, scenarios, cli in zip(("repro", "repro_torch"), both("analysis.scenarios"),
                                   both("analysis.cli")):
        ctx = {c.name.split("/")[1]: c for c in scenarios.build_scenario("replan_bench")}[which]
        tables.append(ctx.table)
        path = str(tmp_path / f"{pkg}.npz")
        cli.save_table_npz(ctx.table, path)
        files.append(path)
    with np.load(files[0]) as ref, np.load(files[1]) as port:
        assert sorted(ref.files) == sorted(port.files)
        for k in ref.files:
            np.testing.assert_array_equal(ref[k], port[k])
    rcs, printed = [], []
    for cli in both("analysis.cli"):
        for path, table in zip(files, tables):
            loaded = cli.load_table_npz(path)
            np.testing.assert_array_equal(loaded.group_of, table.group_of)
            np.testing.assert_array_equal(loaded.bridge, table.bridge)
            np.testing.assert_array_equal(loaded.device_traffic.data, table.device_traffic.data)
            assert loaded.method == table.method
        rcs.append(cli.main(["--table", files[1]]))
        printed.append(capsys.readouterr().out)
    assert rcs[0] == rcs[1] and printed[0] == printed[1]
