"""The port's recovery path against the JAX package's, on the CPU: the
chaos schedules and injectors (``repro_torch.chaos``), the supervisor's
recovery ladder (``repro_torch.train.fault_tolerance``) with its state in
torch tensors, ``benchmarks/fault_bench.py``'s gates held by the port,
the rank relayout a replanned table asks for, and ``chip_smoke.py``'s
phase ``recovery`` at a small size.  The numpy modules are copies, so the
same seeded inputs give exactly equal schedules, traces, tables and
histories; wall clocks are never compared."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests._hypothesis_compat import given, settings, st
from tests._torch_parity import assert_same, both, findings

CPU = torch.device("cpu")


def _fire(hook, n_steps: int) -> list:
    """Call a supervisor hook for every step, each crash once; returns what
    it raised as ``(step, devices, fatal)``."""
    raised = []
    for step in range(n_steps):
        for _ in range(2):  # the retry after recovery proceeds
            try:
                hook(step)
            except Exception as err:  # the package's own DeviceFailure
                assert type(err).__name__ == "DeviceFailure"
                raised.append((step, err.devices, err.fatal))
    return raised


# ---------------------------------------------------------------------------
# chaos: schedules and injectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 5, 17, 42])
@pytest.mark.parametrize("kw", [dict(n_devices=16, n_steps=8, n_links=32),
                                dict(n_devices=256, n_steps=50, n_links=64, n_crashes=4,
                                     n_outages=3, n_stragglers=2, p_fatal=0.3)])
def test_generated_schedules_and_fired_traces_match_reference(seed, kw):
    scheds = [chaos.FaultSchedule.generate(seed, **kw) for chaos in both("chaos")]
    assert_same(*scheds)
    hooks = [chaos.supervisor_hook(s) for chaos, s in zip(both("chaos"), scheds)]
    raised = [_fire(h, kw["n_steps"]) for h in hooks]
    assert raised[0] == raised[1]
    assert hooks[0].trace == hooks[1].trace and hooks[1].trace
    assert_same(*(chaos.link_outages(s) for chaos, s in zip(both("chaos"), scheds)))
    assert scheds[1].dead_devices() == scheds[0].dead_devices()


@given(seed=st.integers(0, 20))
@settings(max_examples=10, deadline=None)
def test_same_schedule_same_injected_trace(seed):
    """The reference's injector-determinism case without its ``tmp_path``
    (a function-scoped fixture under ``@given``): one schedule, two
    derivations of every injector, equal traces and outage records."""
    from repro_torch.chaos import FaultSchedule, link_outages, supervisor_hook

    sched = FaultSchedule.generate(seed, n_devices=16, n_steps=8, n_links=32)
    traces = []
    for _ in range(2):
        hook = supervisor_hook(sched)
        _fire(hook, 8)
        traces.append(tuple(hook.trace))
    assert traces[0] == traces[1]
    assert link_outages(sched) == link_outages(sched)
    assert set(traces[0]) <= set(sched.trace())


def test_straggler_topology_and_dead_rounds_match_reference():
    out = []
    for chaos, netsim in zip(both("chaos"), both("netsim")):
        topo = netsim.fat_tree(16, 4)
        sched = chaos.FaultSchedule(events=(
            chaos.FaultEvent("straggler", step=0, device=5, slowdown=3.0),
            chaos.FaultEvent("straggler", step=2, device=9, slowdown=1.5),
            chaos.FaultEvent("device_crash", step=1, device=2),
        ))
        msg = netsim.events.Message
        rounds = [[msg(0, 1, 10), msg(2, 3, 10), msg(1, 2, 10)], [], [msg(3, 0, 10)]]
        out.append((chaos.apply_stragglers(topo, sched),
                    chaos.filter_dead_rounds(rounds, sched.dead_devices())))
    assert_same(*out)
    assert [len(r) for r in out[1][1]] == [1, 0, 1]


@pytest.mark.parametrize("bad", [
    dict(kind="meteor_strike", step=0), dict(kind="device_crash", step=-1, device=0),
    dict(kind="device_crash", step=0), dict(kind="link_down", step=0),
    dict(kind="link_down", step=0, link=1, t_down=2.0, t_up=1.0),
    dict(kind="straggler", step=0, device=0, slowdown=0.5),
])
def test_schedule_rejects_what_the_reference_rejects(bad):
    msgs = []
    for chaos in both("chaos"):
        with pytest.raises(ValueError) as err:
            chaos.FaultSchedule(events=(chaos.FaultEvent(**bad),))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the supervisor's recovery ladder
# ---------------------------------------------------------------------------


def _state(pkg: str):
    if pkg == "repro":
        return {"w": np.zeros(2)}, {"m": np.zeros(3)}
    return {"w": torch.zeros(2, dtype=torch.float64)}, {"m": torch.zeros(3)}


def _ladder(pkg, ft, chaos, case: str, ckpt_dir: str) -> dict:
    """One ladder run: its history (wall clocks left out), the dead and
    degraded marks, the evacuate-hook calls, the backoff sleeps, or the
    error that ended the run."""
    events = {
        "fatal": (chaos.FaultEvent("device_crash", step=3, device=5),
                  chaos.FaultEvent("device_crash", step=3, device=9)),
        "transient": (chaos.FaultEvent("device_crash", step=2, device=3, fatal=False),),
        "degraded": (chaos.FaultEvent("device_crash", step=1, device=2),),
        "reraise": (chaos.FaultEvent("device_crash", step=1, device=2),),
        "nan": (),
        "two_fatal": (chaos.FaultEvent("device_crash", step=3, device=37),
                      chaos.FaultEvent("device_crash", step=7, device=121),
                      chaos.FaultEvent("straggler", step=0, device=200, slowdown=4.0)),
    }[case]
    nan_at = {"done": False}

    def train_step(params, opt, batch):
        w = params["w"]
        if case == "nan" and batch == 4.0 and not nan_at["done"]:
            nan_at["done"] = True
            return float("nan"), params, opt, None
        return float(batch), {"w": w + batch}, opt, None

    evac, slept = [], []
    params, opt = _state(pkg)
    sup = ft.Supervisor(
        train_step, params, opt, lambda s: float(s),
        ft.SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=2, backoff_base_s=0.01, seed=3,
                            allow_degraded=case != "reraise"),
        failure_hook=chaos.supervisor_hook(chaos.FaultSchedule(events=events)),
        evacuate_hook=lambda ds: evac.append(ds) or case not in ("degraded", "reraise"),
        sleep=slept.append,
    )
    n = 12 if case == "two_fatal" else 6
    try:
        sup.run(n)
        err = None
    except Exception as e:  # the ladder's re-raise
        err = (type(e).__name__, str(e))
    hist = [dataclasses.replace(h, wall_time=0.0, straggler=False) for h in sup.history]
    w = sup.params["w"]
    return {"history": [dataclasses.astuple(h) for h in hist], "dead": sup.dead,
            "degraded": sup.degraded, "evacuated": evac, "slept": slept, "error": err,
            "w": np.asarray(w, dtype=np.float64).tolist(), "step": sup.step}


@pytest.mark.parametrize("case", ["fatal", "transient", "degraded", "reraise", "nan",
                                  "two_fatal"])
def test_supervisor_ladders_match_reference(case, tmp_path):
    got = []
    for pkg, ft, chaos in zip(("repro", "repro_torch"), both("train.fault_tolerance"),
                              both("chaos")):
        got.append(_ladder(pkg, ft, chaos, case, str(tmp_path / pkg)))
    assert got[0] == got[1]
    hist = got[1]["history"]
    if case == "reraise":
        assert got[1]["error"][0] == "DeviceFailure"
    else:
        assert got[1]["error"] is None and any(h[3] for h in hist)  # restarted
    if case == "fatal":
        assert got[1]["evacuated"] == [(5, 9)] and got[1]["slept"]


def test_resume_with_restores_onto_the_device_asked_for(tmp_path):
    from repro_torch.train import Supervisor, SupervisorConfig

    def step(params, opt, batch):
        return float(batch), {"w": params["w"] + batch}, opt, None

    sup = Supervisor(step, {"w": torch.zeros(3)}, {"m": torch.ones(2)}, lambda s: float(s),
                     SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=2))
    sup.run(5)
    params, opt, at = sup.resume_with({"w": np.zeros(3)}, {"m": np.zeros(2)}, device="cpu")
    assert at == 4 and isinstance(params["w"], torch.Tensor)
    assert torch.equal(params["w"], torch.full((3,), 6.0)) and torch.equal(opt["m"], torch.ones(2))
    params, _opt, _ = sup.resume_with({"w": np.zeros(3)}, {"m": np.zeros(2)})
    assert isinstance(params["w"], np.ndarray)  # numpy targets without a device


# ---------------------------------------------------------------------------
# benchmarks/fault_bench.py's gates, held by the port
# ---------------------------------------------------------------------------


def _fault_setup(pkg: str):
    """fault_bench's seed table, topology, outage link and schedule."""
    if pkg == "repro_torch":
        import chip_smoke

        return chip_smoke.fault_bench_setup()
    import benchmarks.fault_bench as fb
    from repro.core import TrafficMatrix, planted_partition_graph, two_level_routing
    from repro.netsim import fat_tree

    graph, _ = planted_partition_graph(fb.N, n_blocks=fb.G, avg_degree=32, p_in_frac=0.9,
                                       seed=0)
    tm = TrafficMatrix.from_coo(graph.rows(), graph.indices, graph.edge_traffic(),
                                fb.N).symmetrized(halve=True)
    wg = np.ones(fb.N)
    topo = fat_tree(fb.N, fb.N // fb.G)
    link = int(topo.params["leaf_up"][fb.CRASH_DEVICES[0] // (fb.N // fb.G)][0])
    return tm, wg, two_level_routing(tm, wg, fb.G, seed=0), topo, link, fb._schedule(link)


def test_fault_bench_plan_gates_match_reference():
    """The recovered table, its lint with the dead devices and the downed
    link declared (PL170/PL171 silent) and the outage replay's reroutes
    and stall, each equal to the reference's."""
    out = []
    for pkg, core, analysis, chaos, netsim in zip(
            ("repro", "repro_torch"), both("core"), both("analysis"), both("chaos"),
            both("netsim")):
        tm, wg, tb, topo, link, sched = _fault_setup(pkg)
        dead = list(sched.dead_devices())
        ev = core.evacuate_devices(tb, wg, dead)
        rec = core.replan(tb, ev.wg_after, ev.delta, dead=dead).table
        lint = analysis.run_lints(analysis.PlanContext.from_table(
            rec, name="fault_bench.recovered", topology=topo, dead=dead, down_links=[link]))
        rounds = chaos.filter_dead_rounds(netsim.table_rounds(rec, bytes_per_unit=64.0), dead)
        sim = netsim.simulate(rounds, chaos.apply_stragglers(topo, sched),
                              outages=chaos.link_outages(sched), collect_hops=True)
        out.append({"schedule": sched, "table": rec, "ev": ev, "lint": findings(lint),
                    "rerouted": sim.n_rerouted, "stall_s": sim.outage_stall_s,
                    "t_total": sim.t_total, "worst": sim.worst_device()})
    assert_same(*out)
    port = out[1]
    assert not [f for f in port["lint"] if f[0] in ("PL170", "PL171") or f[1] == "error"]
    assert port["rerouted"] > 0
    assert not np.any(np.isin(port["table"].bridge, port["ev"].dead))


def test_fault_bench_trajectory_gates_match_reference(tmp_path):
    """The supervised LIF trajectory with its state in torch tensors: the
    committed raster bit-equal to a failure-free run, ``steps_lost`` and
    availability equal to the reference's ``_lif_run``."""
    import benchmarks.fault_bench as fb
    import chip_smoke

    _tm, _wg, _tb, _topo, link, sched = _fault_setup("repro_torch")
    raster_f, hist, states = chip_smoke.lif_trajectory(sched, str(tmp_path / "f"), CPU)
    raster_c, clean, _ = chip_smoke.lif_trajectory(None, str(tmp_path / "c"), CPU)
    assert sorted(raster_f) == sorted(raster_c) == list(range(fb.N_STEPS))
    assert all(torch.equal(raster_f[s], raster_c[s]) for s in raster_c)
    assert sum(float(r.sum()) for r in raster_c.values()) > 0
    ref_raster, ref_hist = fb._lif_run(fb._schedule(link), str(tmp_path / "r"))
    assert len(hist) - fb.N_STEPS == len(ref_hist) - fb.N_STEPS == 2
    assert fb.N_STEPS / len(hist) == fb.N_STEPS / len(ref_hist) == 12 / 14
    assert [h.restarted for h in hist] == [h.restarted for h in ref_hist]
    assert len(clean) == fb.N_STEPS
    from repro_torch.train import restore, verify_checkpoint

    for s in (8, 10, 12):  # the three the checkpointer keeps
        assert verify_checkpoint(str(tmp_path / "f"), s)
        params, _opt, man = restore(str(tmp_path / "f"), s, {"v": torch.zeros(64)},
                                    {"t": torch.zeros(1)})
        assert man["step"] == s and params["v"].dtype == torch.float32
        assert torch.equal(params["v"], states[s].float())


# ---------------------------------------------------------------------------
# the rank layout of a replanned table, and phase ``recovery`` on the CPU
# ---------------------------------------------------------------------------


def _network(n_pop: int = 128, steps: int = 40) -> dict:
    """Phase 4's ``keep`` at the launcher's size: 128 populations of 4
    neurons on 8 ranks in a (2, 4) mesh, its table, tiles and ragged raster."""
    import chip_smoke
    from repro_torch import convert
    from repro_torch.core import device_traffic_csr, greedy_partition, two_level_routing
    from repro_torch.snn import (DistributedSNN, LIFParams, expand_synapses_sparse,
                                 generate_brain_model)

    bm = generate_brain_model(n_populations=n_pop, n_regions=8, total_neurons=1_000_000,
                              seed=0)
    part = greedy_partition(bm.graph, 8, seed=0)
    t, wg = device_traffic_csr(bm.graph, part.assign, 8)
    syn, _ = expand_synapses_sparse(bm.graph, 4, 8, seed=0)
    np.multiply(syn.blocks, np.float32(0.05), out=syn.blocks)
    drive = np.random.default_rng(0).uniform(*chip_smoke.DRIVE, syn.n_neurons).astype(np.float32)
    params = LIFParams(noise_sigma=0.0)
    tiles = convert.padded_tiles(syn, CPU)
    raster = DistributedSNN(mesh=(2, 4), params=params, exchange="ragged", i_ext=drive,
                            syn=syn, tiles=tiles, device=CPU).run(steps)
    return dict(syn=syn, drive=drive, mesh=(2, 4), params=params, steps=steps,
                table=two_level_routing(t, wg, 2), device_weights=wg, tiles=tiles,
                rasters={"ragged_fused": raster.to(torch.uint8).numpy()})


@pytest.mark.parametrize("perm", [[0, 3, 4, 6, 1, 2, 5, 7], [7, 6, 5, 4, 3, 2, 1, 0]])
def test_permute_ranks_moves_tiles_as_staging_the_permuted_synapses_would(perm):
    from repro_torch import convert
    from repro_torch.snn import DistributedSNN, permute_ranks

    net = _network()
    syn, perm = net["syn"], np.array(perm)
    moved, tiles = permute_ranks(syn, perm, net["tiles"])
    moved.validate()
    staged = convert.padded_tiles(moved, CPU)
    assert torch.equal(tiles[0], staged[0]) and torch.equal(tiles[1], staged[1])
    # slot k holds device perm[k]: its tile from device s is the old (perm[k] <- s) tile
    k, s = 2, int(perm[5])
    old = syn.blocks[syn.indptr[perm[k]] + list(syn.src_ids[syn.indptr[perm[k]]:
                                                            syn.indptr[perm[k] + 1]]).index(s)]
    lo, hi = moved.indptr[k], moved.indptr[k + 1]
    np.testing.assert_array_equal(moved.blocks[lo + list(moved.src_ids[lo:hi]).index(5)], old)
    drive = net["drive"].reshape(8, -1)[perm].ravel()
    eng = DistributedSNN(mesh=(2, 4), params=net["params"], exchange="sparse", i_ext=drive,
                         syn=moved, tiles=tiles, device=CPU)
    import chip_smoke

    got = chip_smoke._natural(eng.run(net["steps"]), perm).to(torch.uint8).numpy()
    np.testing.assert_array_equal(got, net["rasters"]["ragged_fused"])
    with pytest.raises(ValueError, match="not a permutation"):
        permute_ranks(syn, np.zeros(8, np.int64))


def test_plan_buffer_flips_to_a_new_rank_layout():
    """A staged plan on another layout brings its synapses, tiles and
    drive; the flipped engine runs as one built from scratch on them."""
    from repro_torch.snn import (DistributedSNN, PlanBuffer, build_ragged_plan,
                                 permute_ranks)

    net = _network()
    eng = DistributedSNN(mesh=(2, 4), params=net["params"], exchange="ragged",
                         i_ext=net["drive"], syn=net["syn"], tiles=net["tiles"], device=CPU)
    buf = PlanBuffer(eng)
    perm = np.array([4, 1, 2, 3, 0, 5, 6, 7])
    syn2, tiles2 = permute_ranks(net["syn"], perm, net["tiles"])
    drive2 = net["drive"].reshape(8, -1)[perm].ravel()
    plan = build_ragged_plan(syn2, (2, 4), bridge_inner=np.array([[-1, 2], [1, -1]]))
    buf.stage(plan, syn=syn2, tiles=tiles2, i_ext=drive2)
    flipped = buf.flip()
    assert flipped.tiles is tiles2 and flipped.syn is syn2
    fresh = DistributedSNN(mesh=(2, 4), params=net["params"], exchange="ragged",
                           i_ext=drive2, syn=syn2, plan=plan, device=CPU)
    assert torch.equal(flipped.run(net["steps"]), fresh.run(net["steps"]))
    with pytest.raises(ValueError, match="comes with the synapses"):
        buf.stage(plan, tiles=tiles2)


def test_recovery_phase_on_the_cpu():
    """Phase ``recovery`` of ``chip_smoke.py`` at the launcher's size on the
    CPU (the card's replay and launch checks are the chip's): every flipped
    raster equals its from-scratch engine's, the ledgers the plans' bytes,
    the dead rank is off bridge duty, the supervised trajectory is the
    failure-free one and the CLI answers as the reference's."""
    import chip_smoke

    out = chip_smoke.phase_recovery(CPU, _network())
    edit, fault = out["replan"], out["fault"]
    assert edit["equals_from_scratch"] and fault["equals_from_scratch"]
    assert fault["dead_rank_off_bridge_duty"] and fault["lint"]["PL170_PL171"] == 0
    assert out["base"]["moved_ranks"] > 0  # the table's layout is not the device order
    assert edit["case"].startswith("no device changed group")
    sup = out["supervised"]
    assert sup["trajectory_bit_equal"] and sup["steps_lost"] == 2
    assert sup["checkpoints_restored"] == [8, 10, 12]
    assert out["cli"]["rules_md_equals_docs"] and out["cli"]["all_stats"]["rc"] == 0


def test_recovery_phase_follows_a_table_that_moves_devices(monkeypatch):
    """When the replanned table moves a device to another group, the
    layout, the tiles and the drive follow it, and the flipped engine
    still equals one built from scratch on the new layout."""
    import chip_smoke
    import repro_torch.core as core

    real = core.replan

    def moving(tb, wg, delta, **kw):
        res = real(tb, wg, delta, **kw)
        if kw.get("dead"):
            return res
        g = res.table.group_of.copy()
        bridges = set(res.table.bridge[res.table.bridge >= 0].ravel().tolist())
        a = next(d for d in range(len(g)) if g[d] == 0 and d not in bridges)
        b = next(d for d in range(len(g)) if g[d] == 1 and d not in bridges)
        g[a], g[b] = 1, 0
        return dataclasses.replace(res, table=dataclasses.replace(res.table, group_of=g))

    monkeypatch.setattr(core, "replan", moving)
    out = chip_smoke._recovery_network(CPU, _network())
    edit = out["replan"]
    assert edit["moved_ranks"] > 0 and edit["case"].startswith("a device changed group")
    assert edit["equals_from_scratch"] and out["fault"]["equals_from_scratch"]
    assert out["fault"]["moved_ranks"] == edit["moved_ranks"]  # the fault table moves them back
