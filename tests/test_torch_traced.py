"""planlint Layer 2 in the port (``repro_torch.analysis.traced``): the
collective counts of the executed sparse and ragged steps on the
``snn_throughput`` model equal the reference's pins
(``tests/test_planlint.py:389``) and ``expected_collectives``, and
``lint_traced_step`` finds nothing; seeded faults fire PL201 (an extra
``all_gather``), PL202 (an ``.item()`` in the step) and PL203 (a plan swap
that changes the signature) as the reference's lints report them.

The reference's lints count equations of a jaxpr; they are run here on
the port's engine through a stand-in jaxpr holding the port's counts and a
stand-in mesh, so the two give their findings on the same facts."""
from __future__ import annotations

import functools
import types

import numpy as np
import pytest
import torch

from repro.analysis import traced as ref_traced
from repro_torch.analysis import (
    count_collectives, expected_collectives, lint_traced_step, swap_recompile_hazard,
)
from repro_torch.analysis.traced import host_syncs
from repro_torch.snn import (
    DistributedSNN, LIFParams, build_ragged_plan, expand_synapses_sparse, generate_brain_model,
)
from repro_torch.snn import distributed

#: tests/test_planlint.py:417-420
PINS = {
    ((32,), "sparse"): {"ppermute": 31, "psum": 0, "all_gather": 0},
    ((32,), "ragged"): {"ppermute": 31, "psum": 0, "all_gather": 0},
    ((8, 4), "sparse"): {"ppermute": 7, "psum": 0, "all_gather": 1},
    ((8, 4), "ragged"): {"ppermute": 7, "psum": 7, "all_gather": 1},
}


@functools.lru_cache(maxsize=None)
def _syn():
    bm = generate_brain_model(n_populations=128, n_regions=16, total_neurons=10**7, seed=0)
    syn, _ = expand_synapses_sparse(bm.graph, 4, 32, seed=0)
    return syn


def _engine(mesh, exchange):
    return DistributedSNN(mesh=mesh, params=LIFParams(noise_sigma=0.0), exchange=exchange,
                          i_ext=4.0, syn=_syn(), device="cpu")


def _as_reference(eng, counts: dict[str, int] | None = None):
    """The port's engine as the reference's lints read one: a named mesh,
    and a trace whose jaxpr holds ``counts`` equations by primitive."""
    names = ("pod", "data") if len(eng.mesh) == 2 else ("data",)
    eqns = [types.SimpleNamespace(primitive=types.SimpleNamespace(name=p), params={})
            for p, n in (counts or {}).items() for _ in range(n)]
    return types.SimpleNamespace(
        exchange=eng.exchange,
        mesh=types.SimpleNamespace(shape=dict(zip(names, eng.mesh))),
        step_signature=eng.step_signature, _mesh_groups=eng._mesh_groups,
        trace_step=lambda n_steps=2: types.SimpleNamespace(eqns=eqns),
        with_plan=lambda plan: _as_reference(eng.with_plan(plan)),
        _step_key=lambda n_steps: eng._step_key(),
    )


def _triples(findings):
    return [(f.rule_id, f.severity, f.message, f.context) for f in findings]


@pytest.mark.parametrize("mesh,exchange", sorted(PINS), ids=str)
def test_counts_equal_reference_pins(mesh, exchange):
    eng = _engine(mesh, exchange)
    raw = count_collectives(eng.trace_step(2))
    counts = {p: raw.get(p, 0) for p in ("ppermute", "psum", "all_gather")}
    assert counts == PINS[(mesh, exchange)]
    assert counts == expected_collectives(eng)
    assert expected_collectives(eng) == ref_traced.expected_collectives(_as_reference(eng))
    assert lint_traced_step(eng) == []


def test_trace_counts_every_step_alike():
    trace = _engine((8, 4), "ragged").trace_step(3)
    assert len(trace.calls) == 3 and len(set(map(str, trace.calls))) == 1
    assert host_syncs(trace) == {}


def test_extra_all_gather_fires_pl201(monkeypatch):
    eng = _engine((8, 4), "sparse")
    real = distributed._SparseStep._gather_blocks

    def extra(self, comm, s_grp, held):
        comm.all_gather(s_grp, "inner")  # a collective the plan never asked for
        return real(self, comm, s_grp, held)

    monkeypatch.setattr(distributed._SparseStep, "_gather_blocks", extra)
    got = lint_traced_step(eng)
    counts = count_collectives(eng.trace_step(2))
    assert counts["all_gather"] == 2
    want = ref_traced.lint_traced_step(_as_reference(eng, counts))
    assert _triples(got) == _triples(want)
    assert [f.rule_id for f in got] == ["PL201"]
    assert "emits 2 all_gather eqn(s), schedule implies 1" in got[0].message


def test_item_in_step_fires_pl202(monkeypatch):
    eng = _engine((8, 4), "ragged")
    real = distributed.spike_currents_blocks

    def reads_host(s, src, blocks):
        out = real(s, src, blocks)
        out.sum().item()  # the host waits for the device every step
        return out

    monkeypatch.setattr(distributed, "spike_currents_blocks", reads_host)
    got = lint_traced_step(eng)
    want = ref_traced.lint_traced_step(_as_reference(eng, {
        **expected_collectives(eng), "pure_callback": 1}))
    assert [f.rule_id for f in got] == [f.rule_id for f in want] == ["PL202"]
    assert got[0].severity == want[0].severity
    assert got[0].message == want[0].message.replace("pure_callback", "_local_scalar_dense")


def test_plain_cpu_nonzero_is_not_a_sync(monkeypatch):
    """The plain kernel versions may use nonzero on the CPU: not a sync."""
    eng = _engine((8, 4), "sparse")
    real = distributed.spike_currents_blocks

    def cpu_nonzero(s, src, blocks):
        torch.nonzero(s)
        return real(s, src, blocks)

    monkeypatch.setattr(distributed, "spike_currents_blocks", cpu_nonzero)
    assert lint_traced_step(eng) == []


def test_signature_changing_swap_fires_pl203():
    syn = _syn()
    eng = _engine((8, 4), "ragged")
    same = build_ragged_plan(syn, (8, 4))
    assert swap_recompile_hazard(eng, same) == []
    assert ref_traced.swap_recompile_hazard(_as_reference(eng), same) == []
    moved = build_ragged_plan(syn, (8, 4), bridge_inner=np.ones((8, 8), np.int64))
    got = swap_recompile_hazard(eng, moved)
    want = ref_traced.swap_recompile_hazard(_as_reference(eng), moved)
    assert [f.rule_id for f in got] == ["PL203"]
    assert _triples(got) == _triples(want)
    assert "exchange signature changed" in got[0].message


def test_trace_step_only_covers_the_block_paths():
    with pytest.raises(ValueError, match="sparse'/'ragged"):
        DistributedSNN(mesh=(2,), params=LIFParams(), exchange="flat",
                       w_syn=np.zeros((4, 4), np.float32), device="cpu").trace_step()
