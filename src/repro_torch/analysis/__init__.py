"""planlint for the port — the static verifier of plans, schedules and
executed distributed steps (a copy of the reference's ``repro.analysis``).

Layer 1 (:mod:`repro_torch.analysis.rules`) lints the plan-chain
artifacts — traffic, routing table, exchange schedule, ragged plan,
topology — bundled in a :class:`~repro_torch.analysis.context.PlanContext`.
:mod:`~repro_torch.analysis.invariants` holds the structural checks the
``validate()`` methods of graph, traffic, partition, routing and block
synapses delegate to.  Layer 2 (:mod:`repro_torch.analysis.traced`) lints
the :class:`~repro_torch.snn.distributed.DistributedSNN` step, run eagerly
through a recording communicator, against what the schedule says it
should emit.  ``python -m repro_torch.analysis`` lints the seeded
benchmark scenarios (:mod:`repro_torch.analysis.scenarios`), a saved
routing table or prints the rule catalog (:mod:`repro_torch.analysis.cli`).
"""
from repro_torch.analysis.context import PlanContext
from repro_torch.analysis.rules import RULES, Finding, Rule, catalog, run_lints
from repro_torch.analysis.traced import (
    count_collectives,
    expected_collectives,
    lint_traced_step,
    swap_recompile_hazard,
)

__all__ = [
    "PlanContext",
    "RULES",
    "Finding",
    "Rule",
    "catalog",
    "run_lints",
    "count_collectives",
    "expected_collectives",
    "lint_traced_step",
    "swap_recompile_hazard",
]
