"""planlint for the port — the static verifier of plans and schedules
(a copy of the reference's ``repro.analysis``, Layer 1 only).

Layer 1 (:mod:`repro_torch.analysis.rules`) lints the plan-chain
artifacts — traffic, routing table, exchange schedule, ragged plan,
topology — bundled in a :class:`~repro_torch.analysis.context.PlanContext`.
:mod:`~repro_torch.analysis.invariants` holds the structural checks the
``validate()`` methods of graph, traffic, partition, routing and block
synapses delegate to.

Layer 2 (the reference's ``repro.analysis.traced``: ``count_collectives``,
``expected_collectives``, ``lint_traced_step``, ``swap_recompile_hazard``,
which lint a traced step against its schedule) is ROADMAP M5 and not
ported yet; nor are the seeded scenarios and the ``python -m`` CLI.
"""
from repro_torch.analysis.context import PlanContext
from repro_torch.analysis.rules import RULES, Finding, Rule, catalog, run_lints

__all__ = [
    "PlanContext",
    "RULES",
    "Finding",
    "Rule",
    "catalog",
    "run_lints",
]
