"""chaos — deterministic fault injection across every layer.

One seeded, declarative :class:`~repro_torch.chaos.schedule.FaultSchedule`
(device crashes, link down/up windows, straggler slowdowns, transient
vs fatal) drives injectors for the supervisor
(:func:`~repro_torch.chaos.inject.supervisor_hook`), the discrete-event
fabric (:func:`~repro_torch.chaos.inject.link_outages`,
:func:`~repro_torch.chaos.inject.apply_stragglers`), and the executor replay
(:func:`~repro_torch.chaos.inject.filter_dead_rounds`) — so a chaos run's
layers can never disagree about what failed when.

The schedule module is pure numpy/python; the supervisor injector
lazy-imports the train layer (and with it torch), so importing
``repro_torch.chaos`` pulls in numpy only.
"""
from repro_torch.chaos.inject import (
    apply_stragglers,
    filter_dead_rounds,
    link_outages,
    supervisor_hook,
)
from repro_torch.chaos.schedule import KINDS, FaultEvent, FaultSchedule

__all__ = [
    "FaultEvent",
    "FaultSchedule",
    "KINDS",
    "supervisor_hook",
    "link_outages",
    "apply_stragglers",
    "filter_dead_rounds",
]
