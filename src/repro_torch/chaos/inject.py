"""Per-layer injectors: one :class:`~repro_torch.chaos.schedule.FaultSchedule`,
every layer.

* :func:`supervisor_hook` — a ``failure_hook`` for
  :class:`~repro_torch.train.fault_tolerance.Supervisor`: crashes raise
  :class:`~repro_torch.train.fault_tolerance.DeviceFailure` (fatal or
  transient per the schedule, each event fires exactly once so the
  retry after recovery proceeds), stragglers stall the step by
  ``(slowdown − 1) · slow_unit_s``.
* :func:`link_outages` — the schedule's down/up windows as
  :class:`~repro_torch.netsim.simulate.LinkOutage` records for
  ``simulate(..., outages=...)``.
* :func:`apply_stragglers` — a copy of a netsim
  :class:`~repro_torch.netsim.topology.Topology` with each straggler's egress
  links slowed by its factor (α and β scale together: a slow NIC is
  slow per message *and* per byte).
* :func:`filter_dead_rounds` — the executor-side dead-device filter:
  drops every replay message that a fatally crashed device would have
  sent or received (the shrunken group simply stops talking to it).

All injectors are pure functions of the schedule — deriving them twice
from the same schedule gives identical traces, which is what the
determinism property tests pin.
"""
from __future__ import annotations

import time

from repro_torch.chaos.schedule import FaultSchedule

__all__ = [
    "supervisor_hook",
    "link_outages",
    "apply_stragglers",
    "filter_dead_rounds",
]


def supervisor_hook(
    schedule: FaultSchedule,
    *,
    slow_unit_s: float = 0.0,
    sleep=time.sleep,
):
    """Build a ``failure_hook(step)`` for the supervisor.

    Crash events raise once: all devices crashing at the same step are
    batched into one :class:`DeviceFailure` (fatal if any of them is
    fatal) so the supervisor's recovery ladder can evacuate them in a
    single replan.  Straggler events sleep ``(slowdown − 1) ·
    slow_unit_s`` (default 0: record-only).  The hook exposes
    ``hook.trace`` — the injected events in firing order, in
    :meth:`FaultEvent.as_tuple` form — for the determinism tests.
    """
    from repro_torch.train.fault_tolerance import DeviceFailure  # lazy: pulls the train layer

    crash_steps: dict[int, list] = {}
    for e in schedule.crashes():
        crash_steps.setdefault(e.step, []).append(e)
    straggler_steps: dict[int, list] = {}
    for e in schedule.stragglers():
        straggler_steps.setdefault(e.step, []).append(e)
    fired: set[int] = set()
    trace: list[tuple] = []

    def hook(step: int) -> None:
        for e in straggler_steps.get(step, ()):
            key = id(e)
            if key in fired:
                continue
            fired.add(key)
            trace.append(e.as_tuple())
            if slow_unit_s > 0:
                sleep((e.slowdown - 1.0) * slow_unit_s)
        evs = [e for e in crash_steps.get(step, ()) if id(e) not in fired]
        if evs:
            for e in evs:
                fired.add(id(e))
                trace.append(e.as_tuple())
            raise DeviceFailure(
                devices=tuple(e.device for e in evs),
                fatal=any(e.fatal for e in evs),
            )

    hook.trace = trace
    return hook


def link_outages(schedule: FaultSchedule):
    """The schedule's 'link_down' windows as netsim ``LinkOutage``
    records, (t_down, link)-sorted — pass to ``simulate(outages=...)``."""
    from repro_torch.netsim.simulate import LinkOutage

    return tuple(
        LinkOutage(link=e.link, t_down=e.t_down, t_up=e.t_up)
        for e in sorted(schedule.outages(), key=lambda e: (e.t_down, e.link))
    )


def apply_stragglers(topo, schedule: FaultSchedule):
    """A copy of ``topo`` whose straggler egress links are slowed.

    Each straggler device's egress links get ``alpha`` and ``beta``
    multiplied by its slowdown factor; every other link is untouched.
    Returns ``topo`` itself when the schedule has no stragglers.
    """
    import dataclasses

    stragglers = {e.device: e.slowdown for e in schedule.stragglers()}
    if not stragglers:
        return topo
    slow_of: dict[int, float] = {}
    egress = topo.device_egress_links()
    for d, factor in stragglers.items():
        if not (0 <= d < topo.n_devices):
            raise ValueError(f"straggler device {d} outside topology")
        for lid in egress[d]:
            slow_of[lid] = max(slow_of.get(lid, 1.0), factor)
    links = tuple(
        dataclasses.replace(
            lnk, alpha=lnk.alpha * slow_of[i], beta=lnk.beta * slow_of[i]
        )
        if i in slow_of
        else lnk
        for i, lnk in enumerate(topo.links)
    )
    return dataclasses.replace(topo, name=topo.name + "+stragglers", links=links)


def filter_dead_rounds(rounds, dead) -> list[list]:
    """Drop every message touching a dead device from replay rounds.

    ``rounds`` is the per-round message-batch shape every
    :mod:`repro_torch.netsim.adapters` function produces; ``dead`` is any
    iterable of device ids.  Round boundaries are preserved (an empty
    round stays an empty round — the schedule's shape is part of the
    plan).
    """
    dead_set = {int(d) for d in dead}
    if not dead_set:
        return [list(rnd) for rnd in rounds]
    return [
        [m for m in rnd if m.src not in dead_set and m.dst not in dead_set]
        for rnd in rounds
    ]
