"""Seeded, declarative fault schedules.

A :class:`FaultSchedule` is the single source of truth for everything a
chaos run injects — device crashes at a supervisor step, link down/up
windows on the simulated fabric, straggler slowdowns — so the *same*
schedule drives every layer (supervisor hook, netsim outages, executor
dead-device filter, straggler topology) and the layers cannot drift
apart.  Schedules are either written out explicitly (the benchmark's
fixed scenario) or drawn from a seeded generator
(:meth:`FaultSchedule.generate`); both are pure data, and
:meth:`FaultSchedule.trace` renders the canonical event tuple the
determinism tests compare.

Transient vs fatal: a *fatal* crash permanently removes the device (the
supervisor escalates to evacuate + replan); a *transient* crash is a
one-off step failure (backoff + rollback suffices).  Link outages and
stragglers are always transient — the fabric heals at ``t_up`` and a
slow device is still a correct device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FaultEvent", "FaultSchedule", "KINDS"]

#: recognized event kinds
KINDS = ("device_crash", "link_down", "straggler")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    Attributes:
      kind: 'device_crash' | 'link_down' | 'straggler'.
      step: supervisor step the event fires at (crash/straggler); for
        'link_down' the step the window is announced (the replay itself
        keys on ``t_down``/``t_up``).
      device: target device id (crash/straggler), -1 otherwise.
      link: target link id ('link_down'), -1 otherwise.
      t_down / t_up: outage window in netsim seconds ('link_down').
      slowdown: egress slowdown factor ≥ 1 ('straggler').
      fatal: transient-vs-fatal classification; only meaningful for
        'device_crash' (outages and stragglers are always transient).
    """

    kind: str
    step: int
    device: int = -1
    link: int = -1
    t_down: float = 0.0
    t_up: float = 0.0
    slowdown: float = 1.0
    fatal: bool = True

    def as_tuple(self) -> tuple:
        """Canonical value tuple (the :meth:`FaultSchedule.trace` row)."""
        return (
            self.kind,
            int(self.step),
            int(self.device),
            int(self.link),
            float(self.t_down),
            float(self.t_up),
            float(self.slowdown),
            bool(self.fatal),
        )


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An ordered, validated set of :class:`FaultEvent`\\ s plus the seed
    that produced it (0 for hand-written schedules)."""

    events: tuple[FaultEvent, ...]
    seed: int = 0

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        for e in self.events:
            if e.kind not in KINDS:
                raise ValueError(f"unknown fault kind {e.kind!r}")
            if e.step < 0:
                raise ValueError(f"{e.kind} at negative step {e.step}")
            if e.kind in ("device_crash", "straggler") and e.device < 0:
                raise ValueError(f"{e.kind} needs a device id")
            if e.kind == "link_down":
                if e.link < 0:
                    raise ValueError("link_down needs a link id")
                if not (0.0 <= e.t_down < e.t_up):
                    raise ValueError(
                        f"link_down window [{e.t_down}, {e.t_up}) is empty"
                    )
            if e.kind == "straggler" and e.slowdown < 1.0:
                raise ValueError(f"straggler slowdown {e.slowdown} < 1")

    # -- canonical views ---------------------------------------------------
    def trace(self) -> tuple[tuple, ...]:
        """Canonical (step, kind)-sorted event tuples — the value the
        determinism property tests compare across injectors and runs."""
        return tuple(
            e.as_tuple()
            for e in sorted(self.events, key=lambda e: (e.step, e.kind, e.device, e.link))
        )

    def crashes(self) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind == "device_crash")

    def outages(self) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind == "link_down")

    def stragglers(self) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind == "straggler")

    def dead_devices(self, *, upto_step: int | None = None) -> tuple[int, ...]:
        """Devices fatally crashed by ``upto_step`` (inclusive; every
        fatal crash when omitted), sorted and de-duplicated."""
        dead = {
            e.device
            for e in self.crashes()
            if e.fatal and (upto_step is None or e.step <= upto_step)
        }
        return tuple(sorted(dead))

    # -- seeded generator --------------------------------------------------
    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n_devices: int,
        n_steps: int,
        n_links: int = 0,
        n_crashes: int = 2,
        n_outages: int = 1,
        n_stragglers: int = 1,
        p_fatal: float = 0.5,
        outage_span: float = 1e-3,
        max_slowdown: float = 8.0,
    ) -> "FaultSchedule":
        """Draw a random schedule — same seed, same schedule, bit-exact.

        Crash/straggler devices are drawn without replacement so one
        device never gets two conflicting fates; outage windows are
        uniform sub-spans of ``[0, outage_span)``.
        """
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        targets = rng.choice(
            n_devices, size=min(n_crashes + n_stragglers, n_devices), replace=False
        )
        for d in targets[:n_crashes]:
            events.append(
                FaultEvent(
                    kind="device_crash",
                    step=int(rng.integers(0, n_steps)),
                    device=int(d),
                    fatal=bool(rng.random() < p_fatal),
                )
            )
        for d in targets[n_crashes:]:
            events.append(
                FaultEvent(
                    kind="straggler",
                    step=int(rng.integers(0, n_steps)),
                    device=int(d),
                    slowdown=float(np.round(rng.uniform(2.0, max_slowdown), 3)),
                )
            )
        for _ in range(n_outages if n_links else 0):
            lo, hi = np.sort(rng.uniform(0.0, outage_span, size=2))
            if hi <= lo:  # degenerate draw: widen to a minimal window
                hi = lo + outage_span * 1e-3
            events.append(
                FaultEvent(
                    kind="link_down",
                    step=int(rng.integers(0, n_steps)),
                    link=int(rng.integers(0, n_links)),
                    t_down=float(lo),
                    t_up=float(hi),
                )
            )
        return cls(events=tuple(events), seed=seed)
