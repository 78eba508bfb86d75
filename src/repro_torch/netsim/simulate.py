"""The discrete-event interconnect simulator.

Store-and-forward at message granularity with FIFO link serialization:
a message traversing link ``l`` occupies it for ``alpha_l + nbytes ·
beta_l`` seconds, starting no earlier than the link frees up — queueing
behind shared links IS the congestion model, so hot leaf↔spine uplinks
and overloaded bridge NICs emerge from the schedule instead of being
postulated (the α–β–congestion model of the closed-form backend, with
the congestion term *simulated* rather than fitted).

Round semantics match the executed schedules: by default rounds
*pipeline* (injected in round-major order, so each device's sends
serialize through its NIC in round order — back-to-back ``ppermute``
rounds carry no cross-round data dependency), while ``barriers=True``
inserts a global barrier after each round for schedules whose later
stages consume earlier ones (Algorithm-2 forwarding).  The simulator is
pure numpy/python (no jax) and fully deterministic — equal-time events
process in injection order.

Conservation is structural and audited: :class:`SimResult` carries
injected/delivered message and byte counts plus the event-queue
counters, and :meth:`SimResult.assert_conserved` verifies every
injected message was delivered exactly once with no event-queue leaks
(property-tested in ``tests/test_netsim.py``).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

from repro_torch.netsim.events import Delivery, EventQueue, Message, Transmission
from repro_torch.netsim.topology import Topology
from repro_torch.obs import trace as _obs

__all__ = ["LinkOutage", "SimResult", "simulate"]


@dataclasses.dataclass(frozen=True)
class LinkOutage:
    """One link-down window: ``link`` carries nothing in
    ``[t_down, t_up)`` (absolute simulation seconds).

    A transmission cannot *begin* inside the window; one already in
    flight at ``t_down`` drains (store-and-forward switches buffer the
    frame).  Messages whose first hop finds any path link down reroute
    over the topology's precomputed backup route when one exists
    (:meth:`~repro_torch.netsim.topology.Topology.route_avoiding`) and stall
    until ``t_up`` otherwise — conservation holds either way.
    """

    link: int
    t_down: float
    t_up: float

    def __post_init__(self):
        if not (0.0 <= self.t_down < self.t_up):
            raise ValueError(
                f"outage window [{self.t_down}, {self.t_up}) is empty"
            )


def _down_windows(outages, n_links) -> dict[int, list[tuple[float, float]]]:
    """Per-link sorted down windows (overlaps merged)."""
    by_link: dict[int, list[tuple[float, float]]] = {}
    for o in outages:
        if not (0 <= o.link < n_links):
            raise ValueError(f"outage on unknown link {o.link}")
        by_link.setdefault(o.link, []).append((float(o.t_down), float(o.t_up)))
    for lid, win in by_link.items():
        win.sort()
        merged = [win[0]]
        for lo, hi in win[1:]:
            if lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
            else:
                merged.append((lo, hi))
        by_link[lid] = merged
    return by_link


def _is_down(windows, t: float) -> bool:
    return windows is not None and any(lo <= t < hi for lo, hi in windows)


def _clear_of(windows, t: float) -> float:
    """Earliest time ≥ t outside every down window."""
    if windows is None:
        return t
    for lo, hi in windows:  # sorted; t only moves forward
        if lo <= t < hi:
            t = hi
    return t


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Outcome of one simulated schedule replay.

    Attributes:
      t_total: critical-path latency — last delivery, seconds.
      round_ends: absolute time each round's last message delivered
        (the per-round timeline; under pipelined injection rounds
        overlap, under ``barriers=True`` differences are per-round
        makespans).
      n_injected / n_delivered: message conservation counters.
      bytes_injected / bytes_delivered: byte conservation counters.
      link_busy_s: ``float64[n_links]`` seconds each link spent
        transmitting (utilization = busy / t_total).
      link_bytes: ``float64[n_links]`` bytes each link carried.
      link_msgs: ``int64[n_links]`` transits per link.
      queue_pushed / queue_popped: event-queue audit counters (equal ⇔
        no leaked events).
      topology: the topology simulated (for link-kind reports).
      deliveries: per-message :class:`Delivery` records when
        ``collect_events=True`` (else empty).
      n_rerouted: messages that switched to a backup route because a
        primary-path link was down at injection.
      outage_stall_s: total seconds transmissions waited specifically
        for a down window to end (congestion waits excluded).
      link_down_s: ``float64[n_links]`` seconds each link was down
        within the simulated horizon (``None`` on results built before
        outages existed — treated as all-up).
      transmissions: per-hop :class:`Transmission` records when
        ``collect_hops=True`` or the tracer was enabled (else empty) —
        the input to :mod:`repro_torch.obs.timeline` critical-path
        attribution.
      batch_windows: ``(t_start, t_end)`` per injection wave, with each
        wave's start equal to the previous wave's end bit-for-bit (the
        telescoping the attribution's exactness rests on).
      t0: the injection origin the simulation ran with.
    """

    t_total: float
    round_ends: tuple[float, ...]
    n_injected: int
    n_delivered: int
    bytes_injected: int
    bytes_delivered: int
    link_busy_s: np.ndarray
    link_bytes: np.ndarray
    link_msgs: np.ndarray
    queue_pushed: int
    queue_popped: int
    topology: Topology
    deliveries: tuple[Delivery, ...] = ()
    n_rerouted: int = 0
    outage_stall_s: float = 0.0
    link_down_s: np.ndarray | None = None
    transmissions: tuple[Transmission, ...] = ()
    batch_windows: tuple[tuple[float, float], ...] = ()
    t0: float = 0.0

    @property
    def round_makespans(self) -> tuple[float, ...]:
        """Per-round durations — meaningful under ``barriers=True``
        (pipelined rounds overlap, so differences can be ≤ 0 there)."""
        out, prev = [], 0.0
        for e in self.round_ends:
            out.append(e - prev)
            prev = e
        return tuple(out)

    def bytes_by_kind(self) -> dict[str, float]:
        """Total bytes carried per link kind ('nic_up', 'leaf_up', ...)."""
        out: dict[str, float] = {}
        for lnk, b in zip(self.topology.links, self.link_bytes):
            out[lnk.kind] = out.get(lnk.kind, 0.0) + float(b)
        return out

    def utilization_by_kind(self) -> dict[str, float]:
        """Peak link utilization (busy / t_total) per link kind."""
        if self.t_total <= 0:
            return {}
        out: dict[str, float] = {}
        for lnk, busy in zip(self.topology.links, self.link_busy_s):
            u = float(busy) / self.t_total
            out[lnk.kind] = max(out.get(lnk.kind, 0.0), u)
        return out

    def link_utilization(self) -> np.ndarray:
        """Per-link utilization (busy / t_total), ``float64[n_links]``.

        An empty schedule (``t_total == 0``) utilizes nothing — all
        zeros, never a division by zero.
        """
        if self.t_total <= 0:
            return np.zeros_like(self.link_busy_s)
        return self.link_busy_s / self.t_total

    def bottleneck_link(self) -> int:
        """Id of the busiest link (the congestion point)."""
        return int(np.argmax(self.link_busy_s))

    def worst_device(self) -> int:
        """Device whose egress links were busiest — the straggler the
        closed-form model's per-device max corresponds to.

        Busy time is normalized by each link's *availability*: a link
        down for part of the run is scored on the time it could actually
        transmit (``busy · t_total / (t_total − down_s)``), so an outage
        neither hides a genuinely hot NIC nor lets a mostly-down link's
        low raw busy time misattribute the straggler.  With no outages
        the factor is 1 and the ranking is the historical busiest-egress.

        The normalization clamps: down time is capped at ``t_total``
        (an outage window can extend past the horizon) and availability
        at 1% of the horizon, so a link down for (nearly) the whole run
        scores at most 100× its raw busy time instead of diverging.
        ``t_total == 0`` skips normalization entirely.
        """
        egress = self.topology.device_egress_links()
        down = self.link_down_s
        scores = []
        for ls in egress:
            s = 0.0
            for l in ls:
                busy = float(self.link_busy_s[l])
                if down is not None and self.t_total > 0 and busy > 0:
                    down_l = min(float(down[l]), self.t_total)
                    avail = max(self.t_total - down_l, 0.01 * self.t_total)
                    busy *= self.t_total / avail
                s += busy
            scores.append(s)
        return int(np.argmax(scores))

    def assert_conserved(self) -> None:
        """Every injected message delivered exactly once, no queue leaks."""
        if self.n_delivered != self.n_injected:
            raise AssertionError(
                f"{self.n_injected} messages injected, {self.n_delivered} delivered"
            )
        if self.bytes_delivered != self.bytes_injected:
            raise AssertionError(
                f"{self.bytes_injected} bytes injected, "
                f"{self.bytes_delivered} delivered"
            )
        if self.queue_pushed != self.queue_popped:
            raise AssertionError(
                f"event-queue leak: {self.queue_pushed} pushed, "
                f"{self.queue_popped} popped"
            )


def simulate(
    rounds: Sequence[Sequence[Message]],
    topo: Topology,
    *,
    alpha_msg: float = 0.0,
    barriers: bool = False,
    collect_events: bool = False,
    collect_hops: bool = False,
    t0: float = 0.0,
    outages: Sequence[LinkOutage] = (),
) -> SimResult:
    """Replay ``rounds`` of messages over ``topo``.

    Args:
      rounds: per-round message batches (the shape every adapter in
        :mod:`repro_torch.netsim.adapters` produces).
      topo: the interconnect.
      alpha_msg: extra per-message cost charged at the *first* hop —
        models host-side connection setup (the closed-form model's
        ``alpha_conn``); with thousands of P2P flows these serialize at
        the source NIC, reproducing the paper's connection-count
        collapse.
      barriers: synchronization between rounds.  ``False`` (default)
        *pipelines*: every message injects at ``t0`` in round-major
        order, so a device's sends serialize through its NIC in round
        order but independent devices never wait — the faithful model of
        back-to-back ``ppermute`` rounds, which carry no cross-round
        data dependency.  ``True`` inserts a global barrier after each
        round — correct when later rounds *consume* earlier ones
        (Algorithm-2 forwarding: bridges aggregate only after level-1
        delivers).
      collect_events: keep a :class:`Delivery` record per message.
      collect_hops: keep a :class:`Transmission` record per link hop
        (forced on while the :mod:`repro_torch.obs` tracer is enabled, which
        also mirrors the timeline into the active trace).
      outages: :class:`LinkOutage` down windows.  A transmission never
        *starts* inside a window (in-flight frames drain); a message
        whose first hop finds a path link down switches to the
        topology's backup route when one avoids every currently-down
        link (``n_rerouted`` counts these) and otherwise stalls until
        the window ends (``outage_stall_s`` accumulates the waiting).
        Conservation is unaffected either way.

    Returns:
      :class:`SimResult`; call ``assert_conserved()`` to audit it.
    """
    n_links = topo.n_links
    free = np.zeros(n_links)
    busy = np.zeros(n_links)
    link_bytes = np.zeros(n_links)
    link_msgs = np.zeros(n_links, dtype=np.int64)
    q = EventQueue()
    deliveries: list[Delivery] = []
    n_rounds = len(rounds)
    round_ends = np.full(n_rounds, float(t0))
    n_inj = n_del = 0
    bytes_inj = bytes_del = 0
    t_round = float(t0)
    win = _down_windows(outages, n_links)
    n_rerouted = 0
    outage_stall = 0.0
    tracing = _obs.is_enabled()
    collect_hops = collect_hops or tracing
    hops: list[Transmission] = []
    windows_out: list[tuple[float, float]] = []

    if barriers:
        batches = [[(ri, m) for m in rnd] for ri, rnd in enumerate(rounds)]
    else:  # one injection wave, round-major order
        batches = [[(ri, m) for ri, rnd in enumerate(rounds) for m in rnd]]

    for bi, batch in enumerate(batches):
        paths = [topo.route(m.src, m.dst) for _, m in batch]
        waits = [0.0] * len(batch)
        t_end = t_round
        for mi, ((ri, m), path) in enumerate(zip(batch, paths)):
            n_inj += 1
            bytes_inj += m.nbytes
            if not path:  # local delivery (src == dst)
                n_del += 1
                bytes_del += m.nbytes
                if collect_events:
                    deliveries.append(
                        Delivery(m.src, m.dst, m.nbytes, m.round, m.tag, t_round, t_round, 0.0, 0)
                    )
                continue
            q.push(t_round, (mi, 0))
        while q:
            t, payload = q.pop()
            mi, hop = payload
            (ri, m), path = batch[mi], paths[mi]
            if win and hop == 0 and any(_is_down(win.get(l), t) for l in path):
                # first hop met an outage: take the precomputed backup
                # route when one dodges every currently-down link, else
                # keep the primary and stall below
                down_now = frozenset(l for l in win if _is_down(win[l], t))
                alt = topo.route_avoiding(m.src, m.dst, down_now)
                if alt is not None and tuple(alt) != tuple(path):
                    paths[mi] = path = tuple(alt)
                    n_rerouted += 1
            lid = path[hop]
            lnk = topo.links[lid]
            dur = lnk.alpha + m.nbytes * lnk.beta
            alpha_eff = lnk.alpha
            if hop == 0:
                dur += alpha_msg
                alpha_eff += alpha_msg
            start = t if t >= free[lid] else free[lid]
            t_qend = start
            if win:
                up = _clear_of(win.get(lid), start)
                outage_stall += up - start
                start = up
            waits[mi] += start - t
            end = start + dur
            if collect_hops:
                hops.append(Transmission(
                    bi, mi, ri, m.src, m.dst, m.nbytes, m.tag, hop, lid,
                    lnk.kind, t, t_qend, start, end, alpha_eff,
                ))
            free[lid] = end
            busy[lid] += dur
            link_bytes[lid] += m.nbytes
            link_msgs[lid] += 1
            if hop + 1 < len(path):
                q.push(end, (mi, hop + 1))
            else:
                n_del += 1
                bytes_del += m.nbytes
                if end > t_end:
                    t_end = end
                if end > round_ends[ri]:
                    round_ends[ri] = end
                if collect_events:
                    deliveries.append(
                        Delivery(
                            m.src,
                            m.dst,
                            m.nbytes,
                            m.round,
                            m.tag,
                            t_round,
                            end,
                            waits[mi],
                            len(path),
                        )
                    )
        windows_out.append((t_round, t_end))
        t_round = t_end  # with barriers: next round starts after the slowest

    down_s = np.zeros(n_links)
    for lid, windows in win.items():
        down_s[lid] = sum(
            max(0.0, min(hi, t_round) - max(lo, float(t0)))
            for lo, hi in windows
        )
    result = SimResult(
        t_total=(t_round - t0) if n_rounds else 0.0,
        round_ends=tuple(float(e) for e in round_ends),
        n_injected=n_inj,
        n_delivered=n_del,
        bytes_injected=bytes_inj,
        bytes_delivered=bytes_del,
        link_busy_s=busy,
        link_bytes=link_bytes,
        link_msgs=link_msgs,
        queue_pushed=q.pushed,
        queue_popped=q.popped,
        topology=topo,
        deliveries=tuple(deliveries),
        n_rerouted=n_rerouted,
        outage_stall_s=outage_stall,
        link_down_s=down_s,
        transmissions=tuple(hops),
        batch_windows=tuple(windows_out),
        t0=float(t0),
    )
    if tracing:
        # mirror the simulated timeline into the active trace, sim
        # second 0 anchored at the wall-clock moment we finished
        from repro_torch.obs.timeline import emit_simulation

        emit_simulation(result)
    return result
