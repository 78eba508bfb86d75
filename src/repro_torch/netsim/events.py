"""Discrete-event machinery: messages, delivery records, event queue.

The simulator's unit of work is a :class:`Message` — one point-to-point
transfer between device NICs, produced by the adapters in
:mod:`repro_torch.netsim.adapters` from the *actual executed artifacts* of
this repo (``exchange_schedule`` rounds, :class:`~repro_torch.snn.ragged.RaggedPlan`
perms, Algorithm-2 routing tables).  :class:`EventQueue` is a thin heap
wrapper that guarantees deterministic ordering: events at equal
timestamps pop in insertion order (a monotone sequence number breaks
ties), so two runs of the same schedule produce identical timelines.
"""
from __future__ import annotations

import dataclasses
import heapq

__all__ = ["Message", "Delivery", "Transmission", "EventQueue"]


@dataclasses.dataclass(frozen=True)
class Message:
    """One point-to-point transfer between device NICs.

    Attributes:
      src: sending device id.
      dst: receiving device id (``src == dst`` is local, zero-cost).
      nbytes: wire bytes.
      round: schedule round the message belongs to.  Round semantics are
        chosen at simulation time: by default rounds *pipeline* (each
        NIC serializes its sends in round order, no global sync);
        schedules whose later rounds consume earlier ones must pass
        ``barriers=True`` to :func:`repro_torch.netsim.simulate`.
      tag: free-form provenance label ('sparse', 'ragged', 'level1', ...).
    """

    src: int
    dst: int
    nbytes: int
    round: int = 0
    tag: str = ""


@dataclasses.dataclass(frozen=True)
class Delivery:
    """Per-message timeline record (``collect_events=True``)."""

    src: int
    dst: int
    nbytes: int
    round: int
    tag: str
    t_inject: float
    t_deliver: float
    queue_wait: float  # total time spent waiting behind busy links
    n_hops: int


@dataclasses.dataclass(frozen=True)
class Transmission:
    """One link occupation — a single hop of a single message
    (``collect_hops=True`` or an enabled tracer).

    The four timestamps partition the hop's wall interval exactly:
    ``[t_arr, t_qend)`` is FIFO queueing behind earlier traffic on the
    link, ``[t_qend, t_start)`` is stalling for a down window to end,
    and ``[t_start, t_end)`` is the transmission itself (``alpha_eff``
    propagation + serialization).  For hop ``h > 0``, ``t_arr`` equals
    the previous hop's ``t_end`` *bit-for-bit* (the event queue re-pops
    the pushed float), and hop 0's ``t_arr`` equals the batch injection
    time — the structural identities :mod:`repro_torch.obs.timeline` exploits
    to decompose ``t_total`` with zero residual.
    """

    batch: int  # injection-wave index (pipelined: 0; barriers: round)
    msg: int  # message index within the batch
    round: int
    src: int
    dst: int
    nbytes: int
    tag: str
    hop: int
    link: int
    kind: str
    t_arr: float  # arrival at this link (pop time)
    t_qend: float  # queue cleared: max(t_arr, link free time)
    t_start: float  # transmission start (after any outage stall)
    t_end: float  # transmission end (start + alpha_eff + nbytes·beta)
    alpha_eff: float  # link alpha, + alpha_msg on hop 0


class EventQueue:
    """Min-heap of ``(time, seq, payload)`` with FIFO tie-breaking."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, object]] = []
        self._seq = 0
        self.pushed = 0
        self.popped = 0

    def push(self, time: float, payload: object) -> None:
        heapq.heappush(self._heap, (time, self._seq, payload))
        self._seq += 1
        self.pushed += 1

    def pop(self) -> tuple[float, object]:
        time, _, payload = heapq.heappop(self._heap)
        self.popped += 1
        return time, payload

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
