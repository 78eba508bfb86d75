"""netsim timeline → trace events + exact critical-path attribution.

Answers the paper's actual question — *where does the latency go?* —
for any simulated schedule.  Two products from the same per-hop
:class:`~repro_torch.netsim.events.Transmission` records:

* :func:`trace_events` / :func:`export_simulation_trace` /
  :func:`emit_simulation` — every link occupation as a Chrome-trace
  complete event (pid = transmitting device, tid = link lane), so a
  replay opens in Perfetto as a per-device, per-link timeline;
* :func:`attribute_critical_path` — walk the wait-for edges back from
  the final delivery and decompose the makespan into **serialization /
  propagation / queueing / outage-stall**, per round and per link kind.

The decomposition is *exact*, not approximate.  It leans on two
structural identities of :func:`repro_torch.netsim.simulate`:

1. within a batch, hop ``h``'s arrival is hop ``h−1``'s end
   *bit-for-bit* (the event queue re-pops the pushed float), and hop
   0's arrival is the batch injection time;
2. across batches, each batch starts at the previous batch's end
   bit-for-bit (``t_round = t_end``).

So summing the per-hop segment durations of each batch's critical
chain — computed as :class:`fractions.Fraction` differences of the
recorded float timestamps, which subtract *exactly* — telescopes to
``Fraction(t_end_final) − Fraction(t0)``, whose nearest float is
precisely the correctly-rounded IEEE subtraction ``t_total``.
:attr:`CriticalPathAttribution.conserved` checks ``float(sum) ==
t_total`` and benchmarks gate it at tolerance 0.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

from repro_torch.obs import trace as _trace
from repro_torch.obs.export import write_chrome_trace

__all__ = [
    "CATEGORIES",
    "CriticalSegment",
    "CriticalPathAttribution",
    "attribute_critical_path",
    "trace_events",
    "emit_simulation",
    "export_simulation_trace",
]

CATEGORIES = ("serialization", "propagation", "queueing", "outage_stall")


@dataclasses.dataclass(frozen=True)
class CriticalSegment:
    """One hop on the critical path and its exact decomposition."""

    batch: int
    round: int
    hop: int
    link: int
    kind: str
    src: int
    dst: int
    nbytes: int
    queueing: Fraction
    outage_stall: Fraction
    propagation: Fraction
    serialization: Fraction

    @property
    def total(self) -> Fraction:
        return (self.queueing + self.outage_stall + self.propagation
                + self.serialization)


@dataclasses.dataclass(frozen=True)
class CriticalPathAttribution:
    """Makespan decomposition of one :class:`~repro_torch.netsim.SimResult`.

    ``total`` / ``by_round`` / ``by_kind`` map category →
    seconds (floats for reporting); the exactness claim is carried by
    ``conserved`` (``float(Σ exact segments) == t_total``, true by
    construction) and ``residual`` (the exact real difference
    ``Σ − t_total``, at most half an ulp of ``t_total``).
    """

    t_total: float
    total: dict[str, float]
    by_round: dict[int, dict[str, float]]
    by_kind: dict[str, dict[str, float]]
    segments: tuple[CriticalSegment, ...]
    conserved: bool
    residual: float

    def kind_fractions(self) -> dict[str, float]:
        """Share of the critical path spent on each link kind."""
        if self.t_total <= 0:
            return {}
        return {
            k: sum(v.values()) / self.t_total
            for k, v in self.by_kind.items()
        }

    def dominant_kind(self) -> tuple[str, float]:
        """The link kind holding the largest critical-path share."""
        fr = self.kind_fractions()
        if not fr:
            return ("", 0.0)
        k = max(sorted(fr), key=lambda kk: fr[kk])
        return (k, fr[k])


def _critical_chains(result):
    """Yield each batch's critical chain (hop records, hop order)."""
    by_batch: dict[int, dict[int, list]] = {}
    for tr in result.transmissions:
        by_batch.setdefault(tr.batch, {}).setdefault(tr.msg, []).append(tr)
    for bi, (bs, be) in enumerate(result.batch_windows):
        if be == bs:  # empty / all-local batch: zero-width, nothing owed
            continue
        msgs = by_batch.get(bi, {})
        crit = None
        for mi in sorted(msgs):
            last = max(msgs[mi], key=lambda tr: tr.hop)
            if last.t_end == be:  # exact: be was assigned from this max
                crit = mi
                break
        if crit is None:  # unreachable when records were collected
            raise ValueError(
                f"batch {bi}: no transmission ends at the batch end {be!r} "
                "(were hop records collected for this result?)"
            )
        yield bi, bs, be, sorted(msgs[crit], key=lambda tr: tr.hop)


def attribute_critical_path(result) -> CriticalPathAttribution:
    """Decompose ``result.t_total`` along the wait-for critical path.

    Requires per-hop records (``simulate(..., collect_hops=True)`` or a
    result produced while the tracer was enabled).
    """
    if result.n_injected and not result.transmissions \
            and any(be > bs for bs, be in result.batch_windows):
        raise ValueError(
            "SimResult carries no Transmission records — rerun "
            "simulate(..., collect_hops=True)"
        )
    zero = {c: Fraction(0) for c in CATEGORIES}
    total = dict(zero)
    by_round: dict[int, dict[str, Fraction]] = {}
    by_kind: dict[str, dict[str, Fraction]] = {}
    segments: list[CriticalSegment] = []

    for _bi, _bs, _be, chain in _critical_chains(result):
        for tr in chain:
            q = Fraction(tr.t_qend) - Fraction(tr.t_arr)
            o = Fraction(tr.t_start) - Fraction(tr.t_qend)
            trans = Fraction(tr.t_end) - Fraction(tr.t_start)
            prop = min(Fraction(tr.alpha_eff), trans)
            ser = trans - prop
            seg = CriticalSegment(
                batch=tr.batch, round=tr.round, hop=tr.hop, link=tr.link,
                kind=tr.kind, src=tr.src, dst=tr.dst, nbytes=tr.nbytes,
                queueing=q, outage_stall=o, propagation=prop,
                serialization=ser,
            )
            segments.append(seg)
            for cat, val in (("queueing", q), ("outage_stall", o),
                             ("propagation", prop), ("serialization", ser)):
                total[cat] += val
                by_round.setdefault(tr.round, dict(zero))[cat] += val
                by_kind.setdefault(tr.kind, dict(zero))[cat] += val

    grand = sum(total.values(), Fraction(0))
    residual = grand - (Fraction(result.t_total))
    conserved = float(grand) == float(result.t_total)
    return CriticalPathAttribution(
        t_total=float(result.t_total),
        total={c: float(v) for c, v in total.items()},
        by_round={r: {c: float(v) for c, v in d.items()}
                  for r, d in sorted(by_round.items())},
        by_kind={k: {c: float(v) for c, v in d.items()}
                 for k, d in sorted(by_kind.items())},
        segments=tuple(segments),
        conserved=conserved,
        residual=float(residual),
    )


def trace_events(result, *, anchor_us: float = 0.0) -> list[dict]:
    """Chrome-style events (tracer vocabulary, string pid/tid labels)
    for every recorded transmission; 1 simulated second = 1 trace
    second, offset by ``anchor_us``.  Pure — deterministic given the
    result, so exporting twice is byte-identical (golden-tested)."""
    out: list[dict] = []
    base = float(anchor_us) - float(result.t0) * 1e6
    for tr in result.transmissions:
        queue_us = (tr.t_qend - tr.t_arr) * 1e6
        stall_us = (tr.t_start - tr.t_qend) * 1e6
        ev = {
            "ph": "X",
            "name": tr.tag or f"msg{tr.msg}",
            "cat": "netsim",
            "ts": base + tr.t_start * 1e6,
            "dur": (tr.t_end - tr.t_start) * 1e6,
            "pid": f"dev{tr.src}",
            "tid": f"link{tr.link}:{tr.kind}",
            "args": {
                "round": tr.round, "hop": tr.hop, "dst": tr.dst,
                "nbytes": tr.nbytes, "queue_us": queue_us,
                "outage_stall_us": stall_us,
            },
        }
        out.append(ev)
    for bi, (bs, be) in enumerate(result.batch_windows):
        out.append({
            "ph": "i",
            "name": f"batch{bi}_end",
            "cat": "netsim",
            "ts": base + be * 1e6,
            "pid": "netsim",
            "tid": "batches",
            "s": "t",
            "args": {"t_start_s": bs, "t_end_s": be},
        })
    return out


def emit_simulation(result, tracer: _trace.Tracer | None = None) -> None:
    """Mirror a simulated timeline into the (enabled) tracer, anchored
    at the current wall-clock trace time — the hook
    :func:`repro_torch.netsim.simulate` calls."""
    tr = tracer or _trace.TRACER
    if not tr.enabled:
        return
    anchor = tr.now_us()
    for ev in trace_events(result, anchor_us=anchor):
        tr._events.append(ev)
    att = attribute_critical_path(result)
    tr.instant(
        "netsim.critical_path", cat="netsim", pid="netsim", tid="summary",
        args={
            "t_total_s": att.t_total,
            "conserved": att.conserved,
            **{c: att.total[c] for c in CATEGORIES},
        },
    )


def export_simulation_trace(result, path: str) -> str:
    """Standalone deterministic export of one simulation's timeline."""
    return write_chrome_trace(path, trace_events(result))
