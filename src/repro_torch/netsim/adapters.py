"""Adapters: executed repo artifacts → netsim message rounds.

The simulator's whole point is that its inputs are the *actual executed
schedules* this repo already produces, not re-derived analytic
formulas:

* :func:`sparse_rounds` / :func:`flat_rounds` replay the masked
  ``lax.ppermute`` rounds of :func:`repro_torch.snn.sparse.exchange_schedule`
  (via :func:`~repro_torch.snn.sparse.exchange_messages`, the executor's own
  wire-level view);
* :func:`ragged_rounds` replays a :class:`repro_torch.snn.ragged.RaggedPlan`'s
  per-round ``(bridge, bridge)`` pairs at their padded ``K_r`` widths
  (:meth:`~repro_torch.snn.ragged.RaggedPlan.round_messages`);
* :func:`table_rounds` replays Algorithm-2 :class:`~repro_torch.core.routing.RoutingTable`
  forwarding — level-1 direct + forward-to-bridge, the aggregated
  level-2 bridge exchange, and the receive-side fan-out;
* :func:`a2a_rounds` replays the flat / two-level all-to-all phases of
  :func:`repro_torch.core.hierarchical.dispatch_rounds`.

Every adapter's total bytes are pinned to the repo's independent byte
accounting (``exchange_volume``, ``dispatch_bytes``) by property tests
in ``tests/test_netsim.py`` — the simulator cannot drift from what the
engine moves.
"""
from __future__ import annotations

import numpy as np

from repro_torch.netsim.events import Message

__all__ = [
    "rounds_from_triples",
    "sparse_rounds",
    "flat_rounds",
    "ragged_rounds",
    "table_rounds",
    "a2a_rounds",
    "total_bytes",
]


def rounds_from_triples(
    triples: list[list[tuple[int, int, int]]], tag: str = ""
) -> list[list[Message]]:
    """Wrap per-round ``(src, dst, nbytes)`` triples as message rounds."""
    return [
        [Message(src, dst, nbytes, round=r, tag=tag) for src, dst, nbytes in rnd]
        for r, rnd in enumerate(triples)
    ]


def total_bytes(rounds: list[list[Message]]) -> int:
    """Wire bytes a schedule injects — the quantity pinned to
    ``exchange_volume`` in tests and benchmarks."""
    return sum(m.nbytes for rnd in rounds for m in rnd)


def sparse_rounds(
    mask: np.ndarray,
    mesh_shape: tuple[int, ...],
    block_bytes: int,
) -> list[list[Message]]:
    """Replay the masked (``exchange='sparse'``) schedule for a
    device-level block ``mask`` on ``mesh_shape``.

    Pools the mask to group granularity exactly like the executor
    (``pool_block_mask`` minus the diagonal) and emits the executed
    ``ppermute`` pairs; total bytes equal
    ``exchange_volume(mask, ...)['sparse']``.
    """
    from repro_torch.core.routing import pool_block_mask
    from repro_torch.snn.sparse import exchange_messages

    n = int(mask.shape[0])
    if len(mesh_shape) == 1:
        g, r = int(mesh_shape[0]), 1
    else:
        g, r = int(mesh_shape[0]), int(np.prod(mesh_shape[1:]))
    if g * r != n:
        raise ValueError(f"mesh {mesh_shape} incompatible with mask [{n},{n}]")
    gm = pool_block_mask(mask, np.arange(n) // r, g)
    np.fill_diagonal(gm, False)
    return rounds_from_triples(exchange_messages(gm, mesh_shape, block_bytes), tag="sparse")


def flat_rounds(
    mesh_shape: tuple[int, ...], block_bytes: int
) -> list[list[Message]]:
    """Replay the dense (``exchange='flat'``) schedule: every
    off-diagonal group pair moves — ``exchange_volume(...)['flat']``."""
    g = int(mesh_shape[0])
    gm = ~np.eye(g, dtype=bool)
    from repro_torch.snn.sparse import exchange_messages

    return rounds_from_triples(exchange_messages(gm, mesh_shape, block_bytes), tag="flat")


def ragged_rounds(plan) -> list[list[Message]]:
    """Replay a :class:`~repro_torch.snn.ragged.RaggedPlan`'s executed
    bridge-to-bridge schedule; total bytes equal ``plan.bytes_per_step``
    (= ``exchange_volume(..., plan=plan)['ragged']``, padding included).
    """
    return rounds_from_triples(plan.round_messages(), tag="ragged")


def table_rounds(
    tb,
    *,
    bytes_per_unit: float = 1.0,
    min_bytes: int = 1,
) -> list[list[Message]]:
    """Replay the forwarding schedule an Algorithm-2 routing table
    implies, one barrier per forwarding stage.

    Message granularity is one message per *connection* per step — the
    paper's unit (Fig. 4 counts connections; a device's many flows to
    the same peer share one established connection, so each step it
    sends that peer ONE message carrying the aggregated bytes):

    * P2P table: a single round of direct per-connection messages.
    * Two-level table: round 0 — level-1 intra-group connections plus
      each device's forward connections to the bridges carrying shares
      of its cross-group flows (the sender's own share stays local,
      matching :func:`~repro_torch.core.routing.level1_egress`); round 1 —
      the aggregated level-2 bridge→bridge transfers, split by the LPT
      ``share`` fractions (matching
      :func:`~repro_torch.core.routing.level2_egress`); round 2 — receive-side
      fan-out from the receiving bridge to the final consumers (the
      paper's bridge re-distribution, intra-group links again).

    Traffic units convert to wire bytes via ``bytes_per_unit`` and are
    floored at ``min_bytes`` so nonzero flows never vanish.
    """
    from repro_torch.core.routing import (
        _share_coo_or_primary,
        group_pair_traffic,
    )
    from repro_torch.core.traffic import TrafficMatrix

    tm = tb.device_traffic
    if not isinstance(tm, TrafficMatrix):
        tm = TrafficMatrix.from_dense(np.asarray(tm, dtype=np.float64))
    rows, cols, vals = tm.rows(), tm.indices, tm.data

    def _b(v: float) -> int:
        return max(int(round(v * bytes_per_unit)), min_bytes)

    def _agg(acc: dict, src: int, dst: int, v: float) -> None:
        acc[(src, dst)] = acc.get((src, dst), 0.0) + v

    def _msgs(acc: dict, rnd: int, tag: str) -> list[Message]:
        return [
            Message(s, d, _b(v), round=rnd, tag=tag)
            for (s, d), v in acc.items()
        ]

    if tb.method == "p2p":
        msgs = [
            Message(int(s), int(d), _b(v), round=0, tag="p2p")
            for s, d, v in zip(rows, cols, vals)
            if s != d and v > 0
        ]
        return [msgs]

    gsrc, gdst = tb.group_of[rows], tb.group_of[cols]
    same = gsrc == gdst
    l1_acc: dict[tuple[int, int], float] = {}
    for s, d, v in zip(rows[same], cols[same], vals[same]):
        if s != d and v > 0:
            _agg(l1_acc, int(s), int(d), float(v))
    # (src group, dst group) → [(bridge device, share fraction), ...]
    sdev, sgrp, sfrac = _share_coo_or_primary(tb)
    bridges_of: dict[tuple[int, int], list[tuple[int, float]]] = {}
    for dv, gr, fr in zip(sdev, sgrp, sfrac):
        bridges_of.setdefault(
            (int(tb.group_of[dv]), int(gr)), []
        ).append((int(dv), float(fr)))
    # forward-to-bridge hops (sender's own share stays local) and the
    # receive-side fan-out, both aggregated per connection
    cross = ~same
    fan_acc: dict[tuple[int, int], float] = {}
    for s, d, v, gs, gd in zip(rows[cross], cols[cross], vals[cross], gsrc[cross], gdst[cross]):
        if v <= 0:
            continue
        for bdev, frac in bridges_of.get((int(gs), int(gd)), []):
            if bdev != s:
                _agg(l1_acc, int(s), bdev, float(v) * frac)
        b_in = int(tb.bridge[int(gd), int(gs)]) if tb.bridge.size else -1
        if b_in >= 0 and b_in != d:
            _agg(fan_acc, b_in, int(d), float(v))
    # aggregated level-2 bridge → bridge transfers
    gpt = group_pair_traffic(tb)
    l2_acc: dict[tuple[int, int], float] = {}
    for dv, gr, fr in zip(sdev, sgrp, sfrac):
        gs = int(tb.group_of[dv])
        flow = float(gpt[gs, int(gr)]) * float(fr)
        if flow <= 0:
            continue
        b_in = int(tb.bridge[int(gr), gs]) if tb.bridge.size else -1
        if b_in < 0 or b_in == dv:
            continue
        _agg(l2_acc, int(dv), b_in, flow)
    return [
        _msgs(l1_acc, 0, "level1"),
        _msgs(l2_acc, 1, "level2"),
        _msgs(fan_acc, 2, "fanout"),
    ]


def a2a_rounds(
    n_pods: int, n_inner: int, chunk_bytes: int, *, two_level: bool
) -> list[list[Message]]:
    """Replay the flat / two-level all-to-all phases of
    :func:`repro_torch.core.hierarchical.dispatch_rounds`."""
    from repro_torch.core.hierarchical import dispatch_rounds

    return rounds_from_triples(
        dispatch_rounds(n_pods, n_inner, chunk_bytes, two_level=two_level),
        tag="two_level" if two_level else "flat_a2a",
    )
