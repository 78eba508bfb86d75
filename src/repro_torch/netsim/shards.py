"""Sharded replay: out-of-core pod plans → netsim message rounds.

:func:`repro_torch.netsim.adapters.table_rounds` replays an Algorithm-2 table
with Python loops over every traffic entry — fine at a few hundred
devices, hopeless at the paper's N=2,000 with ~10⁶ CSR entries.  This
module replays the :class:`~repro_torch.core.outofcore.OutOfCorePlan`'s
pod-level forwarding schedule with the same *semantics* (one message per
established connection per barrier stage, the paper's Fig.-4 unit) but
fully vectorized aggregation — ``tests/test_outofcore.py`` pins the
output to ``table_rounds`` message-for-message on small cases, so the
fast path cannot drift from the reference.

Stages (run with ``simulate(..., barriers=True)`` — later stages consume
earlier ones):

0. ``level1`` — intra-pod traffic, plus each device forwarding its
   cross-pod flows to the pod bridges carrying shares of them (a
   bridge's own share stays local);
1. ``level2`` — the aggregated pod-bridge → pod-bridge DCN transfers,
   split by the LPT share fractions;
2. ``fanout`` — receive-side redistribution from the receiving pod's
   bridge to the final consumers.

The P2P baseline (:func:`p2p_rounds`) is a single stage of direct
per-connection messages over the same traffic — the comparison the
paper's Table 2 makes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.netsim.events import Message

__all__ = ["sharded_rounds", "aggregated_table_rounds", "p2p_rounds"]


def _messages(
    src: np.ndarray,
    dst: np.ndarray,
    vals: np.ndarray,
    *,
    rnd: int,
    tag: str,
    bytes_per_unit: float,
    min_bytes: int,
) -> list[Message]:
    """Aggregate COO flows by (src, dst) connection and mint Messages."""
    keep = (src != dst) & (vals > 0)
    src, dst, vals = src[keep], dst[keep], vals[keep]
    if not src.size:
        return []
    n = int(max(src.max(), dst.max())) + 1
    key = src * n + dst
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq, starts = np.unique(key, return_index=True)
    sums = np.add.reduceat(vals, starts)
    nbytes = np.maximum(
        np.round(sums * bytes_per_unit).astype(np.int64), min_bytes
    )
    return [
        Message(int(k // n), int(k % n), int(b), round=rnd, tag=tag)
        for k, b in zip(uniq.tolist(), nbytes.tolist())
    ]


def aggregated_table_rounds(
    tb, *, bytes_per_unit: float = 1.0, min_bytes: int = 1
) -> list[list[Message]]:
    """Vectorized :func:`~repro_torch.netsim.adapters.table_rounds` for grouped
    tables with a sparse :class:`~repro_torch.core.traffic.TrafficMatrix`.

    Identical message sets (same connections, same aggregated bytes,
    same stage/tag), built from O(nnz) array passes instead of per-entry
    Python loops; P2P tables are not supported here — use
    :func:`p2p_rounds`.
    """
    from repro_torch.core.routing import _share_coo_or_primary, group_pair_traffic
    from repro_torch.core.traffic import TrafficMatrix, _ranges

    tm = tb.device_traffic
    if not isinstance(tm, TrafficMatrix):
        raise TypeError("aggregated_table_rounds needs a sparse TrafficMatrix table")
    if tb.bridge.size == 0:
        raise ValueError("P2P table: use p2p_rounds instead")
    g = tb.n_groups
    rows, cols, vals = tm.rows(), tm.indices, tm.data
    gsrc, gdst = tb.group_of[rows], tb.group_of[cols]
    same = gsrc == gdst

    # stage 0a: direct intra-group connections
    l1_src = [rows[same]]
    l1_dst = [cols[same]]
    l1_val = [vals[same]]

    # stage 0b: forward-to-bridge — join cross entries with the share
    # table on the (source group, dst group) key
    cross = ~same
    ck = gsrc[cross] * g + gdst[cross]
    order = np.argsort(ck, kind="stable")
    ck_s = ck[order]
    csrc = rows[cross][order]
    cdst = cols[cross][order]
    cval = vals[cross][order]
    cgs = gsrc[cross][order]
    cgd = gdst[cross][order]
    sdev, sgrp, sfrac = _share_coo_or_primary(tb)
    sk = tb.group_of[sdev] * g + sgrp
    lo = np.searchsorted(ck_s, sk, side="left")
    hi = np.searchsorted(ck_s, sk, side="right")
    idx = _ranges(lo, hi)  # expanded cross-entry index per share entry
    reps = hi - lo
    b_rep = np.repeat(sdev, reps)
    f_rep = np.repeat(sfrac, reps)
    l1_src.append(csrc[idx])
    l1_dst.append(b_rep)
    l1_val.append(cval[idx] * f_rep)

    # stage 1: aggregated bridge → bridge DCN transfers
    gpt = group_pair_traffic(tb)
    l2_src = sdev
    l2_dst = tb.bridge[sgrp, tb.group_of[sdev]]
    l2_val = np.where(l2_dst >= 0, sfrac * gpt[tb.group_of[sdev], sgrp], 0.0)
    l2_dst = np.maximum(l2_dst, 0)  # zeroed flows drop in _messages

    # stage 2: receive-side fan-out from the receiving group's bridge
    fan_src = tb.bridge[cgd, cgs]
    fan_dst = cdst
    fan_val = np.where(fan_src >= 0, cval, 0.0)
    fan_src = np.maximum(fan_src, 0)

    kw = dict(bytes_per_unit=bytes_per_unit, min_bytes=min_bytes)
    return [
        _messages(
            np.concatenate(l1_src),
            np.concatenate(l1_dst),
            np.concatenate(l1_val),
            rnd=0,
            tag="level1",
            **kw,
        ),
        _messages(l2_src, l2_dst, l2_val, rnd=1, tag="level2", **kw),
        _messages(fan_src, fan_dst, fan_val, rnd=2, tag="fanout", **kw),
    ]


def sharded_rounds(
    plan, *, bytes_per_unit: float = 1.0, min_bytes: int = 1
) -> list[list[Message]]:
    """Replay an :class:`~repro_torch.core.outofcore.OutOfCorePlan`'s pod-level
    forwarding schedule as three barrier stages in global device ids.

    A thin wrapper over :func:`aggregated_table_rounds` on the plan's
    ``pod_table`` — the pod tier *is* an Algorithm-2 table whose groups
    are pods, so the replay semantics (and the byte accounting netsim
    conserves) are exactly the ones ``table_rounds`` defines.  Feed the
    result to ``simulate(rounds, two_tier(N, pod_size), barriers=True)``.
    """
    return aggregated_table_rounds(
        plan.pod_table, bytes_per_unit=bytes_per_unit, min_bytes=min_bytes
    )


def p2p_rounds(
    tm, *, bytes_per_unit: float = 1.0, min_bytes: int = 1
) -> list[list[Message]]:
    """Direct P2P baseline: one round, one message per device pair with
    traffic — what :func:`~repro_torch.netsim.adapters.table_rounds` emits for
    a :func:`~repro_torch.core.routing.p2p_routing` table, vectorized."""
    return [
        _messages(
            tm.rows(),
            tm.indices,
            tm.data,
            rnd=0,
            tag="p2p",
            bytes_per_unit=bytes_per_unit,
            min_bytes=min_bytes,
        )
    ]
