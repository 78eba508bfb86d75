"""Dense reference implementation of Algorithm 2 — the parity oracle.

This module preserves the original ``float64[N, N]`` routing pipeline
(straightforward matrix/loop formulations, independent of the CSR scatter
machinery) so the sparse core in :mod:`repro_torch.core.routing` can be checked
against it bit-for-bit on small instances (N ≤ ~256).  It is **not** meant
for production use: memory and time are O(N²) and worse.

The two historical accounting bugs are fixed here exactly as in the
sparse core, so the two paths stay comparable:

  * forwarder devices connect to *every* bridge of a split group-pair
    flow, not only the primary ``bridge[gs, gd]``;
  * the ``n_groups=None`` sweep deduplicates G candidates and reuses one
    device graph.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import CommGraph, build_graph
from repro_torch.core import routing
from repro_torch.core.routing import RoutingTable, sweep_candidates

__all__ = [
    "two_level_routing_dense",
    "p2p_routing_dense",
    "connection_counts_dense",
    "connection_components_dense",
    "group_pair_traffic_dense",
    "level1_egress_dense",
    "level2_egress_dense",
]


def _graph_from_traffic_dense(t: np.ndarray, wg: np.ndarray) -> CommGraph:
    src, dst = np.nonzero(t)
    vals = t[src, dst]
    w = np.where(wg > 0, wg, 1.0)
    denom = w[src] * w[dst]
    probs = np.clip(vals / np.maximum(denom, 1e-30), 0.0, None)
    pscale = probs.max() if probs.size else 1.0
    probs = probs / max(pscale, 1e-30)
    return build_graph(src, dst, probs, w, sym=False)


def two_level_routing_dense(
    traffic: np.ndarray,
    wg: np.ndarray,
    n_groups: int | None = None,
    *,
    itermax: int = 8,
    balance_slack: float = 0.05,
    seed: int = 0,
    grouping: str = "greedy",
) -> RoutingTable:
    """Dense Algorithm 2 (see :func:`repro_torch.core.routing.two_level_routing`)."""
    traffic = np.asarray(traffic, dtype=np.float64)
    n = traffic.shape[0]
    if traffic.shape != (n, n):
        raise ValueError("traffic must be square")
    if n_groups is None:
        cands = sweep_candidates(n)
        if not cands:
            raise ValueError("too few devices for grouping")
        dg = _graph_from_traffic_dense(traffic, wg)
        best, best_peak = None, np.inf
        for g in cands:
            tb = _route_dense(
                traffic, wg, g, dg, itermax, balance_slack, seed, grouping
            )
            peak = float(level2_egress_dense(tb).max())
            if peak < best_peak:
                best, best_peak = tb, peak
        return best
    if n_groups <= 0 or n_groups > n:
        raise ValueError("need 1 <= n_groups <= n_devices")
    dg = _graph_from_traffic_dense(traffic, wg)
    return _route_dense(
        traffic, wg, n_groups, dg, itermax, balance_slack, seed, grouping
    )


def _route_dense(traffic, wg, n_groups, dg, itermax, balance_slack, seed, grouping):
    # the grouping dispatch is shared with the sparse core on purpose —
    # the oracle's independence lives in the traffic/bridge/measurement
    # formulations, not in how a partitioner is looked up
    if grouping not in routing._GROUPERS:
        raise ValueError(f"unknown grouping {grouping!r}")
    res = routing._GROUPERS[grouping](dg, n_groups, itermax, balance_slack, seed)
    group_of = res.assign
    bridge, share = _select_bridges_dense(traffic, group_of, n_groups)
    b_idx, g_idx = np.nonzero(share > 0)
    tb = RoutingTable(
        group_of=group_of,
        n_groups=n_groups,
        bridge=bridge,
        device_traffic=traffic,
        method=grouping,
        share_coo=(b_idx, g_idx, share[b_idx, g_idx]),
    )
    tb.validate()
    return tb


def _select_bridges_dense(
    traffic: np.ndarray, group_of: np.ndarray, n_groups: int
) -> tuple[np.ndarray, np.ndarray]:
    """Original dense LPT bridge selection (reference formulation)."""
    n = traffic.shape[0]
    bridge = np.full((n_groups, n_groups), -1, dtype=np.int64)
    share = np.zeros((n, n_groups))
    dev_to_grp = np.zeros((n, n_groups))
    for g in range(n_groups):
        dev_to_grp[:, g] = traffic[:, group_of == g].sum(axis=1)
    grp_pair = np.zeros((n_groups, n_groups))
    for g in range(n_groups):
        grp_pair[g] = dev_to_grp[group_of == g].sum(axis=0)
    bridge_load = np.zeros(n)
    for gs in range(n_groups):
        members = np.nonzero(group_of == gs)[0]
        flows = grp_pair[gs].copy()
        flows[gs] = 0.0
        total = flows.sum()
        target = total / max(len(members), 1)
        for gd in np.argsort(-flows, kind="stable"):
            f = flows[gd]
            if gd == gs or f <= 0:
                bridge[gs, gd] = members[0] if gd != gs else -1
                continue
            k = int(min(len(members), max(1, np.ceil(f / max(target, 1e-30)))))
            key = bridge_load[members] - 1e-12 * dev_to_grp[members, gd]
            picks = members[np.argsort(key, kind="stable")[:k]]
            bridge[gs, gd] = picks[0]
            for b in picks:
                share[b, gd] += 1.0 / k
                bridge_load[b] += f / k
    return bridge, share


def p2p_routing_dense(traffic: np.ndarray, wg: np.ndarray) -> RoutingTable:
    """Dense P2P baseline table."""
    traffic = np.asarray(traffic, dtype=np.float64)
    n = traffic.shape[0]
    return RoutingTable(
        group_of=np.arange(n, dtype=np.int64),
        n_groups=n,
        bridge=np.empty((0, 0), dtype=np.int64),
        device_traffic=traffic,
        method="p2p",
    )


# ---------------------------------------------------------------------------
# Measured quantities (dense reference formulations)
# ---------------------------------------------------------------------------


def connection_components_dense(
    tb: RoutingTable, *, threshold: float = 0.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    t = tb.device_traffic
    n = tb.n_devices
    if tb.method == "p2p":
        direct = (t > threshold).sum(axis=1).astype(np.int64)
        zero = np.zeros(n, dtype=np.int64)
        return direct, zero, zero
    same = tb.group_of[:, None] == tb.group_of[None, :]
    direct = ((t > threshold) & same).sum(axis=1).astype(np.int64)
    forward = np.zeros(n, dtype=np.int64)
    aggregated = np.zeros(n, dtype=np.int64)
    gpt = group_pair_traffic_dense(tb)
    share = tb.share
    for d in range(n):
        gs = tb.group_of[d]
        # Connections to the bridges of the own group for every remote
        # group this device actually sends to — every bridge carrying a
        # share of a split flow, deduplicated by bridge device.
        remote_groups = np.unique(
            tb.group_of[np.nonzero((t[d] > threshold) & ~same[d])[0]]
        )
        bridges_used: set[int] = set()
        for gd in remote_groups:
            if share is not None:
                bs = np.nonzero((share[:, gd] > 0) & (tb.group_of == gs))[0]
            else:
                bs = [tb.bridge[gs, gd]]
            bridges_used.update(int(b) for b in bs if b != d)
        forward[d] = len(bridges_used)
        # Aggregated inter-group connections this device serves as bridge.
        if share is not None:
            aggregated[d] = int(((share[d] > 0) & (gpt[gs] > threshold)).sum())
        else:
            served = np.nonzero(tb.bridge[gs] == d)[0]
            aggregated[d] = sum(
                1 for gd in served if gd != gs and gpt[gs, gd] > threshold
            )
    return direct, forward, aggregated


def connection_counts_dense(tb: RoutingTable, *, threshold: float = 0.0) -> np.ndarray:
    direct, forward, aggregated = connection_components_dense(
        tb, threshold=threshold
    )
    return direct + forward + aggregated


def group_pair_traffic_dense(tb: RoutingTable) -> np.ndarray:
    g = tb.n_groups
    onehot = np.zeros((tb.n_devices, g))
    onehot[np.arange(tb.n_devices), tb.group_of] = 1.0
    out = onehot.T @ tb.device_traffic @ onehot
    np.fill_diagonal(out, 0.0)
    return out


def level2_egress_dense(tb: RoutingTable) -> np.ndarray:
    t = tb.device_traffic
    n = tb.n_devices
    if tb.method == "p2p":
        return t.sum(axis=1)
    gpt = group_pair_traffic_dense(tb)
    share = tb.share
    if share is not None:
        return (share * gpt[tb.group_of]).sum(axis=1)
    out = np.zeros(n)
    for gs in range(tb.n_groups):
        for gd in range(tb.n_groups):
            if gs == gd:
                continue
            out[tb.bridge[gs, gd]] += gpt[gs, gd]
    return out


def level1_egress_dense(tb: RoutingTable) -> np.ndarray:
    t = tb.device_traffic
    n = tb.n_devices
    if tb.method == "p2p":
        return np.zeros(n)
    same = tb.group_of[:, None] == tb.group_of[None, :]
    out = (t * same).sum(axis=1)
    # forwarding hops: each cross flow minus the sender's own bridge share
    share = tb.share
    if share is None:
        # primary bridge carries every flow whole
        share = np.zeros((n, tb.n_groups))
        for gs in range(tb.n_groups):
            for gd in range(tb.n_groups):
                if gs != gd and tb.bridge[gs, gd] >= 0:
                    share[tb.bridge[gs, gd], gd] = 1.0
    own = share[:, tb.group_of]  # own[u, v] = sender u's share toward grp(v)
    out += (t * ~same * (1.0 - own)).sum(axis=1)
    return out
