"""Algorithm 2 — the two-level routing method (paper §IV-B).

Clusters the ``N`` devices into ``G`` groups by applying the same
balance-constrained strategy as Algorithm 1 to the device-level traffic
graph (``PG[N,N]``, ``WG[N]``), then derives a routing table:

  * **Level-1**: devices in the same group exchange data through direct
    peer-to-peer connections.
  * **Level-2**: a device sending to another group forwards through a
    **bridge** device of its own group; the bridge aggregates every flow
    of its group destined to the target group into one logical transfer.

Outputs reproduce the paper's measured quantities:

  * per-device connection counts (Fig. 4 — paper: mean 1,552 → 88),
  * per-device level-2 egress traffic (Fig. 3(b)),
  * the routing table consumed by the distributed SNN engine and by the
    hierarchical collective schedules in :mod:`repro_torch.core.hierarchical`.

Bridge selection balances the aggregated inter-group traffic across the
members of each group (multiple bridges per group pair are allowed only
through distinct (src-group, dst-group) responsibilities), which is what
re-balances the level-2 traffic in Fig. 3(b).

Implementation note: this module is the **sparse, vectorized core** —
device traffic is carried as a CSR :class:`~repro_torch.core.traffic.TrafficMatrix`
and every measured quantity is computed with O(nnz) scatter/gather ops,
which scales Algorithm 2 past 10,000 devices on one CPU.  Dense ``[N, N]``
inputs are accepted everywhere and converted on entry.  The original dense
implementation survives as a parity oracle (N ≤ ~256) in
:mod:`repro_torch.core.routing_dense`; measurement functions transparently
dispatch to it when handed a table carrying a dense matrix.  This is a
numpy copy of ``repro.core.routing`` (the JAX package's) for the PyTorch
port.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CommGraph, build_graph
from repro_torch.core.traffic import TrafficMatrix, _ranges
from repro_torch.core import partition as part_mod
from repro_torch.obs import trace as obs

__all__ = [
    "RoutingTable",
    "device_graph",
    "device_traffic_csr",
    "two_level_routing",
    "p2p_routing",
    "connection_counts",
    "connection_components",
    "level2_egress",
    "level1_egress",
    "group_pair_traffic",
    "needed_sources",
    "payload_widths",
    "pool_block_mask",
    "select_bridges",
]


@dataclasses.dataclass(frozen=True)
class RoutingTable:
    """The paper's ``TB`` output of Algorithm 2.

    Attributes:
      group_of:      ``int64[N]`` device → group id.
      n_groups:      number of groups ``G``.
      bridge:        ``int64[G, G]`` — ``bridge[gs, gd]`` is the *primary*
                     device in group ``gs`` responsible for forwarding the
                     aggregated traffic from ``gs`` to group ``gd``
                     (diagonal = -1).  Empty ``[0, 0]`` for P2P tables.
      device_traffic: the device-to-device traffic the table was derived
                     from — a sparse :class:`TrafficMatrix` (the scalable
                     path) or a dense ``float64[N, N]`` (the parity oracle
                     of :mod:`repro_torch.core.routing_dense`).
      method:        provenance of the grouping ('greedy' | 'genetic' | ...).
      share_coo:     bridge load fractions as COO triplets
                     ``(device, dst_group, fraction)`` — ``fraction`` of
                     group(device)'s traffic toward ``dst_group`` carried
                     by ``device``.  ``None`` for P2P tables.
    """

    group_of: np.ndarray
    n_groups: int
    bridge: np.ndarray
    device_traffic: TrafficMatrix | np.ndarray
    method: str
    share_coo: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None

    @property
    def n_devices(self) -> int:
        return int(self.group_of.shape[0])

    @property
    def share(self) -> np.ndarray | None:
        """Dense ``float64[N, G]`` bridge load fractions (materialized on
        demand — prefer :attr:`share_coo` at scale)."""
        if self.share_coo is None:
            return None
        dev, grp, frac = self.share_coo
        out = np.zeros((self.n_devices, self.n_groups))
        out[dev, grp] = frac
        return out

    def members(self, g: int) -> np.ndarray:
        return np.nonzero(self.group_of == g)[0]

    def route(self, src: int, dst: int) -> list[int]:
        """Logical path for a (src, dst) flow.

        Same group → direct.  Cross group → src → bridge(src_grp, dst_grp)
        → bridge(dst_grp, src_grp) → dst; consecutive duplicates collapse
        (e.g. when src *is* the bridge).
        """
        gs, gd = int(self.group_of[src]), int(self.group_of[dst])
        if gs == gd or self.bridge.size == 0:
            return [src, dst]
        b_out = int(self.bridge[gs, gd])
        b_in = int(self.bridge[gd, gs])
        hops = [src, b_out, b_in, dst]
        path = [hops[0]]
        for h in hops[1:]:
            if h != path[-1]:
                path.append(h)
        return path

    def validate(self) -> None:
        # delegated to the planlint rule registry (rules PL005 + PL121)
        # so construction-time checks and `python -m repro_torch.analysis`
        # agree.  check_bridge_shares also covers P2P tables, which the
        # historical body skipped entirely (bridge.size == 0 returned
        # before any share_coo consistency check).
        from repro_torch.analysis import invariants

        invariants.check_routing_table(self)
        invariants.check_bridge_shares(self)


def _as_traffic(traffic: TrafficMatrix | np.ndarray) -> TrafficMatrix:
    if isinstance(traffic, TrafficMatrix):
        return traffic
    return TrafficMatrix.from_dense(np.asarray(traffic, dtype=np.float64))


def _is_dense(tb: RoutingTable) -> bool:
    return isinstance(tb.device_traffic, np.ndarray)


# ---------------------------------------------------------------------------
# Device-level traffic graph (the PG / WG inputs of Algorithm 2)
# ---------------------------------------------------------------------------


def _commgraph_is_symmetric(g: CommGraph) -> bool:
    """True when ``g`` stores both directions of every edge with equal
    traffic (``build_graph(..., sym=True)`` output)."""
    m = g.num_vertices
    rows = g.rows()
    et = g.edge_traffic()
    key = rows * m + g.indices
    tkey = g.indices * m + rows
    order, torder = np.argsort(key), np.argsort(tkey)
    return bool(
        np.array_equal(key[order], tkey[torder])
        and np.allclose(et[order], et[torder], rtol=1e-9)
    )


def device_traffic_csr(
    g: CommGraph, assign: np.ndarray, n_devices: int, *, sym_mode: str = "auto"
) -> tuple[TrafficMatrix, np.ndarray]:
    """Aggregate the neuron graph into a **sparse** device traffic matrix.

    The scalable counterpart of :func:`device_graph`: O(nnz) time and
    memory, no ``[N, N]`` intermediate — use this at N ≳ 1,000 devices.

    Returns ``(T, WG)`` where ``T`` is a symmetric
    :class:`~repro_torch.core.traffic.TrafficMatrix` of total traffic between
    device pairs and ``WG[a]`` is the total neuron weight on device ``a``.

    ``sym_mode`` says how the neuron CSR stores each flow:
      * ``'both'`` — both directions stored; symmetrization *averages*.
      * ``'once'`` — each flow stored once; directions must be *summed*
        (averaging would silently lose half of every one-directional
        flow — the historical bug).
      * ``'auto'`` — detect by inspecting the *neuron* graph's storage
        (device-level symmetry can coincide even for one-directional
        neuron graphs).  Costs an O(E log E) scan; pass the mode
        explicitly when the storage convention is known.
    """
    if sym_mode not in ("auto", "both", "once"):
        raise ValueError(f"unknown sym_mode {sym_mode!r}")
    rows = g.rows()
    et = g.edge_traffic()
    tm = TrafficMatrix.from_coo(assign[rows], assign[g.indices], et, n_devices)
    halve = (
        _commgraph_is_symmetric(g) if sym_mode == "auto" else sym_mode == "both"
    )
    tm = tm.symmetrized(halve=halve)
    wg = np.bincount(assign, weights=g.weights, minlength=n_devices)
    return tm, wg


def device_graph(
    g: CommGraph, assign: np.ndarray, n_devices: int, *, sym_mode: str = "auto"
) -> tuple[np.ndarray, np.ndarray]:
    """Aggregate the neuron graph into the **dense** device graph.

    Returns ``(T, WG)`` with ``T[a, b]`` the total traffic between devices
    ``a`` and ``b`` (symmetric, zero diagonal) — the paper's ``PG``
    weighted by the data volumes — and ``WG[a]`` the total neuron weight
    on device ``a``.  Materializes ``[N, N]``; kept for small N and as the
    input of the dense parity oracle.  Use :func:`device_traffic_csr` at
    scale.  Delegates to the sparse aggregation so both builders produce
    bit-identical values.
    """
    tm, wg = device_traffic_csr(g, assign, n_devices, sym_mode=sym_mode)
    return tm.to_dense(), wg


def _graph_from_traffic(tm: TrafficMatrix, wg: np.ndarray) -> CommGraph:
    """Wrap a device-traffic matrix as a CommGraph for Algorithm 1.

    Algorithm 1 consumes ``P`` and ``W`` with edge traffic ``P·W_i·W_j``;
    here the aggregate traffic ``T[a,b]`` is already the edge quantity, so
    we encode ``P[a,b] = T[a,b] / (W_a·W_b)`` normalized to [0, 1],
    preserving the *ordering* of affinities which is all the greedy uses.
    """
    src, dst, vals = tm.rows(), tm.indices, tm.data
    w = np.where(wg > 0, wg, 1.0)
    denom = w[src] * w[dst]
    probs = np.clip(vals / np.maximum(denom, 1e-30), 0.0, None)
    pscale = probs.max() if probs.size else 1.0
    probs = probs / max(pscale, 1e-30)
    return build_graph(src, dst, probs, w, sym=False)


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------


def _multilevel_grouper(dg, g, *, itermax, balance_slack, seed):
    # local import: multilevel pulls in the whole coarsening stack
    from repro_torch.core.multilevel import multilevel_partition

    return multilevel_partition(
        dg, g, itermax=itermax, balance_slack=balance_slack, seed=seed
    )


_GROUPERS = {
    "greedy": lambda dg, g, itermax, slack, seed: part_mod.greedy_partition(
        dg, g, itermax=itermax, balance_slack=slack, seed=seed
    ),
    "multilevel": lambda dg, g, itermax, slack, seed: _multilevel_grouper(
        dg, g, itermax=itermax, balance_slack=slack, seed=seed
    ),
    "genetic": lambda dg, g, itermax, slack, seed: part_mod.genetic_partition(
        dg, g, seed=seed
    ),
    "random": lambda dg, g, itermax, slack, seed: part_mod.random_partition(
        dg, g, seed=seed, balanced=True
    ),
}


def sweep_candidates(n: int) -> list[int]:
    """Deduplicated group-count candidates for the ``n_groups=None`` sweep.

    The paper sweeps G ∈ {N/64, N/32, N/16, N/8}; for small N these floor
    divisions collapse (and historically each collision was re-solved from
    scratch).  Candidates are clamped to ≥ 2, capped at N, and deduplicated
    preserving order so every G is solved exactly once.
    """
    out: list[int] = []
    for d in (64, 32, 16, 8):
        g = max(2, n // d)
        if g <= n and g not in out:
            out.append(g)
    return out


def two_level_routing(
    traffic: TrafficMatrix | np.ndarray,
    wg: np.ndarray,
    n_groups: int | None = None,
    *,
    itermax: int = 8,
    balance_slack: float = 0.05,
    seed: int = 0,
    grouping: str = "greedy",
) -> RoutingTable:
    """The paper's Algorithm 2 (sparse, vectorized core).

    Args:
      traffic: symmetric device-to-device traffic — a
        :class:`TrafficMatrix` from :func:`device_traffic_csr` (scalable)
        or a dense ``float64[N, N]`` (converted on entry).
      wg: ``float64[N]`` per-device aggregated neuron weight.
      n_groups: number of groups ``G``.  ``None`` sweeps the deduplicated
        candidate set (:func:`sweep_candidates`) over a *shared* device
        graph and keeps the G minimizing the peak level-2 (bridge) egress —
        the paper's "update the best optimal solution" outer loop.
      itermax: the paper's ``T`` — refinement sweeps in the grouping
        step.
      balance_slack: group-weight balance cap the grouping honors
        (``max group weight <= (1 + slack) * mean``).
      seed: grouping RNG seed; the routing itself is deterministic.
      grouping: 'greedy' (Algorithm 2 proper), 'multilevel' (the
        multilevel partitioner on the device graph), or 'genetic' /
        'random' (the baselines of Fig. 3(b)).

    Returns:
      :class:`RoutingTable` (the paper's ``TB``).
    """
    tm = _as_traffic(traffic)
    wg = np.asarray(wg, dtype=np.float64)
    n = tm.n_devices
    if wg.shape != (n,):
        raise ValueError("wg must have one weight per device")
    if grouping not in _GROUPERS:
        raise ValueError(f"unknown grouping {grouping!r}")
    if n_groups is None:
        cands = sweep_candidates(n)
        if not cands:
            raise ValueError("too few devices for grouping")
        dg = _graph_from_traffic(tm, wg)  # built once, shared by the sweep
        best, best_peak = None, np.inf
        with obs.span("plan.alg2.sweep_G", cat="plan", tid="route",
                      args={"candidates": len(cands)}) as sp:
            for g in cands:
                tb = _route(tm, wg, g, dg, itermax, balance_slack, seed, grouping)
                peak = float(level2_egress(tb).max())
                if peak < best_peak:
                    best, best_peak = tb, peak
            sp.set(best_G=best.n_groups, peak_l2=best_peak)
        return best
    if n_groups <= 0 or n_groups > n:
        raise ValueError("need 1 <= n_groups <= n_devices")
    dg = _graph_from_traffic(tm, wg)
    return _route(tm, wg, n_groups, dg, itermax, balance_slack, seed, grouping)


def _route(
    tm: TrafficMatrix,
    wg: np.ndarray,
    n_groups: int,
    dg: CommGraph,
    itermax: int,
    balance_slack: float,
    seed: int,
    grouping: str,
) -> RoutingTable:
    with obs.span("plan.alg2.grouping", cat="plan", tid="route",
                  args={"G": n_groups, "method": grouping}):
        res = _GROUPERS[grouping](dg, n_groups, itermax, balance_slack, seed)
    group_of = res.assign
    with obs.span("plan.alg2.select_bridges", cat="plan", tid="route",
                  args={"G": n_groups}):
        bridge, share_coo = select_bridges(tm, group_of, n_groups)
    tb = RoutingTable(
        group_of=group_of,
        n_groups=n_groups,
        bridge=bridge,
        device_traffic=tm,
        method=grouping,
        share_coo=share_coo,
    )
    with obs.span("plan.alg2.validate", cat="plan", tid="route"):
        tb.validate()
    return tb


def select_bridges(
    tm: TrafficMatrix,
    group_of: np.ndarray,
    n_groups: int,
    *,
    only_groups: np.ndarray | None = None,
    base: tuple[np.ndarray, tuple[np.ndarray, np.ndarray, np.ndarray]] | None = None,
    exclude: np.ndarray | None = None,
) -> tuple[np.ndarray, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Assign bridge responsibilities for every ordered group pair.

    Greedy LPT load balancing: group pairs are visited in decreasing
    order of aggregated traffic and assigned to the least-loaded member;
    a pair whose flow alone exceeds the group's balanced target is SPLIT
    across multiple bridges ("Select GPUs to connect other groups" —
    Alg. 2 line 8 is plural), which is what flattens the Fig. 3(b) peak.

    All pairwise aggregates come from O(nnz) scatters; the only remaining
    loop is the inherently sequential per-group LPT over its *nonzero*
    destination groups.  Returns ``(primary_bridge [G, G], share_coo)``.

    Restricted re-election (the delta-replan path,
    :mod:`repro_torch.core.replan`): with ``only_groups`` set, only those
    source groups rerun their LPT; every other group's bridge row and
    share entries are carried over verbatim from ``base`` (a prior
    ``(bridge, share_coo)`` pair), which is sound because a group's
    election depends only on its own membership and its own outgoing
    flows.  ``exclude`` (``bool[N]``) bars devices — e.g. dead ones —
    from bridge duty in the re-elected groups.
    """
    n = tm.n_devices
    g = n_groups
    rows, cols, vals = tm.rows(), tm.indices, tm.data
    gdst = group_of[cols]
    # [N, G] device → destination-group traffic (tie-break for LPT picks)
    dev_to_grp = np.bincount(
        rows * g + gdst, weights=vals, minlength=n * g
    ).reshape(n, g)
    grp_pair = np.bincount(
        group_of[rows] * g + gdst, weights=vals, minlength=g * g
    ).reshape(g, g)
    np.fill_diagonal(grp_pair, 0.0)

    member_order = np.argsort(group_of, kind="stable")
    member_start = np.searchsorted(group_of[member_order], np.arange(g + 1))

    if only_groups is None:
        elect = range(g)
        bridge = np.full((g, g), -1, dtype=np.int64)
        sh_dev: list[np.ndarray] = []
        sh_grp: list[np.ndarray] = []
        sh_frac: list[np.ndarray] = []
    else:
        if base is None:
            raise ValueError("only_groups needs base=(bridge, share_coo)")
        only_groups = np.unique(np.asarray(only_groups, dtype=np.int64))
        if only_groups.size and (
            only_groups.min() < 0 or only_groups.max() >= g
        ):
            raise ValueError("only_groups out of range")
        elect = only_groups.tolist()
        base_bridge, base_share = base
        bridge = np.array(base_bridge, dtype=np.int64, copy=True)
        bridge[only_groups] = -1
        # keep share entries of groups NOT being re-elected; a carried
        # device's source group is unchanged (membership changes force
        # re-election of both old and new group — replan guarantees it)
        b_dev, b_grp, b_frac = base_share
        keep = ~np.isin(group_of[b_dev], only_groups) if b_dev.size else np.zeros(0, bool)
        sh_dev = [b_dev[keep]]
        sh_grp = [b_grp[keep]]
        sh_frac = [b_frac[keep]]
    for gs in elect:
        members = member_order[member_start[gs] : member_start[gs + 1]]
        if exclude is not None and members.size:
            members = members[~np.asarray(exclude, dtype=bool)[members]]
        if members.size == 0:
            continue
        flows = grp_pair[gs].copy()
        flows[gs] = 0.0
        total = flows.sum()
        target = total / max(len(members), 1)
        bridge[gs] = members[0]
        bridge[gs, gs] = -1
        loads = np.zeros(members.size)
        d2g = dev_to_grp[members]  # [m, G] slice, m = |group gs|
        order = np.argsort(-flows, kind="stable")
        for gd in order[flows[order] > 0]:
            f = flows[gd]
            k = int(min(len(members), max(1, np.ceil(f / max(target, 1e-30)))))
            key = loads - 1e-12 * d2g[:, gd]
            picks = np.argsort(key, kind="stable")[:k]
            bridge[gs, gd] = members[picks[0]]
            sh_dev.append(members[picks])
            sh_grp.append(np.full(k, gd, dtype=np.int64))
            sh_frac.append(np.full(k, 1.0 / k))
            loads[picks] += f / k
    if sh_dev:
        share_coo = (
            np.concatenate(sh_dev),
            np.concatenate(sh_grp),
            np.concatenate(sh_frac),
        )
    else:
        share_coo = (
            np.empty(0, np.int64),
            np.empty(0, np.int64),
            np.empty(0, np.float64),
        )
    return bridge, share_coo


#: Back-compat alias (pre-replan name; tests import it).
_select_bridges = select_bridges


def needed_sources(tb: RoutingTable) -> np.ndarray:
    """``bool[N, N]`` — ``[src, dst]`` True when device ``dst`` consumes
    device ``src``'s spikes according to the table's traffic.

    The routing-table counterpart of nonzero incoming-weight columns: the
    device traffic aggregates every synapse, so any (src → dst) synapse
    implies a stored traffic entry and the mask is a safe superset of the
    realized block structure.  The distributed engine's ``'sparse'``
    exchange schedules its cross-group ``ppermute`` rounds from this (see
    :func:`repro_torch.snn.sparse.exchange_schedule`).
    """
    if _is_dense(tb):
        mask = np.asarray(tb.device_traffic) > 0
        out = mask.copy()
        np.fill_diagonal(out, True)
        return out
    return tb.device_traffic.consumer_mask()


def payload_widths(tb: RoutingTable, block_size: int) -> np.ndarray:
    """``int64[N, N]`` per-pair spike-payload widths implied by the table.

    The width counterpart of :func:`needed_sources`: every consumed pair
    carries the full ``block_size`` lanes, because device-level traffic
    cannot resolve *which* columns a destination consumes — a safe
    superset.  The ragged exchange planner
    (:func:`repro_torch.snn.ragged.build_ragged_plan`) prunes below these
    widths when the realized synapse tiles are available.
    """
    if _is_dense(tb):
        return needed_sources(tb).astype(np.int64) * int(block_size)
    return tb.device_traffic.payload_widths(block_size)


def pool_block_mask(
    mask: np.ndarray, group_of: np.ndarray, n_groups: int
) -> np.ndarray:
    """OR-aggregate a device-level block mask to group granularity.

    ``out[gs, gd]`` is True when *any* device of group ``gd`` consumes a
    block of any device in group ``gs`` — the level-2 exchange moves
    group-aggregated blocks, so one consumer anywhere in the group forces
    the whole transfer.  The diagonal is always True (level-1 territory).
    """
    src, dst = np.nonzero(np.asarray(mask, dtype=bool))
    out = np.zeros((n_groups, n_groups), dtype=bool)
    out[group_of[src], group_of[dst]] = True
    np.fill_diagonal(out, True)
    return out


def p2p_routing(
    traffic: TrafficMatrix | np.ndarray, wg: np.ndarray
) -> RoutingTable:
    """Direct peer-to-peer baseline: every device is its own group.

    The bridge matrix is left empty (a dense ``[N, N]`` of -1 at
    N = 10,000 would be 800 MB of nothing)."""
    tm = _as_traffic(traffic)
    n = tm.n_devices
    return RoutingTable(
        group_of=np.arange(n, dtype=np.int64),
        n_groups=n,
        bridge=np.empty((0, 0), dtype=np.int64),
        device_traffic=tm,
        method="p2p",
    )


# ---------------------------------------------------------------------------
# Measured quantities (paper Figs. 3(b), 4)
# ---------------------------------------------------------------------------


def _share_coo_or_primary(
    tb: RoutingTable,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The table's bridge shares, falling back to the primary bridges
    carrying every flow whole (``share_coo=None`` on a hand-built grouped
    table) — mirrors the dense oracle's share-less branches."""
    if tb.share_coo is not None:
        return tb.share_coo
    g = tb.n_groups
    offdiag = ~np.eye(g, dtype=bool)
    gd_idx = np.broadcast_to(np.arange(g)[None, :], (g, g))[offdiag]
    b = tb.bridge[offdiag]
    valid = b >= 0
    return b[valid], gd_idx[valid], np.ones(int(valid.sum()))


def connection_components(
    tb: RoutingTable, *, threshold: float = 0.0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-device connection counts split by role: ``(direct, forward,
    aggregated)``.

    * ``direct``  — level-1 connections to same-group peers with traffic
      (for P2P: to *every* destination with traffic).
    * ``forward`` — level-1 connections from a device to each distinct
      bridge of its own group it forwards cross-group flows through.
      When a group-pair flow is split across multiple bridges the device
      connects to **every** bridge carrying a share (historically only the
      primary ``bridge[gs, gd]`` was counted — an undercount).
    * ``aggregated`` — the level-2 connections a device serves as bridge:
      one per (served destination group with traffic above threshold).

    ``connection_counts`` is the sum; :mod:`repro_torch.core.hierarchical` uses
    the split for measured level-1/level-2 message accounting.
    """
    if _is_dense(tb):
        from repro_torch.core import routing_dense

        return routing_dense.connection_components_dense(tb, threshold=threshold)
    tm: TrafficMatrix = tb.device_traffic
    n = tb.n_devices
    rows, cols, vals = tm.rows(), tm.indices, tm.data
    act = vals > threshold
    if tb.method == "p2p":
        direct = np.bincount(rows[act], minlength=n).astype(np.int64)
        zero = np.zeros(n, dtype=np.int64)
        return direct, zero, zero
    g = tb.n_groups
    gsrc = tb.group_of[rows]
    gdst = tb.group_of[cols]
    same = gsrc == gdst
    direct = np.bincount(rows[act & same], minlength=n).astype(np.int64)

    sdev, sgrp, _ = _share_coo_or_primary(tb)
    # --- forward connections: distinct bridges each device sends through.
    # Unique (src device, dst group) pairs with cross traffic …
    cross = act & ~same
    ukey = np.unique(rows[cross] * g + gdst[cross])
    d_u = ukey // g
    gd_u = ukey % g
    # … expanded to the full bridge set of (group(src), dst group) …
    pair_key = tb.group_of[sdev] * g + sgrp
    order = np.argsort(pair_key, kind="stable")
    pair_sorted = pair_key[order]
    bdev_sorted = sdev[order]
    want = tb.group_of[d_u] * g + gd_u
    lo = np.searchsorted(pair_sorted, want, side="left")
    hi = np.searchsorted(pair_sorted, want, side="right")
    b_rep = bdev_sorted[_ranges(lo, hi)]
    d_rep = np.repeat(d_u, hi - lo)
    # … deduplicated by bridge device, excluding the device itself.
    keep = b_rep != d_rep
    uniq_db = np.unique(d_rep[keep] * n + b_rep[keep])
    forward = np.bincount(uniq_db // n, minlength=n).astype(np.int64)

    # --- aggregated connections served as bridge.
    gpt = group_pair_traffic(tb)
    served = gpt[tb.group_of[sdev], sgrp] > threshold
    aggregated = np.bincount(sdev[served], minlength=n).astype(np.int64)
    return direct, forward, aggregated


def connection_counts(tb: RoutingTable, *, threshold: float = 0.0) -> np.ndarray:
    """Number of logical connections departing each device (Fig. 4).

    P2P: one connection per destination device with traffic > threshold.
    Two-level: direct connections to same-group peers with traffic, plus
    one connection from each device to each distinct bridge it forwards
    through (every bridge of a split flow, not just the primary), plus —
    for bridges — one aggregated connection per remote group they serve.
    """
    direct, forward, aggregated = connection_components(tb, threshold=threshold)
    return direct + forward + aggregated


def group_pair_traffic(tb: RoutingTable) -> np.ndarray:
    """Aggregated traffic between group pairs ``[G, G]`` (zero diagonal).

    Materializes ``[G, G]`` — meant for grouped tables (G ≪ N), not for
    the P2P table where G = N."""
    if _is_dense(tb):
        from repro_torch.core import routing_dense

        return routing_dense.group_pair_traffic_dense(tb)
    tm: TrafficMatrix = tb.device_traffic
    g = tb.n_groups
    out = np.bincount(
        tb.group_of[tm.rows()] * g + tb.group_of[tm.indices],
        weights=tm.data,
        minlength=g * g,
    ).reshape(g, g)
    np.fill_diagonal(out, 0.0)
    return out


def level2_egress(tb: RoutingTable) -> np.ndarray:
    """Per-device level-2 egress traffic (Fig. 3(b)).

    For P2P this is *all* egress (every flow is 'level-2' in the sense of
    leaving the device individually).  For two-level routing, a device's
    level-2 egress is the aggregated inter-group traffic it carries as a
    bridge; non-bridge devices hand their cross-group flows to a bridge
    over level-1 links, so their level-2 egress is zero.
    """
    if _is_dense(tb):
        from repro_torch.core import routing_dense

        return routing_dense.level2_egress_dense(tb)
    tm: TrafficMatrix = tb.device_traffic
    n = tb.n_devices
    if tb.method == "p2p":
        return tm.row_sums()
    gpt = group_pair_traffic(tb)
    sdev, sgrp, sfrac = _share_coo_or_primary(tb)
    return np.bincount(
        sdev, weights=sfrac * gpt[tb.group_of[sdev], sgrp], minlength=n
    )


def level1_egress(tb: RoutingTable) -> np.ndarray:
    """Per-device level-1 (intra-group + to-bridge) egress traffic.

    A cross-group flow is forwarded to the bridges of the sender's group
    in proportion to their ``share`` of the (gs, gd) aggregate; the
    sender's own share (when it is itself one of those bridges) stays
    local — consistent with how :func:`level2_egress` splits the
    aggregate across the same bridges.
    """
    if _is_dense(tb):
        from repro_torch.core import routing_dense

        return routing_dense.level1_egress_dense(tb)
    tm: TrafficMatrix = tb.device_traffic
    n = tb.n_devices
    if tb.method == "p2p":
        return np.zeros(n)
    g = tb.n_groups
    rows, cols, vals = tm.rows(), tm.indices, tm.data
    gsrc = tb.group_of[rows]
    gdst = tb.group_of[cols]
    same = gsrc == gdst
    out = np.bincount(rows[same], weights=vals[same], minlength=n)
    # forwarding hops: each cross flow minus the sender's own bridge share
    cross = ~same
    sdev, sgrp, sfrac = _share_coo_or_primary(tb)
    share_key = sdev * g + sgrp  # unique: a device bridges a group once
    order = np.argsort(share_key, kind="stable")
    share_key, share_frac = share_key[order], sfrac[order]
    edge_key = rows[cross] * g + gdst[cross]
    pos = np.searchsorted(share_key, edge_key)
    pos = np.minimum(pos, max(share_key.size - 1, 0))
    own = np.where(
        share_key.size and share_key[pos] == edge_key, share_frac[pos], 0.0
    )
    out += np.bincount(
        rows[cross], weights=vals[cross] * (1.0 - own), minlength=n
    )
    return out
