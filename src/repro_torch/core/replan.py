"""Incremental replan under a changing traffic graph (delta-replan).

The paper's pipeline (partition → two-level route → exchange plan)
assumes a static connectome, but a running brain simulation mutates its
device-level traffic: synapse growth/pruning shifts volumes, structural
plasticity rewires pairs, and a device failure is a forced repartition.
Rebuilding the global structures from scratch on every change costs a
full Algorithm-1 + Algorithm-2 solve; this module confines the work to
the neighborhood the change actually touched:

1. **Delta edit** — :meth:`repro_torch.core.traffic.TrafficMatrix.apply_delta`
   merges COO edit triplets into the stored CSR without re-aggregating
   the neuron graph.
2. **Bounded-region regroup** — only the groups containing a delta
   endpoint (or a dead device) re-run the partition refinement sweeps
   (:func:`repro_torch.core.partition.refine_sweep_csr_seq` +
   :func:`~repro_torch.core.partition.swap_sweep_csr_seq`) on the induced
   device subgraph.  Moves confined to that region optimize the *exact*
   global cut: an edge from a region device to an outside device keeps
   both endpoints' group relationship fixed under within-region moves,
   because the outside group is never a move target.
3. **Restricted bridge re-election** — only source groups whose
   membership or outgoing pair-traffic row changed (plus groups holding
   a dead device) re-run the LPT in
   :func:`repro_torch.core.routing.select_bridges`; every other group's bridge
   row and share entries carry over verbatim, which is sound because a
   group's election depends only on its own members and outgoing flows.

Fault tolerance rides the same path: :func:`evacuate_device` turns a
dead device into a delta (all its flows re-keyed onto a surviving host
in its group), so the supervisor's failure handler is
``evacuate → replan → plan swap`` (see
:class:`repro_torch.snn.distributed.PlanBuffer` and
:class:`repro_torch.train.fault_tolerance.Supervisor`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import partition as part_mod
from repro_torch.core.routing import RoutingTable, select_bridges
from repro_torch.core.traffic import TrafficMatrix
from repro_torch.obs import trace as obs

__all__ = [
    "ReplanResult",
    "Evacuation",
    "symmetric_delta",
    "local_regroup",
    "replan",
    "evacuate_device",
    "evacuate_devices",
    "rejoin_devices",
]


def symmetric_delta(
    src: np.ndarray, dst: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mirror edit triplets so a symmetric matrix stays symmetric.

    The routing pipeline stores both directions of every flow
    (:meth:`TrafficMatrix.symmetrized`); an edit expressed once per pair
    must land on both — this helper appends the transposed triplets.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    return (
        np.concatenate([src, dst]),
        np.concatenate([dst, src]),
        np.concatenate([vals, vals]),
    )


@dataclasses.dataclass(frozen=True)
class ReplanResult:
    """Outcome of an incremental :func:`replan`.

    Attributes:
      table: the updated, validated :class:`RoutingTable`.
      wg: per-device weights after evacuation edits (unchanged copy of
          the input when ``dead`` was empty).
      touched_groups: groups whose devices were allowed to move.
      reelected_groups: source groups whose bridge rows were re-run.
      moved_devices: regroup moves applied inside the region.
    """

    table: RoutingTable
    wg: np.ndarray
    touched_groups: np.ndarray
    reelected_groups: np.ndarray
    moved_devices: int


def local_regroup(
    tm: TrafficMatrix,
    wg: np.ndarray,
    group_of: np.ndarray,
    region_groups: np.ndarray,
    n_groups: int,
    *,
    balance_slack: float = 0.05,
    sweeps: int = 2,
) -> tuple[np.ndarray, int]:
    """Refine the grouping inside ``region_groups`` only.

    Extracts the induced device subgraph of the region, relabels its
    groups to local part ids, and runs the exact sequential sweeps with
    the *global* balance cap, so region parts stay exchangeable with the
    untouched remainder.  Returns ``(group_of_new, moves)``; falls back
    to the input assignment if a sweep would empty a group (bridges need
    every group inhabited).
    """
    group_of = np.asarray(group_of, dtype=np.int64).copy()
    region_groups = np.unique(np.asarray(region_groups, dtype=np.int64))
    if region_groups.size < 2:
        return group_of, 0
    in_region = np.isin(group_of, region_groups)
    dev_ids = np.flatnonzero(in_region)
    local_id = np.full(group_of.shape[0], -1, dtype=np.int64)
    local_id[dev_ids] = np.arange(dev_ids.size)
    rows, cols, vals = tm.rows(), tm.indices, tm.data
    m = in_region[rows] & in_region[cols]
    src_l, dst_l, et_l = local_id[rows[m]], local_id[cols[m]], vals[m]
    # tm's sorted CSR order survives masking + the monotone relabel, so
    # the sweeps' sorted-rows requirement holds
    counts = np.bincount(src_l, minlength=dev_ids.size)
    indptr = np.zeros(dev_ids.size + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    assign_l = np.searchsorted(region_groups, group_of[dev_ids])
    wg = np.asarray(wg, dtype=np.float64)
    w_l = wg[dev_ids]
    k = region_groups.size
    cap = wg.sum() / n_groups * (1.0 + balance_slack)
    moves = 0
    for _ in range(max(1, sweeps)):
        mv = part_mod.refine_sweep_csr_seq(indptr, dst_l, et_l, w_l, assign_l, k, cap)
        mv += part_mod.swap_sweep_csr_seq(indptr, dst_l, et_l, w_l, assign_l, k, cap)
        moves += mv
        if mv == 0:
            break
    if np.bincount(assign_l, minlength=k).min() == 0:
        return np.asarray(group_of, dtype=np.int64), 0
    group_of[dev_ids] = region_groups[assign_l]
    return group_of, moves


def _pair_traffic(tm: TrafficMatrix, group_of: np.ndarray, g: int) -> np.ndarray:
    """``[G, G]`` aggregated pair traffic, zero diagonal.

    Unchanged pairs aggregate the same stored entries in the same scan
    order as before an edit, so their sums are bit-identical — exact
    ``!=`` comparison is the change detector, no tolerance needed.
    """
    out = np.bincount(
        group_of[tm.rows()] * g + group_of[tm.indices],
        weights=tm.data,
        minlength=g * g,
    ).reshape(g, g)
    np.fill_diagonal(out, 0.0)
    return out


def replan(
    tb: RoutingTable,
    wg: np.ndarray,
    delta: tuple[np.ndarray, np.ndarray, np.ndarray],
    *,
    dead: np.ndarray | None = None,
    balance_slack: float = 0.05,
    sweeps: int = 2,
) -> ReplanResult:
    """Incrementally update a two-level routing table for a traffic delta.

    Args:
      tb: the current grouped table (sparse path — its
        ``device_traffic`` must be a :class:`TrafficMatrix`).
      wg: ``float64[N]`` per-device weights the grouping balances.
      delta: COO edit triplets ``(src, dst, dvals)`` — use
        :func:`symmetric_delta` to keep the stored matrix symmetric, or
        the output of :func:`evacuate_device` for a failure.
      dead: optional device ids barred from bridge duty (failed
        hardware); their groups always re-elect.
      balance_slack: global group-weight cap the bounded-region regroup
        enforces (same meaning as in
        :func:`~repro_torch.core.routing.two_level_routing`).
      sweeps: refinement sweeps over the touched region — bounded work,
        so replan cost scales with the delta, not the table.

    Returns:
      :class:`ReplanResult` with a validated table equivalent to what a
      from-scratch rebuild would produce on the edited matrix, at the
      cost of touching only the affected neighborhood.
    """
    if not isinstance(tb.device_traffic, TrafficMatrix):
        raise ValueError("replan needs the sparse TrafficMatrix path")
    src, dst, dvals = delta
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    dvals = np.asarray(dvals, dtype=np.float64)
    with obs.span("replan.apply_delta", cat="plan", tid="replan",
                  args={"nnz": int(dvals.size)}):
        tm_new = tb.device_traffic.apply_delta(src, dst, dvals)
    dead_idx = (
        np.unique(np.asarray(dead, dtype=np.int64).ravel())
        if dead is not None
        else np.empty(0, dtype=np.int64)
    )
    hot = dvals != 0
    touched_dev = np.unique(np.concatenate([src[hot], dst[hot], dead_idx]))
    return _replan_core(
        tb,
        wg,
        tm_new,
        touched_dev,
        dead_idx,
        balance_slack=balance_slack,
        sweeps=sweeps,
    )


def _replan_core(
    tb: RoutingTable,
    wg: np.ndarray,
    tm_new: TrafficMatrix,
    touched_dev: np.ndarray,
    dead_idx: np.ndarray,
    *,
    balance_slack: float,
    sweeps: int,
) -> ReplanResult:
    """Shared tail of :func:`replan` / :func:`rejoin_devices`: bounded
    regroup + restricted re-election on an already-edited matrix."""
    if tb.bridge.size == 0:
        raise ValueError("replan needs a grouped two-level table (not p2p)")
    tm_old: TrafficMatrix = tb.device_traffic
    n, g = tb.n_devices, tb.n_groups
    wg = np.asarray(wg, dtype=np.float64)
    dead_mask = np.zeros(n, dtype=bool)
    dead_mask[dead_idx] = True

    # 1. bounded-region regroup: only groups holding a delta endpoint or
    # a dead device may move devices
    region = (
        np.unique(tb.group_of[touched_dev])
        if touched_dev.size
        else np.empty(0, dtype=np.int64)
    )
    with obs.span("replan.local_regroup", cat="plan", tid="replan",
                  args={"region_groups": int(region.size)}) as sp:
        group_of_new, moves = local_regroup(
            tm_new,
            wg,
            tb.group_of,
            region,
            g,
            balance_slack=balance_slack,
            sweeps=sweeps,
        )
        sp.set(moved=int(moves))

    # 2. restricted re-election: groups whose outgoing pair-traffic row
    # changed, whose membership changed, or which hold a dead device
    gp_old = _pair_traffic(tm_old, tb.group_of, g)
    gp_new = _pair_traffic(tm_new, group_of_new, g)
    rows_changed = np.flatnonzero(np.any(gp_new != gp_old, axis=1))
    ch = np.flatnonzero(group_of_new != tb.group_of)
    mem_changed = np.unique(
        np.concatenate([tb.group_of[ch], group_of_new[ch]])
    )
    only = np.unique(
        np.concatenate(
            [rows_changed, mem_changed, group_of_new[dead_idx]]
        ).astype(np.int64)
    )
    with obs.span("replan.reelect_bridges", cat="plan", tid="replan",
                  args={"groups": int(only.size)}):
        bridge, share_coo = select_bridges(
            tm_new,
            group_of_new,
            g,
            only_groups=only,
            base=(tb.bridge, tb.share_coo),
            exclude=dead_mask if dead_idx.size else None,
        )
    tb_new = RoutingTable(
        group_of=group_of_new,
        n_groups=g,
        bridge=bridge,
        device_traffic=tm_new,
        method=tb.method,
        share_coo=share_coo,
    )
    tb_new.validate()
    return ReplanResult(
        table=tb_new,
        wg=wg.copy(),
        touched_groups=region,
        reelected_groups=only,
        moved_devices=moves,
    )


def _rekey_triplets(
    tm: TrafficMatrix, dead: int, host: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Delta triplets that move every stored flow of ``dead`` onto
    ``host``: each entry is removed exactly (negating its stored
    volume) and re-added keyed to the host."""
    rows, cols, vals = tm.rows(), tm.indices, tm.data
    out_m = rows == dead
    in_m = cols == dead
    n_out, n_in = int(out_m.sum()), int(in_m.sum())
    d_src = np.concatenate(
        [rows[out_m], np.full(n_out, host, np.int64), rows[in_m], rows[in_m]]
    )
    d_dst = np.concatenate(
        [cols[out_m], cols[out_m], cols[in_m], np.full(n_in, host, np.int64)]
    )
    d_val = np.concatenate(
        [-vals[out_m], vals[out_m], -vals[in_m], vals[in_m]]
    )
    return d_src, d_dst, d_val


def evacuate_device(
    tb: RoutingTable,
    wg: np.ndarray,
    dead: int,
    *,
    host: int | None = None,
) -> tuple[tuple[np.ndarray, np.ndarray, np.ndarray], np.ndarray, int]:
    """Turn a dead device into a forced traffic delta.

    Every stored flow touching ``dead`` is re-keyed onto ``host`` (by
    default the least-loaded surviving member of the dead device's
    group) and the dead device's neuron weight moves with it; flows
    between ``dead`` and ``host`` become host-internal and vanish (the
    delta's self-loops are dropped by ``apply_delta``).

    Returns ``(delta, wg_new, host)`` — feed the delta plus
    ``dead=[dead]`` to :func:`replan`.  For several simultaneous
    failures (or an invertible record) use :func:`evacuate_devices`.
    """
    ev = evacuate_devices(tb, wg, [dead], hosts=None if host is None else [host])
    return ev.delta, ev.wg_after.copy(), int(ev.hosts[0])


@dataclasses.dataclass(frozen=True)
class Evacuation:
    """A recorded (and therefore invertible) batch evacuation.

    Attributes:
      delta: concatenated COO edit triplets ``(src, dst, dvals)`` for
        the whole batch — ``apply_delta`` is additive, so applying the
        concatenation to the pre-failure matrix equals applying each
        device's re-key sequentially.
      dead: ``int64[k]`` evacuated devices, in evacuation order.
      hosts: ``int64[k]`` surviving host chosen for each dead device.
      wg_before / wg_after: per-device weights around the evacuation —
        ``wg_before`` is what :func:`rejoin_devices` restores.
      orig: the pre-failure stored triplets of every entry the batch
        touched — the snapshot :meth:`inverse_delta` restores them
        from (a float sum-then-subtract round-trip is not bit-exact,
        so the inverse re-writes originals instead of negating sums).
      n_devices: matrix dimension (key encoding for the inverse).
    """

    delta: tuple[np.ndarray, np.ndarray, np.ndarray]
    dead: np.ndarray
    hosts: np.ndarray
    wg_before: np.ndarray
    wg_after: np.ndarray
    orig: tuple[np.ndarray, np.ndarray, np.ndarray]
    n_devices: int

    def restore_matrix(self, tm_now: TrafficMatrix) -> TrafficMatrix:
        """Restore every touched entry to its pre-failure value,
        bit-exactly, in two delta passes: first the touched keys'
        current values are removed by exact negation (a two-term
        ``x + (−x)`` cancels in any summation order), then the recorded
        originals are re-added onto the now-empty keys (single-term
        sums, again exact) — a one-pass ``x − x + orig`` merge would be
        at the mercy of the reducer's association.  Entries outside the
        touched key set are never edited, so the restoration is exact as
        long as they were left alone in between (edit the same pairs
        again and the snapshot is stale — rejoin first, or rebuild).
        """
        n = self.n_devices
        ds, dd, _ = self.delta
        keys = np.unique(ds * n + dd)
        rows, cols, vals = tm_now.rows(), tm_now.indices, tm_now.data
        hit = np.isin(rows * n + cols, keys)
        cleared = tm_now.apply_delta(rows[hit], cols[hit], -vals[hit])
        return cleared.apply_delta(*self.orig)


def evacuate_devices(
    tb: RoutingTable,
    wg: np.ndarray,
    dead,
    *,
    hosts=None,
) -> Evacuation:
    """Evacuate several dead devices in one recorded batch.

    Devices are processed in the given order against a *running* copy of
    the traffic matrix, so a later evacuation sees flows the earlier
    ones re-keyed (two dead devices that talked to each other end up as
    a single host↔host flow, not a dangling edge).  Hosts are chosen as
    the least-loaded surviving member of each dead device's group,
    never another dead device.  Feed ``.delta`` plus ``dead=ev.dead``
    to :func:`replan`; keep the :class:`Evacuation` to
    :func:`rejoin_devices` later.
    """
    if not isinstance(tb.device_traffic, TrafficMatrix):
        raise ValueError("evacuate_devices needs the sparse TrafficMatrix path")
    dead = np.asarray(list(dead), dtype=np.int64).ravel()
    if dead.size == 0:
        raise ValueError("no devices to evacuate")
    if np.unique(dead).size != dead.size:
        raise ValueError("duplicate device in the evacuation batch")
    if hosts is not None:
        hosts = np.asarray(list(hosts), dtype=np.int64).ravel()
        if hosts.shape != dead.shape:
            raise ValueError("hosts must pair 1:1 with dead devices")
    wg = np.asarray(wg, dtype=np.float64)
    dead_set = set(int(d) for d in dead)
    tm0: TrafficMatrix = tb.device_traffic
    tm = tm0
    wg_cur = wg.copy()
    host_out = np.empty(dead.size, dtype=np.int64)
    parts_s: list[np.ndarray] = []
    parts_d: list[np.ndarray] = []
    parts_v: list[np.ndarray] = []
    for i, d in enumerate(int(x) for x in dead):
        if hosts is None:
            members = tb.members(int(tb.group_of[d]))
            members = members[
                [m not in dead_set for m in members.tolist()]
            ]
            if members.size == 0:
                raise ValueError(
                    f"group {int(tb.group_of[d])} has no surviving member "
                    f"to host device {d}'s load"
                )
            host = int(members[np.argmin(wg_cur[members])])
        else:
            host = int(hosts[i])
            if host == d:
                raise ValueError("host must differ from the dead device")
            if host in dead_set:
                raise ValueError(f"host {host} is itself being evacuated")
        if host == d:
            raise ValueError("host must differ from the dead device")
        d_src, d_dst, d_val = _rekey_triplets(tm, d, host)
        tm = tm.apply_delta(d_src, d_dst, d_val)
        parts_s.append(d_src)
        parts_d.append(d_dst)
        parts_v.append(d_val)
        wg_cur[host] += wg_cur[d]
        wg_cur[d] = 0.0
        host_out[i] = host
    delta = (
        np.concatenate(parts_s),
        np.concatenate(parts_d),
        np.concatenate(parts_v),
    )
    # snapshot the pre-failure values of every key the batch touches —
    # the bit-exact restoration source for rejoin_devices
    n = tm0.n_devices
    keys = np.unique(delta[0] * n + delta[1])
    rows0, cols0, vals0 = tm0.rows(), tm0.indices, tm0.data
    hit0 = np.isin(rows0 * n + cols0, keys)
    return Evacuation(
        delta=delta,
        dead=dead.copy(),
        hosts=host_out,
        wg_before=wg.copy(),
        wg_after=wg_cur,
        orig=(rows0[hit0].copy(), cols0[hit0].copy(), vals0[hit0].copy()),
        n_devices=n,
    )


def rejoin_devices(
    tb: RoutingTable,
    evac: Evacuation,
    *,
    balance_slack: float = 0.05,
    sweeps: int = 2,
) -> ReplanResult:
    """Re-join previously evacuated devices — the inverse of
    :func:`evacuate_devices`.

    Applies the recorded evacuation's exact inverse delta (flows move
    back from the hosts onto the repaired devices, host-internalized
    pairs reappear) and restores the recorded weights, then runs the
    ordinary incremental :func:`replan` with *no* device barred from
    bridge duty — the repaired hardware is eligible again.  Because
    the inverse re-writes the recorded pre-failure entries (rather than
    negating float sums), the rejoined traffic matrix is bit-identical
    to the pre-failure one; the table follows from it deterministically.
    """
    if not isinstance(tb.device_traffic, TrafficMatrix):
        raise ValueError("rejoin_devices needs the sparse TrafficMatrix path")
    obs.instant("replan.rejoin", cat="recovery", tid="replan",
                args={"devices": [int(d) for d in np.asarray(evac.dead).ravel()]})
    tm_restored = evac.restore_matrix(tb.device_traffic)
    ds, dd, _ = evac.delta
    touched_dev = np.unique(np.concatenate([ds, dd, evac.dead, evac.hosts]))
    return _replan_core(
        tb,
        evac.wg_before,
        tm_restored,
        touched_dev,
        np.empty(0, dtype=np.int64),
        balance_slack=balance_slack,
        sweeps=sweeps,
    )
