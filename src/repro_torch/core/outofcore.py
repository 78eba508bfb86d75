"""Hierarchical out-of-core planner: paper-scale plans without global artifacts.

The paper's headline run — 10B neurons on 2,000 GPUs — cannot be planned
the way the small benchmarks do it: a global ``needed_sources`` mask is
``[N, N]`` (32 MB of bools at N=2,000, 800 GB at N=2M neurons-per-device
granularity) and a single global :class:`~repro_torch.snn.ragged.RaggedPlan`
holds ``send_idx/recv_idx`` for every device.  NEST-GPU's
thousands-of-GPUs construction and CORTEX's indegree sub-graph
decomposition (PAPERS.md) both solve this the same way: build and plan
**per shard**, never materializing a global structure.

This module applies that to the Algorithm-2 pipeline, two-tier like the
fabric itself:

* **pods** — populations are partitioned onto ``P = N / pod_size`` pods
  with the multilevel partitioner, then each pod's *induced subgraph*
  (:func:`repro_torch.core.graph.induced_subgraph`, O(pod edges)) is
  partitioned onto its ``pod_size`` local devices.  Devices are
  pod-contiguous (global id ``pod * pod_size + local``), so every
  intra-pod artifact is a contiguous CSR row slice.
* **per-pod shards** — each pod runs the full CSR Algorithm-2 pipeline
  *locally*: ``two_level_routing`` on its intra-pod traffic, group sizes
  equalized to an exact ``(G, R)`` mesh, and a mask-driven
  :func:`~repro_torch.snn.ragged.build_ragged_plan_from_mask` ragged schedule
  on the table's own bridges.  Every dense artifact is
  O(pod_size²) — the planner's peak dense footprint
  (:attr:`OutOfCorePlan.peak_dense_elems`) stays ≪ N².
* **DCN tier** — cross-pod flows route through pod bridges elected by
  the *same* :func:`~repro_torch.core.routing.select_bridges` LPT that elects
  intra-group bridges, giving a pod-level Algorithm-2
  :class:`~repro_torch.core.routing.RoutingTable` over the global device CSR
  (O(nnz), the one global input that is already sparse).
* **verification stays O(shard)** — each shard's table/schedule/ragged
  slice is a self-contained :class:`~repro_torch.analysis.context.PlanContext`
  linted by :func:`repro_torch.analysis.run_lints`, plus one cheap cross-shard
  conservation pass (rule PL160) over the ``[P, P]`` bridge-flow ledger,
  whose row ``p`` is computed by shard ``p`` from its own CSR slice —
  corrupted shards betray themselves as ledger asymmetry.

Replay the result on the two-tier pod/DCN fabric with
:func:`repro_torch.netsim.sharded_rounds`; ``benchmarks/paper_scale.py`` runs
the whole pipeline at native N=2,000 in CI.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.graph import CommGraph, induced_subgraph
from repro_torch.obs import trace as obs
from repro_torch.core.routing import (
    RoutingTable,
    device_traffic_csr,
    needed_sources,
    select_bridges,
    two_level_routing,
)
from repro_torch.core.traffic import TrafficMatrix

__all__ = [
    "PodShard",
    "OutOfCorePlan",
    "plan_out_of_core",
    "default_groups_per_pod",
    "equalize_groups",
]


@dataclasses.dataclass(frozen=True)
class PodShard:
    """One pod's self-contained slice of the out-of-core plan.

    Everything here is in *local* device ids ``[0, pod_size)``; the
    global id of local device ``d`` is ``device_lo + d``.

    Attributes:
      pod: pod index ``p``.
      device_lo: global id of the pod's first device (``p * pod_size``).
      table: local Algorithm-2 :class:`~repro_torch.core.routing.RoutingTable`
        over the pod's intra-pod traffic, group sizes equalized to an
        exact mesh.
      wg: ``float64[pod_size]`` local per-device neuron weight.
      mesh_shape: ``(G, R)`` — the pod's exact group mesh.
      mesh_perm: ``int64[pod_size]`` — local device at mesh position
        ``i`` is ``mesh_perm[i]`` (group-contiguous layout, the
        ``group_mesh_permutation`` convention).
      ragged_plan: mask-driven :class:`~repro_torch.snn.ragged.RaggedPlan` in
        mesh order, bridged on the table's own bridge devices.
      context: the shard's :class:`~repro_torch.analysis.context.PlanContext`
        (what ``repro_torch.analysis`` lints).
      findings: planlint findings for this shard (empty when clean).
      flows: ``float64[P]`` — this shard's cross-pod bridge-flow ledger
        row, computed from the shard's own slice of the global CSR.
    """

    pod: int
    device_lo: int
    table: RoutingTable
    wg: np.ndarray
    mesh_shape: tuple[int, int]
    mesh_perm: np.ndarray
    ragged_plan: object
    context: object
    findings: tuple
    flows: np.ndarray

    @property
    def n_lint_errors(self) -> int:
        return sum(1 for f in self.findings if f.severity == "error")


@dataclasses.dataclass
class OutOfCorePlan:
    """The assembled two-tier plan: per-pod shards + the DCN tier.

    Attributes:
      n_devices / pod_size / n_pods: fabric shape (``N = P · pod_size``).
      pod_of: ``int64[N]`` device → pod (``d // pod_size``).
      assign: ``int64[M]`` population → global device.
      traffic: global device-to-device :class:`TrafficMatrix` (sparse,
        O(nnz) — the only global artifact the planner keeps).
      wg: ``float64[N]`` per-device neuron weight.
      pod_table: pod-level Algorithm-2 table — ``group_of = pod_of``,
        bridges are *global device ids* elected by the same LPT as
        intra-group bridges.
      pod_gmask: ``bool[P, P]`` pod consumer mask (diagonal True).
      pod_schedule: DCN ring-shift rounds over the pod mask.
      shard_flows: ``float64[P, P]`` cross-shard bridge-flow ledger; row
        ``p`` produced by shard ``p`` (PL160's input).
      shards: per-pod :class:`PodShard`\\ s (``None`` when streamed
        through ``shard_hook`` without retention).
      dcn_context: the cross-shard :class:`PlanContext` (pod mask,
        schedule, ledger, pod table) — lint it for PL160 + the pod-level
        PL101/PL110/PL121 checks.
      dcn_findings: planlint findings for ``dcn_context``.
      shard_lint_errors / shard_lint_warnings: totals across shards.
      peak_dense_elems: elements of the largest dense array any planning
        step materialized — the peak-RSS proxy
        ``benchmarks/paper_scale.py`` gates (≪ N² by construction).
      wall_s: per-phase wall-clock seconds.
    """

    n_devices: int
    pod_size: int
    n_pods: int
    pod_of: np.ndarray
    assign: np.ndarray
    traffic: TrafficMatrix
    wg: np.ndarray
    pod_table: RoutingTable
    pod_gmask: np.ndarray
    pod_schedule: list
    shard_flows: np.ndarray
    shards: tuple | None
    dcn_context: object
    dcn_findings: tuple
    shard_lint_errors: int
    shard_lint_warnings: int
    peak_dense_elems: int
    wall_s: dict

    @property
    def n_lint_errors(self) -> int:
        """Total error findings: every shard plus the DCN tier."""
        return self.shard_lint_errors + sum(
            1 for f in self.dcn_findings if f.severity == "error"
        )


def default_groups_per_pod(pod_size: int) -> int:
    """Divisor of ``pod_size`` nearest the paper's ``N/8`` sweet spot.

    The ragged mesh needs exactly equal group sizes (``G | pod_size``);
    among the proper divisors ≥ 2 this picks the one closest to
    ``pod_size // 8`` (the group count the Fig. 3(b) sweep favors),
    preferring the smaller on ties.
    """
    if pod_size < 4:
        raise ValueError(f"pod_size {pod_size} too small to group (need >= 4)")
    target = max(2, pod_size // 8)
    divisors = [d for d in range(2, pod_size) if pod_size % d == 0]
    if not divisors:
        raise ValueError(f"pod_size {pod_size} is prime; pick a composite pod size")
    return min(divisors, key=lambda d: (abs(d - target), d))


def equalize_groups(
    tm: TrafficMatrix, group_of: np.ndarray, n_groups: int
) -> np.ndarray:
    """Force exactly equal group sizes by affinity-greedy moves.

    ``two_level_routing`` balances group *weight* within a slack, but the
    ragged mesh and :func:`~repro_torch.snn.distributed.group_mesh_permutation`
    need exactly ``R = N / G`` members per group.  Devices are moved from
    over-full to under-full groups one at a time, each move picking the
    (device, destination) pair losing the least intra-group traffic
    affinity (``d2g[d, dst] - d2g[d, src]`` maximal).  Returns a new
    assignment; bridges must be re-elected afterwards
    (:func:`~repro_torch.core.routing.select_bridges`).
    """
    n = int(group_of.shape[0])
    g = int(n_groups)
    if n % g:
        raise ValueError(f"n_groups {g} must divide n_devices {n}")
    r = n // g
    group_of = np.asarray(group_of, dtype=np.int64).copy()
    rows, cols, vals = tm.rows(), tm.indices, tm.data
    while True:
        counts = np.bincount(group_of, minlength=g)
        over = np.flatnonzero(counts > r)
        if not over.size:
            return group_of
        under = np.flatnonzero(counts < r)
        d2g = np.bincount(
            rows * g + group_of[cols], weights=vals, minlength=n * g
        ).reshape(n, g)
        best = None
        for go in over:
            members = np.flatnonzero(group_of == go)
            gain = d2g[np.ix_(members, under)] - d2g[members, go][:, None]
            i, j = np.unravel_index(int(np.argmax(gain)), gain.shape)
            cand = (float(gain[i, j]), int(members[i]), int(under[j]))
            if best is None or cand[0] > best[0]:
                best = cand
        group_of[best[1]] = best[2]


def plan_out_of_core(
    graph: CommGraph,
    n_devices: int,
    pod_size: int,
    *,
    n_groups_per_pod: int | None = None,
    method: str = "multilevel",
    block_size: int = 4,
    seed: int = 0,
    itermax: int = 8,
    balance_slack: float = 0.05,
    shard_balance_slack: float = 0.25,
    waste_threshold: float = 0.9,
    sym_mode: str = "auto",
    topology=None,
    lint: bool = True,
    shard_hook=None,
    keep_shards: bool = True,
) -> OutOfCorePlan:
    """Plan N devices hierarchically, one pod shard at a time.

    Args:
      graph: population :class:`~repro_torch.core.graph.CommGraph` (any scale;
        only O(nnz) global passes touch it).
      n_devices: total device count ``N`` (``pod_size`` must divide it).
      pod_size: devices per pod — the *shard* granularity; every dense
        planning artifact is O(pod_size²).
      n_groups_per_pod: intra-pod group count ``G`` (must divide
        ``pod_size``); default :func:`default_groups_per_pod`.
      method: grouping method for the per-pod Algorithm-2 run and the
        population partitions ('multilevel' recommended at scale).
      block_size: spike lanes per device block in the shard ragged plans.
      shard_balance_slack / waste_threshold: lint thresholds for the
        per-shard contexts (the equalized mesh trades some weight balance
        for exact sizes, and mask-driven payloads pad more than
        tile-pruned ones).
      sym_mode: how ``graph`` stores each flow — see
        :func:`~repro_torch.core.routing.device_traffic_csr`.
      topology: optional :class:`~repro_torch.netsim.topology.Topology` for the
        DCN context (enables the PL150 route check).
      lint: run ``repro_torch.analysis`` per shard + cross-shard (the planner's
        built-in static verification; disable only for timing runs).
      shard_hook: called with each finished :class:`PodShard` — the
        streaming interface; combined with ``keep_shards=False`` the
        planner holds at most one shard at a time.
      keep_shards: retain shards on the returned plan.

    Returns:
      :class:`OutOfCorePlan`.
    """
    from repro_torch.analysis.context import PlanContext
    from repro_torch.analysis.rules import run_lints
    from repro_torch.core.multilevel import multilevel_partition
    from repro_torch.snn.ragged import (
        bridge_inner_from_table,
        build_ragged_plan_from_mask,
    )
    from repro_torch.snn.sparse import exchange_schedule

    if n_devices % pod_size:
        raise ValueError(f"pod_size {pod_size} must divide n_devices {n_devices}")
    n_pods = n_devices // pod_size
    if n_pods < 2:
        raise ValueError("need at least 2 pods (use two_level_routing directly)")
    if graph.num_vertices < n_devices:
        raise ValueError(
            f"{graph.num_vertices} populations cannot fill {n_devices} devices"
        )
    g_pp = (
        default_groups_per_pod(pod_size)
        if n_groups_per_pod is None
        else int(n_groups_per_pod)
    )
    if pod_size % g_pp:
        raise ValueError(f"n_groups_per_pod {g_pp} must divide pod_size {pod_size}")
    r_pp = pod_size // g_pp
    wall: dict[str, float] = {}
    peak_dense = 0

    def _track(*elem_counts: int) -> None:
        nonlocal peak_dense
        peak_dense = max(peak_dense, *[int(c) for c in elem_counts])

    # ---- tier 1: populations → pods, then pods → local devices --------
    t0 = time.perf_counter()
    _ts = obs.now_us()
    pod_parts = multilevel_partition(
        graph, n_pods, itermax=itermax, balance_slack=balance_slack, seed=seed
    )
    assign = np.empty(graph.num_vertices, dtype=np.int64)
    for p in range(n_pods):
        verts = np.flatnonzero(pod_parts.assign == p)
        if verts.size < pod_size:
            raise ValueError(
                f"pod {p} holds {verts.size} populations for {pod_size} devices"
            )
        sub, verts = induced_subgraph(graph, verts)
        local = multilevel_partition(
            sub,
            pod_size,
            itermax=itermax,
            balance_slack=balance_slack,
            seed=seed + 1 + p,
        )
        assign[verts] = p * pod_size + local.assign
    wall["partition_s"] = time.perf_counter() - t0
    obs.complete("outofcore.partition", _ts, wall["partition_s"] * 1e6,
                 cat="plan", tid="outofcore", args={"n_pods": n_pods})

    # ---- global device CSR + pod tier (both O(nnz) / O(P²)) -----------
    t0 = time.perf_counter()
    _ts = obs.now_us()
    tm, wg = device_traffic_csr(graph, assign, n_devices, sym_mode=sym_mode)
    pod_of = np.arange(n_devices, dtype=np.int64) // pod_size
    pod_bridge, pod_share = select_bridges(tm, pod_of, n_pods)
    _track(n_devices * n_pods, n_pods * n_pods)  # LPT's [N, P] + [P, P]
    pod_table = RoutingTable(
        group_of=pod_of,
        n_groups=n_pods,
        bridge=pod_bridge,
        device_traffic=tm,
        method=method,
        share_coo=pod_share,
    )
    pod_table.validate()
    wall["pod_route_s"] = time.perf_counter() - t0
    obs.complete("outofcore.pod_route", _ts, wall["pod_route_s"] * 1e6,
                 cat="plan", tid="outofcore")

    # ---- tier 2: one self-contained shard per pod ---------------------
    t0 = time.perf_counter()
    rows_ptr = tm.indptr
    shard_flows = np.zeros((n_pods, n_pods), dtype=np.float64)
    shards: list[PodShard] = []
    lint_err = lint_warn = 0
    for p in range(n_pods):
        _pts = obs.now_us()
        lo, hi = p * pod_size, (p + 1) * pod_size
        s, e = int(rows_ptr[lo]), int(rows_ptr[hi])
        cols_sl = tm.indices[s:e]
        vals_sl = tm.data[s:e]
        rows_sl = np.repeat(
            np.arange(pod_size, dtype=np.int64), np.diff(rows_ptr[lo : hi + 1])
        )
        in_pod = (cols_sl >= lo) & (cols_sl < hi)
        # the shard's ledger row — from its own CSR slice only
        shard_flows[p] = np.bincount(
            cols_sl[~in_pod] // pod_size,
            weights=vals_sl[~in_pod],
            minlength=n_pods,
        )
        shard_flows[p, p] = 0.0
        tm_local = TrafficMatrix.from_coo(
            rows_sl[in_pod], cols_sl[in_pod] - lo, vals_sl[in_pod], pod_size
        )
        wg_local = wg[lo:hi]
        tb0 = two_level_routing(
            tm_local,
            wg_local,
            g_pp,
            itermax=itermax,
            balance_slack=balance_slack,
            seed=seed + 1 + p,
            grouping=method,
        )
        eq = equalize_groups(tm_local, tb0.group_of, g_pp)
        if np.array_equal(eq, tb0.group_of):
            tb = tb0
        else:
            bridge, share = select_bridges(tm_local, eq, g_pp)
            tb = RoutingTable(
                group_of=eq,
                n_groups=g_pp,
                bridge=bridge,
                device_traffic=tm_local,
                method=tb0.method,
                share_coo=share,
            )
            tb.validate()
        mesh_perm = np.argsort(tb.group_of, kind="stable")
        mask_local = needed_sources(tb)  # dense [pod, pod] — O(shard)
        mask_mesh = mask_local[np.ix_(mesh_perm, mesh_perm)]
        plan = build_ragged_plan_from_mask(
            mask_mesh,
            (g_pp, r_pp),
            block_size,
            bridge_inner=bridge_inner_from_table(tb),
        )
        _track(
            pod_size * pod_size,  # needed_sources + mask_mesh
            pod_size * g_pp,  # LPT / equalize [pod, G]
            pod_size * max((rnd.width for rnd in plan.rounds), default=0),
        )
        ctx = PlanContext.from_table(
            tb,
            name=f"pod{p:03d}",
            wg=wg_local,
            ragged_plan=plan,
            balance_slack=shard_balance_slack,
            waste_threshold=waste_threshold,
        )
        findings = tuple(run_lints(ctx)) if lint else ()
        lint_err += sum(1 for f in findings if f.severity == "error")
        lint_warn += sum(1 for f in findings if f.severity == "warning")
        shard = PodShard(
            pod=p,
            device_lo=lo,
            table=tb,
            wg=wg_local,
            mesh_shape=(g_pp, r_pp),
            mesh_perm=mesh_perm,
            ragged_plan=plan,
            context=ctx,
            findings=findings,
            flows=shard_flows[p].copy(),
        )
        if shard_hook is not None:
            shard_hook(shard)
        if keep_shards:
            shards.append(shard)
        obs.complete("outofcore.shard", _pts, obs.now_us() - _pts,
                     cat="plan", tid="outofcore",
                     args={"pod": p, "lint_findings": len(findings)})
    wall["shards_s"] = time.perf_counter() - t0

    # ---- DCN mask/schedule + the cross-shard conservation context -----
    t0 = time.perf_counter()
    _ts = obs.now_us()
    pod_gmask = shard_flows > 0
    np.fill_diagonal(pod_gmask, True)
    pod_schedule = exchange_schedule(pod_gmask)
    dcn_ctx = PlanContext(
        name="dcn",
        traffic=tm,
        wg=wg,
        table=pod_table,
        gmask=pod_gmask,
        schedule=pod_schedule,
        topology=topology,
        pod_of=pod_of,
        shard_flows=shard_flows,
        balance_slack=shard_balance_slack,
    )
    dcn_findings = tuple(run_lints(dcn_ctx)) if lint else ()
    wall["dcn_lint_s"] = time.perf_counter() - t0
    obs.complete("outofcore.dcn_lint", _ts, wall["dcn_lint_s"] * 1e6,
                 cat="plan", tid="outofcore")

    return OutOfCorePlan(
        n_devices=n_devices,
        pod_size=pod_size,
        n_pods=n_pods,
        pod_of=pod_of,
        assign=assign,
        traffic=tm,
        wg=wg,
        pod_table=pod_table,
        pod_gmask=pod_gmask,
        pod_schedule=pod_schedule,
        shard_flows=shard_flows,
        shards=tuple(shards) if keep_shards else None,
        dcn_context=dcn_ctx,
        dcn_findings=dcn_findings,
        shard_lint_errors=lint_err,
        shard_lint_warnings=lint_warn,
        peak_dense_elems=peak_dense,
        wall_s=wall,
    )
