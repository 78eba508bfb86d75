"""planlint rule registry + the Layer-1 (artifact) lint rules.

Every rule is a :class:`Rule` — an id (``PL...``), a severity, a one-line
summary, a fix hint, and a check over a
:class:`~repro_torch.analysis.context.PlanContext`.  A rule whose inputs are
absent from the context returns no findings (lint what you have); a rule
whose inputs are present but inconsistent returns :class:`Finding`\\ s.

Id ranges:

* ``PL00x`` — structural invariants of single artifacts (the checks the
  artifacts' own ``validate()`` methods delegate to,
  :mod:`repro_torch.analysis.invariants`);
* ``PL1xx`` — cross-artifact consistency: conservation, schedule safety,
  bridge soundness, balance, ragged hygiene, topology routes;
* ``PL2xx`` — traced-step lints over the compiled SPMD step
  (:mod:`repro_torch.analysis.traced`; registered here for the catalog, run
  against a live engine rather than a :class:`PlanContext`).

Run them with :func:`run_lints`; the CLI (``python -m repro_torch.analysis``)
maps error-severity findings to a nonzero exit.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np

from repro_torch.analysis import invariants

__all__ = ["Rule", "Finding", "RULES", "rule", "run_lints", "catalog"]

#: severity levels, in increasing order of badness
SEVERITIES = ("info", "warning", "error")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint hit: which rule fired, on what, and why."""

    rule_id: str
    severity: str
    message: str
    context: str = ""

    def __str__(self) -> str:
        where = f" [{self.context}]" if self.context else ""
        return f"{self.rule_id} {self.severity}{where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered lint rule.

    Attributes:
      id: stable identifier (``PL101``); mutation tests pin these.
      severity: 'error' (CLI exit 1) | 'warning' | 'info'.
      summary: one-line what-it-checks (the docs/RULES.md catalog row).
      fix_hint: what to do when it fires.
      check: ``PlanContext -> list[Finding]``; ``None`` for traced-layer
        rules, which run through :mod:`repro_torch.analysis.traced` against a
        live engine instead of a context.
    """

    id: str
    severity: str
    summary: str
    fix_hint: str
    check: Callable | None = None


#: the one registry — validate() delegation, the CLI, CI, and the README
#: catalog all read from here
RULES: dict[str, Rule] = {}


def rule(rule_id: str, *, severity: str, summary: str, fix_hint: str):
    """Register the decorated function as a rule check."""
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r}")
    if rule_id in RULES:
        raise ValueError(f"duplicate rule id {rule_id}")

    def deco(fn):
        RULES[rule_id] = Rule(
            id=rule_id,
            severity=severity,
            summary=summary,
            fix_hint=fix_hint,
            check=fn,
        )
        return fn

    return deco


def register_traced_rule(
    rule_id: str, *, severity: str, summary: str, fix_hint: str
) -> None:
    """Register a Layer-2 rule (no context check; see
    :mod:`repro_torch.analysis.traced`)."""
    if rule_id in RULES:
        raise ValueError(f"duplicate rule id {rule_id}")
    RULES[rule_id] = Rule(
        id=rule_id, severity=severity, summary=summary, fix_hint=fix_hint
    )


def _finding(rule_id: str, message: str, ctx_name: str = "") -> Finding:
    return Finding(
        rule_id=rule_id,
        severity=RULES[rule_id].severity,
        message=message,
        context=ctx_name,
    )


def run_lints(ctx, *, rules: list[str] | None = None) -> list[Finding]:
    """Run every (selected) Layer-1 rule over ``ctx``; findings sorted
    errors-first, then by rule id."""
    ids = sorted(RULES) if rules is None else list(rules)
    out: list[Finding] = []
    for rid in ids:
        r = RULES.get(rid)
        if r is None:
            raise ValueError(f"unknown rule {rid!r}")
        if r.check is None:
            continue  # traced-layer rule: needs a live engine
        out.extend(r.check(ctx))
    out.sort(key=lambda f: (-SEVERITIES.index(f.severity), f.rule_id))
    return out


def catalog() -> list[Rule]:
    """Every registered rule, id-sorted (the docs/RULES.md source)."""
    return [RULES[k] for k in sorted(RULES)]


def _wrap_invariant(rule_id, fn, ctx_name) -> list[Finding]:
    try:
        fn()
    except ValueError as e:
        msg = str(e)
        prefix = f"{rule_id}: "
        if msg.startswith(prefix):
            msg = msg[len(prefix) :]
        return [_finding(rule_id, msg, ctx_name)]
    return []


# ---------------------------------------------------------------------------
# PL00x — single-artifact structure (validate() delegation targets)
# ---------------------------------------------------------------------------


@rule(
    "PL001",
    severity="error",
    summary="CommGraph CSR structure: indptr/indices ranges, probs in [0,1], nonnegative weights",
    fix_hint="build graphs through build_graph()/from_dense(), not by hand",
)
def _graph_structure(ctx) -> list[Finding]:
    if ctx.graph is None:
        return []
    return _wrap_invariant(
        "PL001", lambda: invariants.check_comm_graph(ctx.graph), ctx.name
    )


@rule(
    "PL002",
    severity="error",
    summary="TrafficMatrix CSR structure: sorted-unique columns, empty diagonal, positive volumes",
    fix_hint="build matrices through TrafficMatrix.from_coo()/apply_delta()",
)
def _traffic_structure(ctx) -> list[Finding]:
    if ctx.traffic is None:
        return []
    return _wrap_invariant(
        "PL002", lambda: invariants.check_traffic_matrix(ctx.traffic), ctx.name
    )


@rule(
    "PL003",
    severity="error",
    summary="partition assignment maps every vertex into [0, n_parts)",
    fix_hint="re-run the partitioner; do not slice assignments by hand",
)
def _partition_assignment(ctx) -> list[Finding]:
    if ctx.partition is None:
        return []
    n_parts = ctx.n_parts
    if n_parts is None:
        n_parts = int(np.max(ctx.partition)) + 1 if ctx.partition.size else 1
    n_vertices = (
        ctx.graph.num_vertices if ctx.graph is not None else ctx.partition.shape[0]
    )
    return _wrap_invariant(
        "PL003",
        lambda: invariants.check_partition(ctx.partition, n_parts, n_vertices),
        ctx.name,
    )


@rule(
    "PL004",
    severity="error",
    summary="BlockSynapses block-CSR structure: sorted-unique sources per destination, [nnzb,B,B] tiles",
    fix_hint="build tiles through BlockSynapses.from_tiles()/from_dense()",
)
def _synapse_structure(ctx) -> list[Finding]:
    if ctx.syn is None:
        return []
    return _wrap_invariant(
        "PL004", lambda: invariants.check_block_synapses(ctx.syn), ctx.name
    )


@rule(
    "PL005",
    severity="error",
    summary="RoutingTable structure: group ids in range, every bridge a member of its source group",
    fix_hint="re-run select_bridges()/replan() instead of editing bridge rows",
)
def _table_structure(ctx) -> list[Finding]:
    if ctx.table is None:
        return []
    return _wrap_invariant(
        "PL005", lambda: invariants.check_routing_table(ctx.table), ctx.name
    )


# ---------------------------------------------------------------------------
# PL1xx — cross-artifact consistency
# ---------------------------------------------------------------------------


def _schedule_pairs(schedule) -> set[tuple[int, int]]:
    return {
        (int(gs), int(gd)) for pairs in schedule for gs, gd in pairs
    }


@rule(
    "PL101",
    severity="error",
    summary="conservation: scheduled ppermute pairs == masked group pairs, both directions",
    fix_hint="regenerate the schedule with exchange_schedule(gmask) after any mask change",
)
def _conservation(ctx) -> list[Finding]:
    if ctx.gmask is None or ctx.schedule is None:
        return []
    gm = np.asarray(ctx.gmask, dtype=bool).copy()
    np.fill_diagonal(gm, False)
    need = {(int(s), int(d)) for s, d in zip(*np.nonzero(gm))}
    have = _schedule_pairs(ctx.schedule)
    out = []
    for gs, gd in sorted(need - have):
        out.append(
            _finding(
                "PL101",
                f"masked group pair ({gs} -> {gd}) has traffic but no "
                "scheduled round (its bytes would silently never move)",
                ctx.name,
            )
        )
    for gs, gd in sorted(have - need):
        out.append(
            _finding(
                "PL101",
                f"scheduled pair ({gs} -> {gd}) carries no masked traffic "
                "(dead transfer burning slow-axis bandwidth)",
                ctx.name,
            )
        )
    return out


@rule(
    "PL102",
    severity="error",
    summary="ragged conservation: plan rounds/widths/bytes consistent with pair_cols and the mask",
    fix_hint="rebuild the plan with build_ragged_plan(); never edit RaggedRound fields",
)
def _ragged_conservation(ctx) -> list[Finding]:
    plan = ctx.ragged_plan
    if plan is None:
        return []
    out = []
    g, _r = plan.mesh_shape
    seen: set[tuple[int, int]] = set()
    for rnd in plan.rounds:
        for gs, gd in rnd.pairs:
            if (gd - gs) % g != rnd.shift:
                out.append(
                    _finding(
                        "PL102",
                        f"pair ({gs} -> {gd}) scheduled in shift-{rnd.shift} "
                        f"round but lies on shift {(gd - gs) % g}",
                        ctx.name,
                    )
                )
            if (gs, gd) not in plan.pair_cols:
                out.append(
                    _finding(
                        "PL102",
                        f"round {rnd.shift} schedules pair ({gs} -> {gd}) "
                        "absent from pair_cols (no consumed columns)",
                        ctx.name,
                    )
                )
            seen.add((int(gs), int(gd)))
        if rnd.pairs:
            widths = [
                int(plan.pair_cols[p].size)
                for p in rnd.pairs
                if p in plan.pair_cols
            ]
            want = max(widths) if widths else 0
            if rnd.width != want:
                out.append(
                    _finding(
                        "PL102",
                        f"round {rnd.shift} width K_r={rnd.width} != max "
                        f"pair width {want} (payload bytes desynced from "
                        "the executed ppermute)",
                        ctx.name,
                    )
                )
            if len(rnd.perm) != len(rnd.pairs):
                out.append(
                    _finding(
                        "PL102",
                        f"round {rnd.shift} has {len(rnd.perm)} ppermute "
                        f"pairs for {len(rnd.pairs)} scheduled group pairs",
                        ctx.name,
                    )
                )
    for gs, gd in sorted(set(plan.pair_cols) - seen):
        out.append(
            _finding(
                "PL102",
                f"pair_cols pair ({gs} -> {gd}) has consumed columns but "
                "no scheduled round (its bytes would never arrive)",
                ctx.name,
            )
        )
    # executed bytes must re-derive from the rounds exactly
    # (= exchange_volume(..., plan=plan)['ragged'], padding included)
    derived = sum(len(r.pairs) * r.width * 4 for r in plan.rounds)
    if plan.bytes_per_step != derived:
        out.append(
            _finding(
                "PL102",
                f"bytes_per_step {plan.bytes_per_step} != sum over rounds "
                f"of |pairs_r|*K_r*4 = {derived}",
                ctx.name,
            )
        )
    wire = sum(m[2] for rnd in plan.round_messages() for m in rnd)
    if wire != derived:
        out.append(
            _finding(
                "PL102",
                f"round_messages() wire bytes {wire} != executed bytes "
                f"{derived} (netsim replay would desync)",
                ctx.name,
            )
        )
    if ctx.gmask is not None:
        gm = np.asarray(ctx.gmask, dtype=bool).copy()
        np.fill_diagonal(gm, False)
        need = {(int(s), int(d)) for s, d in zip(*np.nonzero(gm))}
        for gs, gd in sorted(need - set(plan.pair_cols)):
            out.append(
                _finding(
                    "PL102",
                    f"masked group pair ({gs} -> {gd}) missing from the "
                    "ragged plan entirely",
                    ctx.name,
                )
            )
    return out


@rule(
    "PL110",
    severity="error",
    summary="schedule safety: each round a valid partial permutation on its ring shift, ≤ G−1 rounds",
    fix_hint="derive rounds from exchange_schedule(); do not merge or hand-edit rounds",
)
def _schedule_safety(ctx) -> list[Finding]:
    if ctx.schedule is None:
        return []
    g = ctx.n_groups
    if g is None:
        return []
    out = []
    if len(ctx.schedule) > g - 1:
        out.append(
            _finding(
                "PL110",
                f"{len(ctx.schedule)} rounds scheduled for G={g} groups "
                "(a full ring exchange needs at most G-1)",
                ctx.name,
            )
        )
    for rno, pairs in enumerate(ctx.schedule, start=1):
        senders: set[int] = set()
        receivers: set[int] = set()
        for gs, gd in pairs:
            gs, gd = int(gs), int(gd)
            if not (0 <= gs < g and 0 <= gd < g):
                out.append(
                    _finding(
                        "PL110",
                        f"round {rno} pair ({gs} -> {gd}) outside [0, {g})",
                        ctx.name,
                    )
                )
                continue
            if gs == gd:
                out.append(
                    _finding(
                        "PL110",
                        f"round {rno} schedules a self-send on group {gs}",
                        ctx.name,
                    )
                )
            if rno < g and gd != (gs + rno) % g:
                out.append(
                    _finding(
                        "PL110",
                        f"round {rno} pair ({gs} -> {gd}) off its ring "
                        f"shift (expected destination {(gs + rno) % g})",
                        ctx.name,
                    )
                )
            if gs in senders:
                out.append(
                    _finding(
                        "PL110",
                        f"round {rno}: group {gs} sends twice (ppermute "
                        "permutations allow one send per participant)",
                        ctx.name,
                    )
                )
            if gd in receivers:
                out.append(
                    _finding(
                        "PL110",
                        f"round {rno}: group {gd} receives twice (the "
                        "second payload silently overwrites the first)",
                        ctx.name,
                    )
                )
            senders.add(gs)
            receivers.add(gd)
    return out


@rule(
    "PL120",
    severity="error",
    summary="dead devices excluded: no evacuated device keeps bridge duty, shares, or traffic",
    fix_hint="run evacuate_device() + replan(dead=[d]) instead of editing the table",
)
def _dead_exclusion(ctx) -> list[Finding]:
    if ctx.table is None or ctx.dead is None or not len(ctx.dead):
        return []
    tb = ctx.table
    dead = np.unique(np.asarray(ctx.dead, dtype=np.int64))
    out = []
    if tb.bridge.size:
        for d in dead:
            if np.any(tb.bridge == d):
                out.append(
                    _finding(
                        "PL120",
                        f"dead device {d} still holds bridge duty",
                        ctx.name,
                    )
                )
    if tb.share_coo is not None and tb.share_coo[0].size:
        hit = np.isin(tb.share_coo[0], dead)
        if hit.any():
            out.append(
                _finding(
                    "PL120",
                    f"dead device(s) {np.unique(tb.share_coo[0][hit]).tolist()} "
                    "still carry share_coo load fractions",
                    ctx.name,
                )
            )
    tm = ctx.traffic
    if tm is None and hasattr(tb.device_traffic, "rows"):
        tm = tb.device_traffic
    if tm is not None:
        touching = np.isin(tm.rows(), dead) | np.isin(tm.indices, dead)
        if touching.any():
            out.append(
                _finding(
                    "PL120",
                    f"{int(touching.sum())} traffic entries still touch a "
                    "dead device (evacuation delta not applied)",
                    ctx.name,
                )
            )
    return out


@rule(
    "PL121",
    severity="error",
    summary="bridge shares: fractions sum to 1 per flow, rows match the bridge matrix, none on P2P tables",
    fix_hint="re-run select_bridges(); keep bridge and share_coo as one atomic output",
)
def _bridge_shares(ctx) -> list[Finding]:
    if ctx.table is None:
        return []
    return _wrap_invariant(
        "PL121", lambda: invariants.check_bridge_shares(ctx.table), ctx.name
    )


@rule(
    "PL130",
    severity="warning",
    summary="regroup balance: per-group weight within (1+slack) of the mean",
    fix_hint="raise balance_slack or re-run the grouping with more sweeps",
)
def _group_balance(ctx) -> list[Finding]:
    if ctx.table is None or ctx.wg is None:
        return []
    tb = ctx.table
    if tb.bridge.size == 0:
        return []  # P2P: one device per group, nothing to balance
    wg = np.asarray(ctx.wg, dtype=np.float64)
    loads = np.bincount(tb.group_of, weights=wg, minlength=tb.n_groups)
    cap = wg.sum() / tb.n_groups * (1.0 + ctx.balance_slack)
    out = []
    for g in np.flatnonzero(loads > cap * (1 + 1e-12)):
        out.append(
            _finding(
                "PL130",
                f"group {g} load {loads[g]:.4g} exceeds the balance cap "
                f"{cap:.4g} (slack {ctx.balance_slack:.0%})",
                ctx.name,
            )
        )
    return out


@rule(
    "PL131",
    severity="error",
    summary="every group inhabited: bridges cannot be elected from an empty group",
    fix_hint="repair the partition (genetic repair / rebalance) before routing",
)
def _empty_groups(ctx) -> list[Finding]:
    if ctx.table is None:
        return []
    tb = ctx.table
    if tb.bridge.size == 0:
        return []
    counts = np.bincount(tb.group_of, minlength=tb.n_groups)
    return [
        _finding("PL131", f"group {g} has no member devices", ctx.name)
        for g in np.flatnonzero(counts == 0)
    ]


@rule(
    "PL140",
    severity="warning",
    summary="ragged padding waste: per-round pad fraction above threshold",
    fix_hint="split wide pairs across rounds or tighten column pruning (see ROADMAP payload sharding)",
)
def _padding_waste(ctx) -> list[Finding]:
    plan = ctx.ragged_plan
    if plan is None:
        return []
    out = []
    for rnd in plan.rounds:
        if not rnd.pairs or rnd.width == 0:
            continue
        packed = sum(
            int(plan.pair_cols[p].size) for p in rnd.pairs if p in plan.pair_cols
        )
        padded = len(rnd.pairs) * rnd.width
        waste = 1.0 - packed / padded if padded else 0.0
        if waste > ctx.waste_threshold:
            out.append(
                _finding(
                    "PL140",
                    f"round {rnd.shift}: {waste:.0%} of the padded payload "
                    f"({packed}/{padded} lanes) is padding (threshold "
                    f"{ctx.waste_threshold:.0%})",
                    ctx.name,
                )
            )
    return out


@rule(
    "PL141",
    severity="error",
    summary="ragged receive hygiene: slots in [0, R·B] and non-trash slots unique per device/round",
    fix_hint="rebuild the plan; colliding recv slots silently sum two sources' spikes",
)
def _trash_collision(ctx) -> list[Finding]:
    plan = ctx.ragged_plan
    if plan is None:
        return []
    g, r = plan.mesh_shape
    rb = r * plan.block_size
    out = []
    for rnd in plan.rounds:
        if not rnd.pairs:
            continue
        ri = np.asarray(rnd.recv_idx)
        if ri.min() < 0 or ri.max() > rb:
            out.append(
                _finding(
                    "PL141",
                    f"round {rnd.shift} recv_idx outside [0, {rb}] "
                    f"(trash slot is {rb})",
                    ctx.name,
                )
            )
            continue
        for dev in range(ri.shape[0]):
            row = ri[dev]
            live = row[row < rb]
            if np.unique(live).size != live.size:
                out.append(
                    _finding(
                        "PL141",
                        f"round {rnd.shift} device {dev}: duplicate "
                        "non-trash recv slots (two payload lanes would "
                        "sum into one buffer slot)",
                        ctx.name,
                    )
                )
                break
    return out


@rule(
    "PL142",
    severity="error",
    summary="ragged column bounds: send columns and pair_cols within the source group block [0, R·B)",
    fix_hint="rebuild the plan from the synapse tiles; out-of-range columns read garbage lanes",
)
def _column_bounds(ctx) -> list[Finding]:
    plan = ctx.ragged_plan
    if plan is None:
        return []
    g, r = plan.mesh_shape
    rb = r * plan.block_size
    out = []
    for rnd in plan.rounds:
        if not rnd.pairs:
            continue
        si = np.asarray(rnd.send_idx)
        if si.size and (si.min() < 0 or si.max() >= rb):
            out.append(
                _finding(
                    "PL142",
                    f"round {rnd.shift} send_idx outside [0, {rb}) — the "
                    "packed payload would gather out of the group block",
                    ctx.name,
                )
            )
    for (gs, gd), cols in sorted(plan.pair_cols.items()):
        c = np.asarray(cols)
        if c.size and (c.min() < 0 or c.max() >= rb):
            out.append(
                _finding(
                    "PL142",
                    f"pair ({gs} -> {gd}) consumed columns outside "
                    f"[0, {rb})",
                    ctx.name,
                )
            )
    return out


def _wire_pairs(ctx) -> set[tuple[int, int]]:
    """Every (src, dst) device pair the context schedules on the wire:
    ragged-plan messages, the sparse ppermute schedule lowered onto the
    mesh, and Algorithm-2 bridge pairs.  Shared by PL150/PL170/PL171."""
    pairs: set[tuple[int, int]] = set()
    if ctx.ragged_plan is not None:
        for rnd in ctx.ragged_plan.round_messages():
            pairs.update((int(s), int(d)) for s, d, _ in rnd)
    if ctx.schedule is not None and ctx.mesh_shape is not None:
        from repro_torch.snn.sparse import exchange_messages

        g, r = ctx.mesh_shape
        gm = np.zeros((g, g), dtype=bool)
        for rnd in ctx.schedule:
            for gs, gd in rnd:
                if 0 <= gs < g and 0 <= gd < g:
                    gm[gs, gd] = True
        for rnd in exchange_messages(gm, (g, r) if r > 1 else (g,), 1):
            pairs.update((int(s), int(d)) for s, d, _ in rnd)
    tb = ctx.table
    if tb is not None and tb.bridge.size:
        gpt = np.asarray(tb.bridge >= 0)
        for gs, gd in zip(*np.nonzero(gpt)):
            if gs == gd:
                continue
            pairs.add((int(tb.bridge[gs, gd]), int(tb.bridge[gd, gs])))
    return pairs


@rule(
    "PL150",
    severity="error",
    summary="topology routes: every scheduled wire pair has a netsim route",
    fix_hint="check the topology's n_devices / device numbering against the plan's mesh",
)
def _route_validity(ctx) -> list[Finding]:
    topo = ctx.topology
    if topo is None:
        return []
    pairs = _wire_pairs(ctx)
    out = []
    for src, dst in sorted(pairs):
        if src == dst:
            continue
        try:
            route = topo.route(src, dst)
        except ValueError as e:
            out.append(
                _finding(
                    "PL150",
                    f"scheduled pair ({src} -> {dst}) has no route on "
                    f"{topo.name}: {e}",
                    ctx.name,
                )
            )
            continue
        if len(route) == 0:
            out.append(
                _finding(
                    "PL150",
                    f"scheduled pair ({src} -> {dst}) resolves to an empty "
                    f"route on {topo.name}",
                    ctx.name,
                )
            )
    return out


@rule(
    "PL160",
    severity="error",
    summary="cross-shard conservation: per-shard bridge-flow ledgers agree pairwise and match the pod mask",
    fix_hint="rebuild each shard's ledger row from its own traffic slice; never edit shard_flows by hand",
)
def _cross_shard_flows(ctx) -> list[Finding]:
    flows = ctx.shard_flows
    if flows is None:
        return []
    f = np.asarray(flows, dtype=np.float64)
    if f.ndim != 2 or f.shape[0] != f.shape[1]:
        return [
            _finding(
                "PL160",
                f"shard_flows must be a square [P, P] ledger, got {f.shape}",
                ctx.name,
            )
        ]
    out = []
    for s in np.flatnonzero(np.abs(np.diag(f)) > 0):
        out.append(
            _finding(
                "PL160",
                f"shard {s} books intra-pod traffic on the cross-pod "
                "ledger diagonal",
                ctx.name,
            )
        )
    # pairwise agreement: shard s's claim of the s↔t flow (row s, from
    # s's slice of the CSR) must equal shard t's independent claim (row
    # t) — the two rows come from disjoint memory, so a corrupted slice
    # shows up as asymmetry
    asym = ~np.isclose(f, f.T, rtol=1e-9, atol=1e-12)
    np.fill_diagonal(asym, False)
    for s, t in zip(*np.nonzero(np.triu(asym))):
        out.append(
            _finding(
                "PL160",
                f"shards {s} and {t} disagree on their bridge flow: "
                f"shard {s}'s ledger says {f[s, t]:.6g}, shard {t}'s "
                f"says {f[t, s]:.6g}",
                ctx.name,
            )
        )
    # ledger vs the pod-level consumer mask / schedule
    if ctx.gmask is not None and np.asarray(ctx.gmask).shape == f.shape:
        gm = np.asarray(ctx.gmask, dtype=bool).copy()
        np.fill_diagonal(gm, False)
        live = f > 0
        np.fill_diagonal(live, False)
        for s, t in zip(*np.nonzero(live & ~gm)):
            out.append(
                _finding(
                    "PL160",
                    f"ledger flow ({s} -> {t}) has no masked pod pair "
                    "(its bytes would never be scheduled)",
                    ctx.name,
                )
            )
        for s, t in zip(*np.nonzero(gm & ~live)):
            out.append(
                _finding(
                    "PL160",
                    f"masked pod pair ({s} -> {t}) carries no ledger flow "
                    "(dead DCN transfer)",
                    ctx.name,
                )
            )
    # ledger vs an independent pod aggregation of the global traffic —
    # O(nnz), the only check that touches a global artifact, and only
    # when the caller supplies one
    if (
        ctx.traffic is not None
        and hasattr(ctx.traffic, "rows")
        and ctx.pod_of is not None
    ):
        p = f.shape[0]
        pod_of = np.asarray(ctx.pod_of, dtype=np.int64)
        tm = ctx.traffic
        agg = np.bincount(
            pod_of[tm.rows()] * p + pod_of[tm.indices],
            weights=tm.data,
            minlength=p * p,
        ).reshape(p, p)
        np.fill_diagonal(agg, 0.0)
        bad = ~np.isclose(f, agg, rtol=1e-9, atol=1e-12)
        np.fill_diagonal(bad, False)
        nbad = int(bad.sum())
        if nbad:
            out.append(
                _finding(
                    "PL160",
                    f"{nbad} ledger entries differ from the pod-aggregated "
                    "device traffic (shard slices desynced from the CSR)",
                    ctx.name,
                )
            )
    return out


@rule(
    "PL170",
    severity="error",
    summary="dead-device isolation: a recovered plan schedules nothing on an evacuated device",
    fix_hint="re-run evacuate_devices/replan(dead=...) — a dead device left in a bridge row or traffic CSR will be waited on forever at runtime",
)
def _dead_device_isolation(ctx) -> list[Finding]:
    if not ctx.dead:
        return []
    dead = {int(d) for d in ctx.dead}
    out = []
    # ragged-plan messages carry real payload; the mesh-wide ppermute
    # lanes of a group schedule are NOT checked — a dead replica's lanes
    # are zero-payload and the executor trash-filters them
    # (repro_torch.chaos.filter_dead_rounds)
    if ctx.ragged_plan is not None:
        for rnd in ctx.ragged_plan.round_messages():
            for s, d, _ in rnd:
                hit = dead.intersection((int(s), int(d)))
                if hit:
                    out.append(
                        _finding(
                            "PL170",
                            f"ragged-plan message ({int(s)} -> {int(d)}) "
                            f"touches dead device(s) {sorted(hit)} — the "
                            "exchange would stall waiting on evacuated "
                            "hardware",
                            ctx.name,
                        )
                    )
    tb = ctx.table
    if tb is not None and tb.bridge.size:
        bridge = np.asarray(tb.bridge)
        for gs, gd in zip(*np.nonzero(np.isin(bridge, sorted(dead)))):
            out.append(
                _finding(
                    "PL170",
                    f"bridge[{gs}, {gd}] = {int(bridge[gs, gd])} elects a "
                    "dead device as a group bridge",
                    ctx.name,
                )
            )
    tm = ctx.traffic
    if tm is not None and hasattr(tm, "rows"):
        dead_arr = np.asarray(sorted(dead), dtype=np.int64)
        n_src = int(np.isin(tm.rows(), dead_arr).sum())
        n_dst = int(np.isin(tm.indices, dead_arr).sum())
        if n_src or n_dst:
            out.append(
                _finding(
                    "PL170",
                    f"device traffic still books {n_src} sent and "
                    f"{n_dst} received entries on dead devices (the "
                    "evacuation never re-keyed them)",
                    ctx.name,
                )
            )
    return out


@rule(
    "PL171",
    severity="error",
    summary="outage routing: every scheduled pair avoids the downed links (reroute exists)",
    fix_hint="the topology has no backup route around the outage — stall the exchange until the link returns or replan onto a multipath topology",
)
def _outage_routing(ctx) -> list[Finding]:
    topo = ctx.topology
    if topo is None or not ctx.down_links:
        return []
    down = frozenset(int(l) for l in ctx.down_links)
    out = []
    for src, dst in sorted(_wire_pairs(ctx)):
        if src == dst:
            continue
        try:
            route = topo.route(src, dst)
        except ValueError:
            continue  # PL150's finding, not ours
        if not down.intersection(route):
            continue
        alt = topo.route_avoiding(src, dst, down)
        if alt is None:
            out.append(
                _finding(
                    "PL171",
                    f"scheduled pair ({src} -> {dst}) rides downed "
                    f"link(s) {sorted(down.intersection(route))} on "
                    f"{topo.name} and no backup route avoids the outage",
                    ctx.name,
                )
            )
    return out


def _sim_rounds(ctx):
    """The message rounds the context would put on the wire, with real
    byte sizes — ragged plan first (the executed schedule), else the
    Algorithm-2 forwarding schedule, else the sparse ppermute schedule
    lowered onto the mesh.  Returns ``None`` when no schedule artifact
    carries byte-level rounds."""
    from repro_torch import netsim

    if ctx.ragged_plan is not None:
        return netsim.ragged_rounds(ctx.ragged_plan)
    if ctx.table is not None:
        return netsim.table_rounds(ctx.table)
    if ctx.schedule is not None and ctx.mesh_shape is not None:
        g, r = ctx.mesh_shape
        gm = np.zeros((g, g), dtype=bool)
        for rnd in ctx.schedule:
            for gs, gd in rnd:
                if 0 <= gs < g and 0 <= gd < g:
                    gm[gs, gd] = True
        return netsim.sparse_rounds(gm, (g, r) if r > 1 else (g,), 1)
    return None


@rule(
    "PL180",
    severity="info",
    summary="dominant-bottleneck attribution: one link kind holds more than bottleneck_threshold of the simulated critical path",
    fix_hint="the named fabric tier bounds the schedule — rebalance groups across that tier, widen it, or shard payloads; the decomposition says whether serialization, propagation, or queueing dominates",
)
def _bottleneck_attribution(ctx) -> list[Finding]:
    topo = ctx.topology
    thr = ctx.bottleneck_threshold
    if topo is None or thr is None:
        return []
    rounds = _sim_rounds(ctx)
    if rounds is None:
        return []
    if ctx.dead:
        dead = {int(d) for d in ctx.dead}
        rounds = [
            [m for m in rnd if m.src not in dead and m.dst not in dead]
            for rnd in rounds
        ]
    if not any(rounds):
        return []
    from repro_torch.netsim import simulate
    from repro_torch.obs.timeline import CATEGORIES, attribute_critical_path

    res = simulate(rounds, topo, collect_hops=True)
    if res.t_total <= 0.0:
        return []
    att = attribute_critical_path(res)
    kind, frac = att.dominant_kind()
    if frac <= thr:
        return []
    shares = "  ".join(
        f"{k}={v:.1%}" for k, v in sorted(att.kind_fractions().items())
    )
    decomp = "  ".join(
        f"{c}={float(att.total[c]) * 1e6:.4g}us"
        for c in CATEGORIES
        if att.total[c]
    )
    return [
        _finding(
            "PL180",
            f"link kind '{kind}' holds {frac:.1%} of the simulated "
            f"critical path on {topo.name} (> {thr:.0%} threshold, "
            f"t_total={res.t_total * 1e6:.4g}us); shares: {shares}; "
            f"decomposition: {decomp}",
            ctx.name,
        )
    ]


# ---------------------------------------------------------------------------
# PL2xx — traced-step rules (checked in repro_torch.analysis.traced against a
# live DistributedSNN engine; registered here so the catalog is complete)
# ---------------------------------------------------------------------------

register_traced_rule(
    "PL201",
    severity="error",
    summary="traced collective counts (ppermute/psum/all_gather) match what the schedule says the step emits",
    fix_hint="executor and plan disagree — re-derive the plan or fix the executor before running",
)
register_traced_rule(
    "PL202",
    severity="error",
    summary="no host callbacks / infeed / outfeed on the compiled hot path",
    fix_hint="move debugging callbacks outside the jitted step",
)
register_traced_rule(
    "PL203",
    severity="warning",
    summary="plan swap keeps the _StepKey statics (no recompile stall on flip)",
    fix_hint="warm-compile the staged signature off the hot path before flipping",
)
