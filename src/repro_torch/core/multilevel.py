"""Multilevel (coarsen–partition–refine) partitioning.

The seed's Algorithm 1 grows parts greedily over the full graph, which
is fine at population scale (M ≈ 2·10⁴) but is the wrong tool once the
model is carried at finer granularity — the paper's 10B-neuron /
2,000-GPU headline needs the METIS-style multilevel scheme:

1. **Coarsen** — repeated heavy-edge matching: every vertex points at
   its heaviest-traffic neighbor; mutual pairs merge.  Each level
   roughly halves the vertex count while preserving cut values exactly
   for any partition that respects the merges.
2. **Partition** — the existing balance-constrained greedy (Algorithm 1)
   runs on the coarsest graph, where it is both fast and effective.
3. **Uncoarsen + refine** — the assignment is projected back level by
   level, with vectorized boundary-KL/FM sweeps
   (:func:`repro_torch.core.partition.refine_sweep_csr`) repairing the cut at
   every resolution.

The result is a drop-in :class:`PartitionResult` (``method='multilevel'``),
so Algorithm 2 routing, the latency model, the benchmarks, and the SNN
placement path consume it unchanged.

Internally levels are held as CSR *traffic* graphs ``(indptr, indices,
tval, w)`` where ``tval`` is the per-edge traffic ``P·Wᵢ·Wⱼ`` (both
directions stored).  Contraction sums edge traffic and vertex weights,
which keeps every level's cut identical to the fine-level cut of the
projected assignment — no re-derivation of probabilities is needed
until the coarsest graph is handed to the greedy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CommGraph
from repro_torch.obs import trace as obs
from repro_torch.core.partition import (
    PartitionResult,
    _result,
    greedy_partition,
    rebalance_csr,
    refine_sweep_csr,
    refine_sweep_csr_seq,
    swap_sweep_csr_seq,
)

__all__ = ["multilevel_partition", "coarsen_graph", "heavy_edge_matching"]


@dataclasses.dataclass(frozen=True)
class _Level:
    """One CSR traffic graph in the multilevel hierarchy."""

    indptr: np.ndarray
    indices: np.ndarray
    tval: np.ndarray  # per-edge traffic, aligned with indices
    w: np.ndarray  # per-vertex weight

    @property
    def num_vertices(self) -> int:
        return int(self.w.shape[0])

    def rows(self) -> np.ndarray:
        return np.repeat(
            np.arange(self.num_vertices, dtype=np.int64), np.diff(self.indptr)
        )

    def cut(self, assign: np.ndarray) -> float:
        mask = assign[self.rows()] != assign[self.indices]
        return float(self.tval[mask].sum() / 2.0)


def _level_from_graph(g: CommGraph) -> _Level:
    return _Level(
        indptr=g.indptr.astype(np.int64),
        indices=g.indices.astype(np.int64),
        tval=g.edge_traffic(),
        w=g.weights.astype(np.float64),
    )


def heavy_edge_matching(
    level: _Level, rng: np.random.Generator, max_weight: float | None = None
) -> np.ndarray:
    """Heavy-edge matching → coarse vertex ids ``int64[M]``.

    Two phases:

    1. A vectorized *mutual heaviest-neighbor* pass: every vertex points
       at its heaviest-traffic neighbor (seeded jitter breaks ties) and
       pairs pointing at each other merge.  Cheap, grabs most of a
       regular graph in one shot.
    2. A sequential sweep (random visit order, METIS-style) matching each
       still-unmatched vertex with its heaviest unmatched neighbor.
       This is what makes hub-heavy graphs coarsen: thousands of spokes
       pointing at one hub defeat the mutual pass (only one pair merges
       per hub), but the sweep pairs the remaining spokes among
       themselves.

    Pairs whose combined weight exceeds ``max_weight`` are refused (the
    METIS vertex-weight limit): an over-heavy coarse cluster would be
    unplaceable under the balance cap and impossible to split again
    during uncoarsening.  Unmatchable vertices stay singletons.
    """
    m = level.num_vertices
    vidx = np.arange(m, dtype=np.int64)
    indptr, indices, tval = level.indptr, level.indices, level.tval
    partner = np.full(m, -1, dtype=np.int64)
    if tval.size:
        scale = float(tval.mean()) + 1e-300
        vals = tval + rng.random(tval.shape[0]) * scale * 1e-9
        # Heaviest neighbor per row: stable lexsort groups each CSR row
        # contiguously sorted by value; the row's last slot is its max.
        deg = np.diff(indptr)
        order = np.lexsort((vals, level.rows()))
        heaviest = np.full(m, -1, dtype=np.int64)
        nz = deg > 0
        heaviest[nz] = indices[order[indptr[1:][nz] - 1]]
        valid = heaviest >= 0
        back = np.full(m, -1, dtype=np.int64)
        back[valid] = heaviest[heaviest[valid]]
        mutual = valid & (back == vidx)
        if max_weight is not None:
            pair_w = level.w + level.w[np.where(valid, heaviest, 0)]
            mutual &= pair_w <= max_weight
        partner[mutual] = heaviest[mutual]
        # Phase 2: sequential pairing of the leftovers.
        w = level.w
        for v in rng.permutation(np.flatnonzero(partner < 0)).tolist():
            if partner[v] != -1:
                continue
            lo, hi = indptr[v], indptr[v + 1]
            nbrs = indices[lo:hi]
            free = partner[nbrs] == -1
            if max_weight is not None:
                free &= w[nbrs] + w[v] <= max_weight
            if not free.any():
                partner[v] = v
                continue
            cand = nbrs[free]
            u = int(cand[np.argmax(vals[lo:hi][free])])
            partner[v] = u
            partner[u] = v
    partner[partner < 0] = vidx[partner < 0]
    rep = np.minimum(vidx, partner)
    _, coarse = np.unique(rep, return_inverse=True)
    return coarse.astype(np.int64)


def coarsen_graph(level: _Level, coarse: np.ndarray) -> _Level:
    """Contract ``level`` by the ``coarse`` vertex map (traffic-summing)."""
    mc = int(coarse.max()) + 1 if coarse.size else 0
    rows = level.rows()
    cs, cd = coarse[rows], coarse[level.indices]
    keep = cs != cd  # intra-cluster traffic disappears from the cut
    key = cs[keep] * mc + cd[keep]
    wc = np.bincount(coarse, weights=level.w, minlength=mc)
    if key.size == 0:
        return _Level(
            indptr=np.zeros(mc + 1, dtype=np.int64),
            indices=np.zeros(0, dtype=np.int64),
            tval=np.zeros(0),
            w=wc,
        )
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    tv = np.add.reduceat(level.tval[keep][order], starts)
    src_c = ks[starts] // mc
    dst_c = ks[starts] % mc
    counts = np.bincount(src_c, minlength=mc)
    indptr = np.zeros(mc + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return _Level(indptr=indptr, indices=dst_c, tval=tv, w=wc)


def _as_commgraph(level: _Level) -> CommGraph:
    """Wrap a traffic CSR as a CommGraph for the coarsest-level greedy.

    ``probs = tval / (Wᵢ·Wⱼ)`` rescaled uniformly into [0, 1] keeps
    ``edge_traffic`` exactly proportional to ``tval``, so the greedy
    optimizes the same objective up to a constant factor.
    """
    rows = level.rows()
    wsafe = np.where(level.w > 0, level.w, 1.0)
    raw = level.tval / (wsafe[rows] * wsafe[level.indices])
    scale = float(raw.max()) if raw.size else 1.0
    return CommGraph(
        indptr=level.indptr,
        indices=level.indices,
        probs=raw / max(scale, 1e-300),
        weights=wsafe,
    )


#: Below this vertex count the legacy greedy is cheap enough to run as a
#: guard: multilevel returns whichever assignment cuts less, so it is
#: never worse than Algorithm 1 at scales where both are affordable.
GREEDY_GUARD_MAX_M = 20_000


def multilevel_partition(
    g: CommGraph,
    n_parts: int,
    *,
    coarsen_to: int | None = None,
    max_levels: int = 30,
    itermax: int = 8,
    refine_sweeps: int = 4,
    balance_slack: float = 0.05,
    seed: int = 0,
    compare_greedy: bool | None = None,
) -> PartitionResult:
    """Multilevel drop-in for :func:`greedy_partition` at large M.

    Args:
      g: communication graph (``P`` in CSR + ``W``).
      n_parts: number of devices ``N``.
      coarsen_to: stop coarsening near this vertex count (default
        ``max(4·n_parts, 512)``).
      max_levels: hard cap on coarsening depth.
      itermax: refinement budget of the coarsest-level greedy.
      refine_sweeps: boundary-KL sweeps per uncoarsening level.
      balance_slack: admissible relative overshoot of the average load.
      seed: RNG seed (matching jitter + greedy fronts).
      compare_greedy: also run the full-graph greedy and keep the better
        cut.  ``None`` (default) enables the guard up to
        ``GREEDY_GUARD_MAX_M`` vertices, where the greedy costs little —
        on ring-like graphs its contiguous growth can still edge out
        coarsen–refine, and the guard makes multilevel never worse there.

    Returns:
      :class:`PartitionResult` with ``method='multilevel'``; ``history``
      holds the cut after the coarsest partition and after every
      uncoarsening level (all values measured in fine-graph traffic units,
      which contraction preserves).
    """
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    m = g.num_vertices
    if coarsen_to is None:
        coarsen_to = max(4 * n_parts, 512)
    if m <= max(coarsen_to, 2 * n_parts):
        res = greedy_partition(
            g, n_parts, itermax=itermax, balance_slack=balance_slack, seed=seed
        )
        return _result(g, res.assign, n_parts, res.history, "multilevel")

    rng = np.random.default_rng(seed)
    levels: list[_Level] = [_level_from_graph(g)]
    maps: list[np.ndarray] = []  # maps[i]: levels[i] vertex -> levels[i+1] vertex
    stop_at = max(coarsen_to, 2 * n_parts)
    # Cap coarse clusters at 4× the average coarsest-level vertex weight —
    # heavier merges would be unplaceable under the balance cap (stop_at
    # ≥ 4·n_parts keeps this ≤ the per-part capacity).
    max_cluster_w = 4.0 * float(g.weights.sum()) / stop_at
    with obs.span("plan.multilevel.coarsen", cat="plan", tid="partition") as sp:
        while levels[-1].num_vertices > stop_at and len(levels) <= max_levels:
            cur = levels[-1]
            coarse = heavy_edge_matching(cur, rng, max_weight=max_cluster_w)
            mc = int(coarse.max()) + 1
            if mc >= cur.num_vertices * 0.95:
                break  # matching stalled; further levels would not shrink
            if mc < stop_at:
                # Overshoot: accept only if still enough vertices per part.
                if mc < 2 * n_parts:
                    break
            maps.append(coarse)
            levels.append(coarsen_graph(cur, coarse))
        sp.set(levels=len(levels), coarsest=levels[-1].num_vertices)

    # Initial partition on the coarsest graph via Algorithm 1.  The
    # coarsest graph is small, so run a few seeded fronts and keep the
    # best — the standard multilevel trick for a robust starting point.
    coarsest = levels[-1]
    cg = _as_commgraph(coarsest)
    with obs.span("plan.multilevel.init_partition", cat="plan", tid="partition"):
        init = min(
            (
                greedy_partition(
                    cg,
                    n_parts,
                    itermax=itermax,
                    balance_slack=balance_slack,
                    seed=s,
                    swap_moves=False,  # coarse seed only; see greedy_partition
                )
                for s in range(seed, seed + 3)
            ),
            key=lambda r: r.cut,
        )
    assign = init.assign.copy()
    history = [coarsest.cut(assign)]
    cap = float(g.weights.sum()) / n_parts * (1.0 + balance_slack)

    # Uncoarsen: project through each map, restore balance (the coarse
    # greedy works at lumpier granularity and may overshoot the cap), and
    # repair the boundary.
    with obs.span("plan.multilevel.uncoarsen_refine", cat="plan", tid="partition"):
        for level, coarse in zip(reversed(levels[:-1]), reversed(maps)):
            assign = assign[coarse]
            rebalance_csr(
                level.indptr, level.indices, level.tval, level.w, assign, n_parts, cap
            )
            args = (level.indptr, level.indices, level.tval, level.w, assign, n_parts, cap)
            # Balanced pair-swaps escape the fixed points single moves cannot
            # leave (transposed community members) — but only on the finest
            # level, where a swap improves the *true* objective; escaping a
            # coarse-level optimum merely perturbs the uncoarsening
            # trajectory, which is not monotone in the final cut.
            finest = level is levels[0]
            for _ in range(refine_sweeps):
                if refine_sweep_csr(*args) == 0:
                    # The independent-set sweep is stuck in a local optimum;
                    # one exact sequential pass lets adjacent moves cascade.
                    if refine_sweep_csr_seq(*args) == 0:
                        if not finest or swap_sweep_csr_seq(*args) == 0:
                            break
            history.append(level.cut(assign))
    res = _result(g, assign, n_parts, tuple(history), "multilevel")
    if compare_greedy is None:
        compare_greedy = m <= GREEDY_GUARD_MAX_M
    if compare_greedy:
        guard = greedy_partition(
            g, n_parts, itermax=itermax, balance_slack=balance_slack, seed=seed
        )
        if guard.cut < res.cut:
            res = _result(g, guard.assign, n_parts, guard.history, "multilevel")
    return res
