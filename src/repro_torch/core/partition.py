"""Algorithm 1 — balance-constrained greedy partitioning (paper §IV-A).

Assigns ``M`` weighted vertices (neurons / populations / experts) to ``N``
devices so that

  * the total cut traffic  ``Σ_{assign[i] != assign[j]} P[i,j]·W[i]·W[j]``
    is minimized (low coupling / high cohesion), and
  * the accumulated per-device weight stays balanced — a device only admits
    another vertex while its load is below the running average
    (``Σ w_i < avg ΣW/N`` in the paper's pseudocode).

The implementation is a round-robin greedy growth (each under-loaded device
greedily grabs the unassigned vertex with the highest affinity to the
vertices it already owns) followed by ``itermax`` boundary-refinement sweeps
that keep the best solution seen — the paper's ``while t <= T … update the
best optimal solution`` loop.

Baselines implemented for the paper's comparisons (Fig. 3, Table II):
``random_partition`` (state-of-the-art simulators' random neuron→GPU
mapping), ``genetic_partition`` and ``simulated_annealing_partition``
(the meta-heuristics the paper evaluated and found insufficient).
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.graph import CommGraph

__all__ = [
    "PartitionResult",
    "cut_traffic",
    "per_part_egress",
    "part_loads",
    "imbalance",
    "greedy_partition",
    "random_partition",
    "genetic_partition",
    "simulated_annealing_partition",
    "refine_partition",
    "refine_sweep_csr",
    "refine_sweep_csr_seq",
    "swap_sweep_csr_seq",
    "rebalance_csr",
]


@dataclasses.dataclass(frozen=True)
class PartitionResult:
    """Outcome of a partitioning run.

    Attributes:
      assign:  ``int64[M]`` vertex → part mapping (the paper's ``PM`` table).
      n_parts: number of parts ``N``.
      cut:     total cut traffic (the paper's objective).
      loads:   ``float64[N]`` per-part accumulated vertex weight.
      history: objective value after each refinement sweep.
      method:  provenance tag.
    """

    assign: np.ndarray
    n_parts: int
    cut: float
    loads: np.ndarray
    history: tuple[float, ...]
    method: str

    def validate(self, g: CommGraph) -> None:
        # delegated to the planlint rule registry (rule PL003) so
        # construction-time checks and `python -m repro.analysis` agree
        from repro_torch.analysis import invariants

        invariants.check_partition(self.assign, self.n_parts, g.num_vertices)


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------


def cut_traffic(g: CommGraph, assign: np.ndarray) -> float:
    """Total traffic across parts: ``Σ_{cut (i,j)} P[i,j]·W[i]·W[j]``.

    The CSR graph is symmetric (both directions stored), so each undirected
    cut pair is counted once after halving.
    """
    rows = g.rows()
    et = g.edge_traffic()
    cut_mask = assign[rows] != assign[g.indices]
    return float(et[cut_mask].sum() / 2.0)


def per_part_egress(g: CommGraph, assign: np.ndarray, n_parts: int) -> np.ndarray:
    """Per-part egress traffic — what Fig. 3(a) plots per GPU.

    ``egress[p] = Σ_{i: assign[i]=p, j: assign[j]!=p} P[i,j]·W[i]·W[j]``.
    """
    rows = g.rows()
    et = g.edge_traffic()
    cut_mask = assign[rows] != assign[g.indices]
    return np.bincount(
        assign[rows[cut_mask]], weights=et[cut_mask], minlength=n_parts
    )


def part_loads(g: CommGraph, assign: np.ndarray, n_parts: int) -> np.ndarray:
    return np.bincount(assign, weights=g.weights, minlength=n_parts)


def imbalance(g: CommGraph, assign: np.ndarray, n_parts: int) -> float:
    """max load / mean load − 1 (0 = perfectly balanced)."""
    loads = part_loads(g, assign, n_parts)
    mean = loads.mean()
    if mean == 0:
        return 0.0
    return float(loads.max() / mean - 1.0)


def _result(
    g: CommGraph,
    assign: np.ndarray,
    n_parts: int,
    history: tuple[float, ...],
    method: str,
) -> PartitionResult:
    res = PartitionResult(
        assign=assign.astype(np.int64),
        n_parts=n_parts,
        cut=cut_traffic(g, assign),
        loads=part_loads(g, assign, n_parts),
        history=history,
        method=method,
    )
    res.validate(g)
    return res


# ---------------------------------------------------------------------------
# Algorithm 1 — greedy balance-constrained partitioning
# ---------------------------------------------------------------------------


def greedy_partition(
    g: CommGraph,
    n_parts: int,
    *,
    itermax: int = 8,
    balance_slack: float = 0.05,
    seed: int = 0,
    swap_moves: bool = True,
) -> PartitionResult:
    """The paper's Algorithm 1.

    Args:
      g: communication graph (``P`` in CSR + ``W``).
      n_parts: number of devices ``N``.
      itermax: the paper's ``T`` — refinement sweeps after the greedy growth.
      balance_slack: admissible relative overshoot of the average load.
      seed: RNG seed for seeding the growth fronts.
      swap_moves: allow balanced pair-swaps once single moves are
        exhausted (:func:`swap_sweep_csr_seq`) — needed to recover
        communities whose members got transposed between full parts.
        The multilevel coarsest-level init disables them (a coarse seed
        only needs to be cheap, and swaps there perturb the uncoarsening
        trajectory non-monotonically).

    Returns:
      :class:`PartitionResult` with the neuron→GPU mapping ``PM``.
    """
    m, n = g.num_vertices, n_parts
    if n <= 0:
        raise ValueError("n_parts must be positive")
    if n >= m:
        # Degenerate: one vertex per part (extra parts stay empty).
        assign = np.arange(m, dtype=np.int64) % n
        return _result(g, assign, n, (), "greedy")
    rng = np.random.default_rng(seed)
    w = g.weights
    target = w.sum() / n
    cap = target * (1.0 + balance_slack)

    assign = np.full(m, -1, dtype=np.int64)
    load = np.zeros(n, dtype=np.float64)
    # gain[v] is maintained *per currently-considered part* via per-part
    # dictionaries: gain_maps[p][v] = Σ_{u ∈ p, u~v} P[v,u]·W[v]·W[u].
    gain_maps: list[dict[int, float]] = [dict() for _ in range(n)]
    heaps: list[list[tuple[float, int]]] = [[] for _ in range(n)]

    def _absorb(v: int, p: int) -> None:
        """Assign v to p and propagate affinity to unassigned neighbors."""
        assign[v] = p
        load[p] += w[v]
        gain_maps[p].pop(v, None)
        nbrs, probs = g.neighbors(v)
        gm = gain_maps[p]
        hp = heaps[p]
        wv = w[v]
        for u, pr in zip(nbrs.tolist(), probs.tolist()):
            if assign[u] != -1:
                continue
            gain = gm.get(u, 0.0) + pr * wv * w[u]
            gm[u] = gain
            heapq.heappush(hp, (-gain, u))

    # Weight-descending order shared by seeding and the empty-frontier
    # fallback: a cursor walks it once over the whole run, so restarting a
    # region never rescans the assignment (keeps large sparse M linear).
    by_weight = np.argsort(-w, kind="stable")
    fallback_pos = 0

    def _next_unassigned() -> int:
        nonlocal fallback_pos
        while fallback_pos < m and assign[by_weight[fallback_pos]] != -1:
            fallback_pos += 1
        return int(by_weight[fallback_pos]) if fallback_pos < m else -1

    # Seed each part with a heavy vertex, spread by shuffling the top-2N
    # heaviest so that re-runs with different seeds explore different fronts.
    heavy = by_weight[: min(m, 2 * n)].copy()
    rng.shuffle(heavy)
    for p, v in enumerate(heavy[:n]):
        _absorb(int(v), p)

    unassigned = m - n
    order = np.arange(n)
    while unassigned > 0:
        # Fill most-underloaded parts first — the paper's balance check
        # (only parts with load below the average admit new vertices).
        order = np.argsort(load)
        progressed = False
        for p in order:
            if load[p] >= cap:
                continue
            hp = heaps[p]
            gm = gain_maps[p]
            v = -1
            while hp:
                negg, cand = heapq.heappop(hp)
                if assign[cand] != -1:
                    gm.pop(cand, None)
                    continue
                if gm.get(cand, 0.0) != -negg:  # stale heap entry
                    continue
                v = cand
                break
            if v == -1:
                # Empty frontier: start a new region at the heaviest
                # unassigned vertex.
                v = _next_unassigned()
                if v == -1:
                    break
            _absorb(v, int(p))
            unassigned -= 1
            progressed = True
            if unassigned == 0:
                break
        if not progressed:
            # All parts at capacity but vertices remain — relax the cap.
            cap *= 1.0 + balance_slack
    history = [cut_traffic(g, assign)]

    best = assign.copy()
    best_cut = history[0]
    for _ in range(itermax):
        moved = _refine_sweep(g, assign, n, cap, swap_moves=swap_moves)
        cur = cut_traffic(g, assign)
        history.append(cur)
        if cur < best_cut:
            best_cut, best = cur, assign.copy()
        if moved == 0:
            break
    return _result(g, best, n, tuple(history), "greedy")


def _refine_sweep(
    g: CommGraph,
    assign: np.ndarray,
    n_parts: int,
    cap: float,
    *,
    swap_moves: bool = True,
) -> int:
    """One FM-style boundary sweep: move vertices to their best part when it
    reduces cut traffic and respects the balance cap.  Mutates ``assign``;
    returns the number of moves applied.

    The vectorized sweep only records each vertex's argmax-gain part; when
    that part is cap-blocked (or the independent-set restriction leaves
    nothing to do) the exact sequential sweep takes over, which also picks
    up second-best feasible parts — matching the pre-vectorization
    behavior."""
    et = g.edge_traffic()
    moved = refine_sweep_csr(
        g.indptr, g.indices, et, g.weights, assign, n_parts, cap
    )
    if moved == 0:
        moved = refine_sweep_csr_seq(
            g.indptr, g.indices, et, g.weights, assign, n_parts, cap
        )
    if moved == 0 and swap_moves:
        # Single moves are exhausted (often because any move would break
        # balance); balanced pair-swaps can still escape — e.g. planted
        # size-2 communities with two vertices transposed.
        moved = swap_sweep_csr_seq(
            g.indptr, g.indices, et, g.weights, assign, n_parts, cap
        )
    return moved


def refine_sweep_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    et: np.ndarray,
    w: np.ndarray,
    assign: np.ndarray,
    n_parts: int,
    cap: float,
) -> int:
    """Vectorized boundary-KL/FM sweep on a CSR traffic graph.

    ``et`` holds the per-edge traffic aligned with ``indices`` (both
    directions stored, as in :meth:`CommGraph.edge_traffic`).  Gains are
    computed for every boundary vertex at once with segmented reductions;
    moves are then applied in descending-gain order on an *independent
    set* (a vertex is skipped if any neighbor already moved this sweep),
    so every applied gain stays exact against the snapshot and the cut is
    strictly non-increasing.  Mutates ``assign``; returns moves applied.
    """
    m = indptr.shape[0] - 1
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    nbr_part = assign[indices]
    if not np.any(nbr_part != assign[rows]):
        return 0
    load = np.bincount(assign, weights=w, minlength=n_parts)
    # Affinity of every vertex to every adjacent part: segmented sum of
    # edge traffic keyed by (vertex, neighbor part).
    key = rows * n_parts + nbr_part
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    aff = np.add.reduceat(et[order], starts)
    v_of = ks[starts] // n_parts
    p_of = ks[starts] % n_parts
    own = p_of == assign[v_of]
    cur_aff = np.zeros(m)
    cur_aff[v_of[own]] = aff[own]
    # Best external part per vertex: segmented max over the non-own rows.
    ext = ~own
    if not ext.any():
        return 0
    v_ext, p_ext = v_of[ext], p_of[ext]
    gain_ext = aff[ext] - cur_aff[v_ext]
    best = np.lexsort((gain_ext, v_ext))
    v_sorted = v_ext[best]
    last = np.flatnonzero(np.r_[v_sorted[1:] != v_sorted[:-1], True])
    cand_v = v_sorted[last]
    cand_p = p_ext[best][last]
    cand_gain = gain_ext[best][last]
    pos = cand_gain > 1e-12
    if not pos.any():
        return 0
    cand_v, cand_p, cand_gain = cand_v[pos], cand_p[pos], cand_gain[pos]
    sel = np.argsort(-cand_gain, kind="stable")
    moved_mask = np.zeros(m, dtype=bool)
    moves = 0
    for v, p in zip(cand_v[sel].tolist(), cand_p[sel].tolist()):
        if load[p] + w[v] > cap:
            continue
        lo, hi = indptr[v], indptr[v + 1]
        if moved_mask[indices[lo:hi]].any():
            continue  # a neighbor moved — this gain is stale, retry next sweep
        load[assign[v]] -= w[v]
        load[p] += w[v]
        assign[v] = p
        moved_mask[v] = True
        moves += 1
    return moves


def refine_sweep_csr_seq(
    indptr: np.ndarray,
    indices: np.ndarray,
    et: np.ndarray,
    w: np.ndarray,
    assign: np.ndarray,
    n_parts: int,
    cap: float,
) -> int:
    """Sequential exact boundary sweep (the classic FM inner loop).

    Unlike :func:`refine_sweep_csr`, each boundary vertex re-evaluates
    its gain against the *current* assignment, so chains of adjacent
    moves can cascade — this escapes the local optima the independent-set
    sweep converges to.  O(boundary·degree) Python-level work: use it as
    a finishing pass after the vectorized sweeps go quiet, not as the
    main engine.  Mutates ``assign``; returns moves applied.
    """
    m = indptr.shape[0] - 1
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    load = np.bincount(assign, weights=w, minlength=n_parts)
    boundary = np.unique(rows[assign[rows] != assign[indices]])
    moved = 0
    for v in boundary.tolist():
        lo, hi = indptr[v], indptr[v + 1]
        cur = assign[v]
        aff: dict[int, float] = {}
        for p, t in zip(assign[indices[lo:hi]].tolist(), et[lo:hi].tolist()):
            aff[p] = aff.get(p, 0.0) + t
        cur_aff = aff.get(cur, 0.0)
        best_p, best_gain = cur, 1e-12
        for p, a in aff.items():
            if p == cur or load[p] + w[v] > cap:
                continue
            if a - cur_aff > best_gain:
                best_gain, best_p = a - cur_aff, p
        if best_p != cur:
            load[cur] -= w[v]
            load[best_p] += w[v]
            assign[v] = best_p
            moved += 1
    return moved


#: Partner candidates examined per (source part, target part) pair in
#: :func:`swap_sweep_csr_seq`.  Truncation only bounds the scan — every
#: applied swap's gain is still verified exactly — so K trades escape
#: coverage for a hard O(boundary · K) sweep cost.
SWAP_CANDIDATES = 8


def swap_sweep_csr_seq(
    indptr: np.ndarray,
    indices: np.ndarray,
    et: np.ndarray,
    w: np.ndarray,
    assign: np.ndarray,
    n_parts: int,
    cap: float,
) -> int:
    """Balanced pair-swap sweep (the KL move the single-vertex sweeps lack).

    A single move out of a full part breaks the balance cap, so planted
    communities whose members got transposed between two parts are a
    fixed point of :func:`refine_sweep_csr`/`_seq` — the classic failure
    on size-2 communities (ROADMAP).  Swapping ``v ∈ p`` with ``u ∈ q``
    keeps both loads within cap whenever ``|w[v] − w[u]|`` fits, and its
    exact cut gain is

        ``(aff_v[q] − aff_v[p]) + (aff_u[p] − aff_u[q]) − 2·t(v, u)``

    (the ``t(v, u)`` edge, if any, is cut before *and* after the swap,
    but both affinity terms would count it as gained).

    For each boundary vertex ``v`` and each adjacent external part ``q``
    the sweep consults two precomputed candidate indexes (vectorized
    segmented reductions — no per-vertex part scan, which made the naive
    version quadratic and unusable at multilevel scale): the top
    :data:`SWAP_CANDIDATES` boundary members of ``q`` by snapshot
    out-gain toward ``p``, and the :data:`SWAP_CANDIDATES` members of
    ``q`` cheapest to evict (lowest internal affinity — the partner a
    scrambled start needs even when it has no edge toward ``p``).  The
    best candidate's gain is evaluated exactly (including the
    ``−2·t(v, u)`` correction and both balance caps) before applying;
    vertices adjacent to an applied swap are skipped for the rest of the
    sweep so every applied gain stays exact against the snapshot and the
    cut is strictly decreasing.  For parts no larger than K the
    candidate set degenerates to *all* members — the exhaustive sweep —
    while large instances stay bounded at O(E log E) preprocessing +
    O(adjacent-part pairs · K) evaluations.

    Requires CSR column indices sorted within each row (what
    :func:`repro_torch.core.graph.build_graph` and the multilevel contraction
    produce — checked, since ``CommGraph.validate()`` does not enforce
    it).  Mutates ``assign``; returns the number of swaps applied.
    """
    m = indptr.shape[0] - 1
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    if indices.size > 1:
        same_row = rows[1:] == rows[:-1]
        if np.any(same_row & (np.diff(indices) <= 0)):
            raise ValueError("CSR indices must be sorted within rows")
    nbr_part = assign[indices]
    boundary = np.unique(rows[assign[rows] != nbr_part])
    if boundary.size == 0:
        return 0
    load = np.bincount(assign, weights=w, minlength=n_parts)
    # Vertex→part affinities from one segmented reduction (snapshot).
    key = rows * n_parts + nbr_part
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    aff_val = np.add.reduceat(et[order], starts)
    aff_v = ks[starts] // n_parts
    aff_p = ks[starts] % n_parts
    # Per-vertex slices into the (aff_v, aff_p, aff_val) arrays.
    vptr = np.searchsorted(aff_v, np.arange(m + 1))
    own_aff = np.zeros(m)
    own_sel = aff_p == assign[aff_v]
    own_aff[aff_v[own_sel]] = aff_val[own_sel]

    def aff(v: int, p: int) -> float:
        lo, hi = vptr[v], vptr[v + 1]
        i = lo + np.searchsorted(aff_p[lo:hi], p)
        return float(aff_val[i]) if i < hi and aff_p[i] == p else 0.0

    def edge(v: int, u: int) -> float:
        lo, hi = indptr[v], indptr[v + 1]
        i = lo + np.searchsorted(indices[lo:hi], u)
        return float(et[i]) if i < hi and indices[i] == u else 0.0

    # Candidate index: for every ordered part pair (q → p), the top-K
    # boundary vertices u ∈ q by snapshot out-gain aff_u(p) − aff_u(q).
    is_boundary = np.zeros(m, dtype=bool)
    is_boundary[boundary] = True
    ext = is_boundary[aff_v] & ~own_sel
    u_e = aff_v[ext]
    pair_e = assign[u_e] * n_parts + aff_p[ext]
    gain_e = aff_val[ext] - own_aff[u_e]
    order2 = np.lexsort((-gain_e, pair_e))
    pair_sorted = pair_e[order2]
    cand_u = u_e[order2]
    gstart = np.flatnonzero(np.r_[True, pair_sorted[1:] != pair_sorted[:-1]])
    pair_ids = pair_sorted[gstart]
    gend = np.r_[gstart[1:], pair_sorted.size]

    # Eviction index: per part, the K members cheapest to give up
    # (lowest internal affinity) — partners worth taking even when they
    # have no affinity toward the vertex's own part.
    evict_order = np.lexsort((own_aff, assign))
    evict_part = assign[evict_order]
    estart = np.searchsorted(evict_part, np.arange(n_parts + 1))

    def _candidates(q: int, p: int) -> list[int]:
        out = evict_order[estart[q] : min(estart[q] + SWAP_CANDIDATES, estart[q + 1])].tolist()
        gi = int(np.searchsorted(pair_ids, q * n_parts + p))
        if gi < pair_ids.size and pair_ids[gi] == q * n_parts + p:
            sl = slice(
                int(gstart[gi]), min(int(gstart[gi]) + SWAP_CANDIDATES, int(gend[gi]))
            )
            out += cand_u[sl].tolist()
        return out

    dirty = np.zeros(m, dtype=bool)
    swaps = 0
    for v in boundary.tolist():
        if dirty[v]:
            continue
        p = int(assign[v])
        lo, hi = vptr[v], vptr[v + 1]
        cand_parts = aff_p[lo:hi][np.argsort(-aff_val[lo:hi], kind="stable")]
        best = (1e-12, -1, -1)  # (gain, u, q)
        for q in cand_parts.tolist():
            if q == p:
                continue
            gain_v = aff(v, q) - own_aff[v]
            for u in _candidates(q, p):
                if u == v or dirty[u] or assign[u] != q:
                    continue
                if load[p] - w[v] + w[u] > cap or load[q] - w[u] + w[v] > cap:
                    continue
                gain = gain_v + aff(u, p) - aff(u, q) - 2.0 * edge(v, u)
                if gain > best[0]:
                    best = (gain, u, q)
        _, u, q = best
        if u >= 0:
            load[p] += w[u] - w[v]
            load[q] += w[v] - w[u]
            assign[v], assign[u] = q, p
            # snapshot gains of neighbors (and the pair) are now stale
            dirty[v] = dirty[u] = True
            dirty[indices[indptr[v] : indptr[v + 1]]] = True
            dirty[indices[indptr[u] : indptr[u + 1]]] = True
            swaps += 1
    return swaps


def rebalance_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    et: np.ndarray,
    w: np.ndarray,
    assign: np.ndarray,
    n_parts: int,
    cap: float,
) -> int:
    """Shed load from parts above ``cap`` with minimal cut increase.

    For every overloaded part, its vertices are evicted in ascending
    order of cut penalty (current internal affinity minus affinity to
    the receiving part) until the part fits under ``cap``.  The receiver
    is the highest-affinity adjacent part with room, falling back to the
    least-loaded part.  Vertices that fit nowhere stay put.  Mutates
    ``assign``; returns the number of moves.
    """
    m = indptr.shape[0] - 1
    load = np.bincount(assign, weights=w, minlength=n_parts)
    over = np.flatnonzero(load > cap * (1 + 1e-12))
    if over.size == 0:
        return 0
    # Internal affinity of every vertex (traffic to its own part).
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    own_edge = assign[rows] == assign[indices]
    cur_aff = np.bincount(rows[own_edge], weights=et[own_edge], minlength=m)
    moves = 0
    for p in over.tolist():
        members = np.flatnonzero(assign == p)
        for v in members[np.argsort(cur_aff[members], kind="stable")].tolist():
            if load[p] <= cap:
                break
            lo, hi = indptr[v], indptr[v + 1]
            aff: dict[int, float] = {}
            for q, t in zip(assign[indices[lo:hi]].tolist(), et[lo:hi].tolist()):
                if q != p:
                    aff[q] = aff.get(q, 0.0) + t
            best_q, best_aff = -1, -1.0
            for q, a in aff.items():
                if load[q] + w[v] <= cap and a > best_aff:
                    best_aff, best_q = a, q
            if best_q == -1:
                q = int(np.argmin(load))
                if q == p or load[q] + w[v] > cap:
                    continue
                best_q = q
            load[p] -= w[v]
            load[best_q] += w[v]
            assign[v] = best_q
            moves += 1
    return moves


def refine_partition(
    g: CommGraph,
    result: PartitionResult,
    *,
    sweeps: int = 4,
    balance_slack: float = 0.05,
) -> PartitionResult:
    """Run extra refinement sweeps on an existing partition.

    The returned cut is never worse than ``result.cut`` — the best
    assignment seen (including the input) is kept.
    """
    assign = result.assign.copy()
    cap = g.weights.sum() / result.n_parts * (1.0 + balance_slack)
    history = list(result.history)
    best, best_cut = result.assign, result.cut
    for _ in range(sweeps):
        if _refine_sweep(g, assign, result.n_parts, cap) == 0:
            break
        cur = cut_traffic(g, assign)
        history.append(cur)
        if cur < best_cut:
            best_cut, best = cur, assign.copy()
    return _result(g, best, result.n_parts, tuple(history), result.method)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def random_partition(
    g: CommGraph, n_parts: int, *, seed: int = 0, balanced: bool = False
) -> PartitionResult:
    """Random neuron→GPU mapping — the baseline used by state-of-the-art
    simulators per the paper (§II).  ``balanced=True`` round-robins a random
    permutation instead (equal counts, still traffic-oblivious)."""
    rng = np.random.default_rng(seed)
    m = g.num_vertices
    if balanced:
        perm = rng.permutation(m)
        assign = np.empty(m, dtype=np.int64)
        assign[perm] = np.arange(m) % n_parts
    else:
        assign = rng.integers(0, n_parts, size=m)
    return _result(g, assign, n_parts, (), "random")


def _fitness(
    g: CommGraph, assign: np.ndarray, n_parts: int, lam: float
) -> float:
    return cut_traffic(g, assign) * (1.0 + lam * imbalance(g, assign, n_parts))


def _repair_empty_parts(
    g: CommGraph, assign: np.ndarray, n_parts: int
) -> np.ndarray:
    """Make every part non-empty with minimum-cut-increase donor moves.

    Random-reset mutation and uniform crossover can leave GA chromosomes
    with empty parts (the fitness only *penalizes* imbalance, it does not
    forbid it), and an empty group later breaks Algorithm-2's
    ``RoutingTable.validate()`` — an empty group has no member to serve
    as bridge.  For each empty part the heaviest-loaded donor part
    (ties: lowest part index) gives up its vertex with the least
    affinity to the donor's other members.  Mutates and returns
    ``assign``.
    """
    rows = g.rows()
    et = g.edge_traffic()
    counts = np.bincount(assign, minlength=n_parts)
    for p in np.flatnonzero(counts == 0).tolist():
        load = np.bincount(assign, weights=g.weights, minlength=n_parts)
        load[counts <= 1] = -np.inf  # a donor must keep ≥ 1 vertex
        donor = int(np.argmax(load))
        members = np.flatnonzero(assign == donor)
        own_edge = (assign[rows] == donor) & (assign[g.indices] == donor)
        internal = np.bincount(
            rows[own_edge], weights=et[own_edge], minlength=g.num_vertices
        )
        v = int(members[np.argmin(internal[members])])
        assign[v] = p
        counts[donor] -= 1
        counts[p] += 1
    return assign


def genetic_partition(
    g: CommGraph,
    n_parts: int,
    *,
    pop_size: int = 24,
    generations: int = 40,
    mutation_rate: float = 0.02,
    lam: float = 2.0,
    seed: int = 0,
) -> PartitionResult:
    """Genetic-algorithm baseline (paper §II / Fig. 3 'GA' lines).

    Chromosome = assignment vector; fitness = cut·(1 + λ·imbalance);
    tournament selection, uniform crossover, random-reset mutation.
    The paper found this class of methods achieves partial balance but
    little latency gain — our benchmarks reproduce that gap.
    """
    rng = np.random.default_rng(seed)
    m = g.num_vertices
    pop = [rng.integers(0, n_parts, size=m) for _ in range(pop_size)]
    fits = np.array([_fitness(g, a, n_parts, lam) for a in pop])
    history = [float(fits.min())]
    for _ in range(generations):
        new_pop = []
        # Elitism: keep the two best.
        elite = np.argsort(fits)[:2]
        new_pop.extend(pop[i].copy() for i in elite)
        while len(new_pop) < pop_size:
            # Tournament selection.
            a, b = rng.integers(0, pop_size, 2)
            pa = pop[a] if fits[a] < fits[b] else pop[b]
            c, d = rng.integers(0, pop_size, 2)
            pb = pop[c] if fits[c] < fits[d] else pop[d]
            mask = rng.random(m) < 0.5
            child = np.where(mask, pa, pb)
            mut = rng.random(m) < mutation_rate
            child[mut] = rng.integers(0, n_parts, size=int(mut.sum()))
            new_pop.append(child)
        pop = new_pop
        fits = np.array([_fitness(g, a, n_parts, lam) for a in pop])
        history.append(float(fits.min()))
    best = pop[int(np.argmin(fits))]
    if n_parts <= m:
        # GA chromosomes may leave parts empty; downstream consumers
        # (Algorithm-2 bridge selection) need every part inhabited.
        best = _repair_empty_parts(g, best, n_parts)
    return _result(g, best, n_parts, tuple(history), "genetic")


def simulated_annealing_partition(
    g: CommGraph,
    n_parts: int,
    *,
    steps: int = 4000,
    t0: float = 1.0,
    alpha: float = 0.999,
    lam: float = 2.0,
    seed: int = 0,
) -> PartitionResult:
    """Simulated-annealing baseline (paper §II).  Single-vertex reassignment
    moves with Metropolis acceptance on the same penalized objective."""
    rng = np.random.default_rng(seed)
    m = g.num_vertices
    assign = random_partition(g, n_parts, seed=seed, balanced=True).assign.copy()
    cur = _fitness(g, assign, n_parts, lam)
    best, best_fit = assign.copy(), cur
    temp = t0 * max(cur, 1e-12)
    history = [cur]
    for step in range(steps):
        v = int(rng.integers(0, m))
        p_new = int(rng.integers(0, n_parts))
        p_old = int(assign[v])
        if p_new == p_old:
            continue
        assign[v] = p_new
        cand = _fitness(g, assign, n_parts, lam)
        if cand <= cur or rng.random() < np.exp(-(cand - cur) / max(temp, 1e-30)):
            cur = cand
            if cur < best_fit:
                best_fit, best = cur, assign.copy()
        else:
            assign[v] = p_old
        temp *= alpha
        if step % 500 == 0:
            history.append(cur)
    return _result(g, best, n_parts, tuple(history), "annealing")
