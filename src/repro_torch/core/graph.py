"""Sparse weighted communication graphs.

The paper's inputs are a connection-probability matrix ``P[M, M]`` and a
per-vertex traffic weight ``W[M]``.  At brain scale (``M ~ 1e10``) a dense
``P`` is not materializable, so — like the paper's own implementation, which
partitions a population-level model generated from a structural scan — we
carry the graph in CSR form over *populations* and define

    edge_traffic(i, j) = P[i, j] * W[i] * W[j]

which is exactly the quantity the paper's objective sums over cut edges.

Everything downstream (Algorithm 1 partitioning, Algorithm 2 routing, the
analytic latency model, and the distributed SNN engine's exchange schedule)
consumes this structure.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterable

import numpy as np

__all__ = [
    "CommGraph",
    "build_graph",
    "from_dense",
    "symmetrize",
    "watts_strogatz_graph",
    "planted_partition_graph",
]


@dataclasses.dataclass(frozen=True)
class CommGraph:
    """CSR communication graph with per-vertex weights.

    Attributes:
      indptr:  ``int64[M + 1]`` CSR row pointers.
      indices: ``int64[nnz]`` CSR column indices.
      probs:   ``float64[nnz]`` connection probabilities ``P[i, j]``.
      weights: ``float64[M]`` per-vertex traffic weights ``W[i]``.
    """

    indptr: np.ndarray
    indices: np.ndarray
    probs: np.ndarray
    weights: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.weights.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def neighbors(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        """Return (neighbor indices, connection probs) of vertex ``v``."""
        lo, hi = self.indptr[v], self.indptr[v + 1]
        return self.indices[lo:hi], self.probs[lo:hi]

    def edge_traffic(self) -> np.ndarray:
        """Per-edge traffic ``P[i, j] * W[i] * W[j]`` aligned with ``indices``."""
        rows = np.repeat(
            np.arange(self.num_vertices, dtype=np.int64), np.diff(self.indptr)
        )
        return self.probs * self.weights[rows] * self.weights[self.indices]

    def rows(self) -> np.ndarray:
        """CSR row index for every stored edge."""
        return np.repeat(
            np.arange(self.num_vertices, dtype=np.int64), np.diff(self.indptr)
        )

    def total_traffic(self) -> float:
        return float(self.edge_traffic().sum())

    def validate(self) -> None:
        # delegated to the planlint rule registry (rule PL001) so
        # construction-time checks and `python -m repro.analysis` agree
        from repro_torch.analysis import invariants

        invariants.check_comm_graph(self)


def build_graph(
    src: Iterable[int],
    dst: Iterable[int],
    probs: Iterable[float],
    weights: np.ndarray,
    *,
    sym: bool = True,
) -> CommGraph:
    """Build a :class:`CommGraph` from COO edges.

    Duplicate edges are merged by taking the max probability.  When ``sym``
    the graph is symmetrized (traffic between neurons is bidirectional spike
    flow; the paper's objective treats the pair once).
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    probs = np.asarray(probs, dtype=np.float64)
    weights = np.asarray(weights, dtype=np.float64)
    m = weights.shape[0]
    if sym:
        src, dst, probs = (
            np.concatenate([src, dst]),
            np.concatenate([dst, src]),
            np.concatenate([probs, probs]),
        )
    # Drop self-loops: a neuron talking to itself is free.
    keep = src != dst
    src, dst, probs = src[keep], dst[keep], probs[keep]
    # Merge duplicates (max prob).
    key = src * m + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, probs = key[order], src[order], dst[order], probs[order]
    uniq, start = np.unique(key, return_index=True)
    merged_p = np.maximum.reduceat(probs, start) if key.size else probs
    src = src[start]
    dst = dst[start]
    counts = np.bincount(src, minlength=m)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    g = CommGraph(indptr=indptr, indices=dst, probs=merged_p, weights=weights)
    g.validate()
    return g


def from_dense(p: np.ndarray, weights: np.ndarray) -> CommGraph:
    """Build from a dense probability matrix ``P[M, M]`` (small M only)."""
    p = np.asarray(p, dtype=np.float64)
    m = p.shape[0]
    if p.shape != (m, m):
        raise ValueError("P must be square")
    src, dst = np.nonzero(p)
    return build_graph(src, dst, p[src, dst], weights, sym=False)


def symmetrize(g: CommGraph) -> CommGraph:
    """Return a symmetrized copy of ``g`` (max of the two directions)."""
    rows = g.rows()
    return build_graph(rows, g.indices, g.probs, g.weights, sym=True)


def induced_subgraph(g: CommGraph, vertices: np.ndarray) -> tuple[CommGraph, np.ndarray]:
    """Subgraph induced by ``vertices``, with ids remapped to ``[0, len)``.

    The workhorse of the out-of-core planner
    (:func:`repro.core.outofcore.plan_out_of_core`): each pod's local
    partition problem is the subgraph of its own populations, extracted
    in O(deg(vertices)) without touching the rest of the graph.  Edges
    with either endpoint outside ``vertices`` are dropped (they are
    accounted at the coarser level as cross-pod traffic).

    Returns ``(sub, vertices)`` where ``sub.weights[i]`` belongs to
    global vertex ``vertices[i]`` (``vertices`` is deduplicated and
    sorted, so the mapping is monotone).
    """
    vertices = np.unique(np.asarray(vertices, dtype=np.int64))
    if vertices.size and (vertices[0] < 0 or vertices[-1] >= g.num_vertices):
        raise ValueError("vertices outside [0, num_vertices)")
    local = np.full(g.num_vertices, -1, dtype=np.int64)
    local[vertices] = np.arange(vertices.size, dtype=np.int64)
    rows = g.rows()
    keep = (local[rows] >= 0) & (local[g.indices] >= 0)
    src = local[rows[keep]]
    dst = local[g.indices[keep]]
    # CSR order survives the monotone remap: rows stay nondecreasing and
    # per-row columns stay sorted, so the CSR can be assembled directly.
    indptr = np.zeros(vertices.size + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=vertices.size), out=indptr[1:])
    sub = CommGraph(
        indptr=indptr,
        indices=dst,
        probs=g.probs[keep],
        weights=g.weights[vertices],
    )
    sub.validate()
    return sub, vertices


# ---------------------------------------------------------------------------
# Sparse test/benchmark graph families (fully vectorized COO construction,
# usable at M >= 100k — no Python per-edge loops)
# ---------------------------------------------------------------------------


def watts_strogatz_graph(
    m: int, k: int = 8, beta: float = 0.1, *, seed: int = 0
) -> CommGraph:
    """Watts–Strogatz small-world graph as a :class:`CommGraph`.

    Ring lattice of ``m`` vertices each wired to its ``k`` nearest
    neighbors (``k`` even), with every edge rewired to a random endpoint
    with probability ``beta``.  Edge probs and vertex weights are drawn
    uniformly so traffic is non-degenerate.
    """
    if k % 2 or k <= 0:
        raise ValueError("k must be positive and even")
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(m, dtype=np.int64), k // 2)
    offs = np.tile(np.arange(1, k // 2 + 1, dtype=np.int64), m)
    dst = (src + offs) % m
    rewire = rng.random(dst.shape[0]) < beta
    dst = np.where(rewire, rng.integers(0, m, dst.shape[0]), dst)
    probs = rng.uniform(0.1, 1.0, dst.shape[0])
    weights = rng.uniform(0.5, 2.0, m)
    return build_graph(src, dst, probs, weights)


def planted_partition_graph(
    m: int,
    n_blocks: int = 8,
    *,
    avg_degree: float = 16.0,
    p_in_frac: float = 0.8,
    seed: int = 0,
) -> tuple[CommGraph, np.ndarray]:
    """Planted-partition (stochastic block) graph + ground-truth labels.

    Samples ``m * avg_degree / 2`` undirected edges; a ``p_in_frac``
    fraction is drawn inside blocks (both endpoints in the same block),
    the rest between uniformly random endpoints, yielding strong
    community structure at any scale without materializing ``P[M, M]``.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_blocks, m)
    n_edges = int(m * avg_degree / 2)
    n_in = int(n_edges * p_in_frac)
    # Intra-block edges: pick a random vertex, then a random peer of the
    # same block via a block-sorted lookup table.
    order = np.argsort(labels, kind="stable")
    block_start = np.searchsorted(labels[order], np.arange(n_blocks))
    block_count = np.bincount(labels, minlength=n_blocks)
    src_in = rng.integers(0, m, n_in)
    b = labels[src_in]
    dst_in = order[block_start[b] + rng.integers(0, np.maximum(block_count[b], 1))]
    src_out = rng.integers(0, m, n_edges - n_in)
    dst_out = rng.integers(0, m, n_edges - n_in)
    src = np.concatenate([src_in, src_out])
    dst = np.concatenate([dst_in, dst_out])
    probs = rng.uniform(0.1, 1.0, src.shape[0])
    weights = rng.uniform(0.5, 2.0, m)
    return build_graph(src, dst, probs, weights), labels
