"""Expert placement — Algorithm 1 applied to MoE expert-parallelism
(DESIGN.md §4.1).

In a mixture-of-experts LM the "neurons" of the paper are the experts:
tokens are routed to ``top_k`` experts per layer, generating all-to-all
dispatch traffic between the devices that hold them.  Standard
implementations place experts contiguously/randomly (the paper's random
neuron→GPU mapping).  We instead build a weighted co-activation graph
from router statistics and run the paper's balance-constrained greedy
partitioner:

* vertex weight ``W[e]``  = expected token load of expert ``e``;
* edge prob  ``P[e, f]``  = probability that a token routed to ``e`` is
  also routed to ``f`` (top-k co-activation) — co-activated experts on
  the same device mean one dispatched token serves several experts
  without extra traffic;
* objective = the paper's cut traffic = expected cross-device dispatch.

Outputs a physical expert permutation so `ep_shard[d]` holds the experts
assigned to device ``d`` — the model code stays oblivious (it always
shards axis 0 of the stacked expert weights); only the ordering changes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CommGraph, build_graph
from repro_torch.core import partition as part_mod

__all__ = [
    "ExpertPlacement",
    "coactivation_graph",
    "place_experts",
    "random_placement",
    "contiguous_placement",
    "dispatch_traffic",
    "placement_permutation",
]


@dataclasses.dataclass(frozen=True)
class ExpertPlacement:
    """Expert→EP-shard assignment plus the physical permutation.

    Attributes:
      assign: ``int64[E]`` expert → shard.
      perm:   ``int64[E]`` permutation such that stacked expert weights
              ``W[perm]`` laid out contiguously and split into equal
              shards realize ``assign``.
      n_shards: EP world size.
      expected_cross: expected fraction of dispatched tokens that cross
              shards under this placement (lower = better).
      method: provenance tag.
    """

    assign: np.ndarray
    perm: np.ndarray
    n_shards: int
    expected_cross: float
    method: str


def coactivation_graph(
    load: np.ndarray, coact: np.ndarray
) -> CommGraph:
    """Build the expert graph from router statistics.

    Args:
      load: ``float[E]`` expected tokens routed to each expert per step.
      coact: ``float[E, E]`` joint routing counts — ``coact[e, f]`` is how
        often a token selects both ``e`` and ``f`` (symmetric, zero diag).
    """
    e = load.shape[0]
    c = np.asarray(coact, dtype=np.float64)
    if c.shape != (e, e):
        raise ValueError("coact must be [E, E]")
    c = (c + c.T) / 2.0
    np.fill_diagonal(c, 0.0)
    src, dst = np.nonzero(c)
    w = np.asarray(load, dtype=np.float64)
    wn = np.where(w > 0, w, 1.0)
    probs = c[src, dst] / np.maximum(wn[src] * wn[dst], 1e-30)
    pmax = probs.max() if probs.size else 1.0
    probs = probs / max(pmax, 1e-30)
    return build_graph(src, dst, probs, wn, sym=False)


def place_experts(
    load: np.ndarray,
    coact: np.ndarray,
    n_shards: int,
    *,
    itermax: int = 8,
    seed: int = 0,
) -> ExpertPlacement:
    """Algorithm 1 on the expert co-activation graph."""
    g = coactivation_graph(load, coact)
    res = part_mod.greedy_partition(g, n_shards, itermax=itermax, seed=seed)
    assign = _equalize_counts(res.assign, g.weights, n_shards)
    return _finalize(assign, load, coact, n_shards, "greedy")


def random_placement(
    n_experts: int, n_shards: int, load: np.ndarray, coact: np.ndarray, *, seed: int = 0
) -> ExpertPlacement:
    """Random balanced placement — the state-of-practice baseline."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_experts)
    assign = np.empty(n_experts, dtype=np.int64)
    assign[perm] = np.arange(n_experts) % n_shards
    return _finalize(assign, load, coact, n_shards, "random")


def contiguous_placement(
    n_experts: int, n_shards: int, load: np.ndarray, coact: np.ndarray
) -> ExpertPlacement:
    """Contiguous block placement — what naive `jnp.split` sharding does."""
    assign = np.arange(n_experts, dtype=np.int64) * n_shards // n_experts
    return _finalize(assign, load, coact, n_shards, "contiguous")


def _equalize_counts(
    assign: np.ndarray, weights: np.ndarray, n_shards: int
) -> np.ndarray:
    """Physical sharding needs *equal expert counts* per shard (stacked
    tensor split).  Rebalance counts by moving the lowest-affinity
    (lightest) experts out of over-full shards into under-full ones."""
    e = assign.shape[0]
    if e % n_shards != 0:
        raise ValueError("n_experts must divide evenly across shards")
    per = e // n_shards
    assign = assign.copy()
    counts = np.bincount(assign, minlength=n_shards)
    over = [s for s in range(n_shards) if counts[s] > per]
    under = [s for s in range(n_shards) if counts[s] < per]
    for s in over:
        members = np.nonzero(assign == s)[0]
        # move lightest experts first: least traffic disruption
        movable = members[np.argsort(weights[members])]
        i = 0
        while counts[s] > per:
            tgt = under[0]
            assign[movable[i]] = tgt
            counts[s] -= 1
            counts[tgt] += 1
            if counts[tgt] == per:
                under.pop(0)
            i += 1
    return assign


def placement_permutation(assign: np.ndarray, n_shards: int) -> np.ndarray:
    """Permutation realizing ``assign`` on a contiguously-split tensor."""
    order = np.argsort(assign, kind="stable")
    return order


def dispatch_traffic(
    load: np.ndarray, coact: np.ndarray, assign: np.ndarray, n_shards: int
) -> float:
    """Expected cross-shard dispatched-token traffic under ``assign``.

    A token routed to experts ``S`` must be sent to every *distinct shard*
    holding a member of ``S``.  With pairwise statistics only we use the
    paper's objective as the surrogate: Σ cut-pair co-activation mass,
    normalized by total co-activation mass (plus the single-expert mass
    that is placement-independent and cancels in comparisons).
    """
    c = np.asarray(coact, dtype=np.float64)
    total = c.sum() / 2.0
    if total <= 0:
        return 0.0
    cut = 0.0
    for s in range(n_shards):
        mask = assign == s
        cut += c[np.ix_(mask, ~mask)].sum()
    return float(cut / 2.0 / total)


def _finalize(
    assign: np.ndarray,
    load: np.ndarray,
    coact: np.ndarray,
    n_shards: int,
    method: str,
) -> ExpertPlacement:
    perm = placement_permutation(assign, n_shards)
    cross = dispatch_traffic(load, coact, assign, n_shards)
    return ExpertPlacement(
        assign=assign.astype(np.int64),
        perm=perm,
        n_shards=n_shards,
        expected_cross=cross,
        method=method,
    )
