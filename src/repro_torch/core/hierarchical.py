"""Two-level (hierarchical) collective schedules and their dispatch
accounting — the port of the reference's ``repro.core.hierarchical``.

The paper forwards cross-group traffic through per-group bridge devices,
collapsing ``O(N²)`` logical flows into ``O(G²)`` aggregated flows.  On a
mesh whose slow axis runs across groups, the bridge pattern becomes a
*decomposed collective*:

* :func:`two_level_all_to_all` — an all-to-all inside the group (level-1,
  fast axis) followed by ONE aggregated counterpart-to-counterpart
  exchange across groups (level-2): cross-group messages drop from
  ``inner²·pods·(pods-1)`` to ``inner·pods·(pods-1)`` while cross-group
  bytes stay equal;
* :func:`hierarchical_psum` — reduce-scatter inside the group, an
  all-reduce across groups on the ``1/inner``-sized shard, all-gather
  inside the group;
* :func:`two_level_all_gather`, and the flat baselines
  :func:`flat_all_to_all` and :func:`flat_psum`.

Each takes a communicator (:mod:`repro_torch.snn.comm`) where the
reference takes mesh axis names inside ``shard_map``: tensors are stacked
over the ranks the communicator holds, ``[len(comm.ranks), ...]`` — the
whole mesh behind a ``LoopbackComm``, one rank behind a
``ProcessGroupComm``.  Each schedule gives exactly its flat counterpart's
result on integer-valued inputs.

The numpy half keeps the analytic message and byte counts of the bridge
pattern for a uniform ``pods × inner`` mesh (:func:`dispatch_bytes`,
:func:`dispatch_messages`), the wire-level ``(src, dst, nbytes)`` rounds
that :mod:`repro_torch.netsim` replays (:func:`dispatch_rounds`), and the
counts measured on an Algorithm-2 routing table
(:func:`dispatch_messages_from_table`).
"""
from __future__ import annotations

__all__ = [
    "flat_all_to_all",
    "two_level_all_to_all",
    "flat_psum",
    "hierarchical_psum",
    "two_level_all_gather",
    "make_exchange_fns",
    "dispatch_bytes",
    "dispatch_messages",
    "dispatch_messages_from_table",
    "dispatch_rounds",
]


# ---------------------------------------------------------------------------
# All-to-all (MoE dispatch / spike exchange)
# ---------------------------------------------------------------------------


def flat_all_to_all(x, comm):
    """Direct peer-to-peer exchange over the joint mesh axes (baseline).

    ``x`` per rank: ``[n_devices, chunk, ...]`` — row ``d`` is the block
    destined to rank ``d``.  Returns the same shape where row ``d`` is the
    block *received from* rank ``d``.
    """
    return comm.all_to_all(x, "joint")


def two_level_all_to_all(x, comm):
    """The paper's two-level routing as a decomposed all-to-all.

    ``x`` per rank: ``[pods, inner, chunk, ...]`` — block ``[p', i']`` is
    destined to rank ``(p', i')``.  Result: ``[pods, inner, chunk, ...]``
    where block ``[p, i]`` was *sent by* rank ``(p, i)``.

    Level-1 (inside the group): all-to-all over ``"inner"`` on the
    destination inner index, so each rank aggregates everything its group
    sends to its own counterpart slot in every group — each rank is the
    *bridge* for its slot, the balanced-bridge selection of Algorithm 2.
    Level-2 (across groups): all-to-all over ``"slow"`` on the destination
    group — one aggregated message per (rank, remote group).
    """
    # Phase 1 — level-1 routing: exchange on dst-inner (dim 2 of the stack).
    x = comm.all_to_all(x.transpose(1, 2).contiguous(), "inner").transpose(1, 2)
    # Phase 2 — level-2 routing: aggregated exchange on dst-pod (dim 1).
    return comm.all_to_all(x.contiguous(), "slow")


def two_level_all_gather(x, comm):
    """All-gather decomposed as gather-inner → gather-slow (bridge pattern):
    ``x [n, L, ...]`` → ``[n, n_devices·L, ...]`` in global rank order."""
    return comm.all_gather(comm.all_gather(x, "inner"), "slow")


# ---------------------------------------------------------------------------
# All-reduce (gradient reduction)
# ---------------------------------------------------------------------------


def flat_psum(x, comm):
    """Flat all-reduce over the joint mesh axes (baseline)."""
    return comm.psum(x, "joint")


def hierarchical_psum(x, comm):
    """Hierarchical all-reduce: RS(inner) → AR(slow) → AG(inner).

    Requires ``x.shape[1] % inner == 0`` (the first dim of each rank's
    block; pad upstream if needed).
    """
    scattered = comm.psum_scatter(x, "inner")
    reduced = comm.psum(scattered, "slow")
    return comm.all_gather(reduced, "inner")


def make_exchange_fns(comm):
    """Build the (flat, two_level) exchange functions over ``comm``'s mesh.

    Each takes and returns ``[len(comm.ranks), n_dev, chunk, ...]``: row
    ``d`` of a rank's block is its send buffer for rank ``d``, row ``d``
    of the result what it received from rank ``d`` (behind a
    ``LoopbackComm`` the whole global array).
    """

    def _flat(x):
        return flat_all_to_all(x, comm)

    def _two_level(x):
        blk = x.reshape(x.shape[0], comm.g, comm.r, *x.shape[2:])
        return two_level_all_to_all(blk, comm).reshape(x.shape)

    return _flat, _two_level


# ---------------------------------------------------------------------------
# Analytic message/byte accounting (used by benchmarks + EXPERIMENTS.md)
# ---------------------------------------------------------------------------


def dispatch_bytes(
    n_pods: int, n_inner: int, chunk_bytes: int, *, two_level: bool
) -> dict[str, float]:
    """Bytes crossing each boundary for one full exchange.

    Per device, every destination device receives ``chunk_bytes``.
    Intra-pod links carry level-1; the pod boundary carries level-2.
    """
    n_dev = n_pods * n_inner
    per_dev_total = n_dev * chunk_bytes
    cross_pod_frac = (n_pods - 1) / n_pods if n_pods > 1 else 0.0
    cross_pod = per_dev_total * cross_pod_frac * n_dev  # system-wide
    if not two_level:
        intra = per_dev_total * (1 - cross_pod_frac) * n_dev
        return {"intra_pod": intra, "cross_pod": cross_pod}
    # level-1 moves remote-destined data once inside the source pod too
    intra = per_dev_total * n_dev  # all data crosses an intra-pod link once
    return {"intra_pod": intra, "cross_pod": cross_pod}


def dispatch_messages(
    n_pods: int, n_inner: int, *, two_level: bool
) -> dict[str, int]:
    """Logical cross-pod message count (the paper's connection count)."""
    if n_pods <= 1:
        return {"cross_pod": 0, "intra_pod": n_inner * (n_inner - 1)}
    if two_level:
        cross = n_pods * (n_pods - 1) * n_inner  # counterpart pairs only
    else:
        cross = n_pods * (n_pods - 1) * n_inner * n_inner  # every pair
    return {
        "cross_pod": cross,
        "intra_pod": n_pods * n_inner * (n_inner - 1),
    }


def dispatch_rounds(
    n_pods: int, n_inner: int, chunk_bytes: int, *, two_level: bool
) -> list[list[tuple[int, int, int]]]:
    """Wire-level ``(src, dst, nbytes)`` triples per phase of the
    all-to-all — the replay input for :mod:`repro_torch.netsim`.

    Devices are row-major over ``(pod, inner)``.  ``two_level=False``
    is one phase of direct P2P chunks (``n·(n-1)`` messages of
    ``chunk_bytes``).  ``two_level=True`` mirrors
    :func:`two_level_all_to_all`: phase 1 exchanges pod-aggregated
    slabs of ``n_pods · chunk_bytes`` between same-pod peers, phase 2
    moves one ``n_inner · chunk_bytes`` slab per (device, remote-pod
    counterpart) across the pod boundary.  Message counts match
    :func:`dispatch_messages` and cross-pod bytes match
    :func:`dispatch_bytes` by construction.
    """
    n_dev = n_pods * n_inner
    if not two_level:
        return [
            [
                (s, d, chunk_bytes)
                for s in range(n_dev)
                for d in range(n_dev)
                if s != d
            ]
        ]
    phase1 = [
        (p * n_inner + i, p * n_inner + j, n_pods * chunk_bytes)
        for p in range(n_pods)
        for i in range(n_inner)
        for j in range(n_inner)
        if i != j
    ]
    phase2 = [
        (p * n_inner + i, q * n_inner + i, n_inner * chunk_bytes)
        for p in range(n_pods)
        for q in range(n_pods)
        for i in range(n_inner)
        if p != q
    ]
    return [phase1, phase2]


def dispatch_messages_from_table(tb, *, threshold: float = 0.0) -> dict[str, int]:
    """*Measured* counterpart of :func:`dispatch_messages`.

    Where :func:`dispatch_messages` counts messages for a uniform
    ``pods × inner`` mesh analytically, this derives the level-1 / level-2
    logical message counts implied by an actual Algorithm-2
    :class:`~repro_torch.core.routing.RoutingTable` (sparse or dense):

      * ``level1`` — direct same-group connections plus forwarder→bridge
        hops (the fast intra-pod / intra-group links);
      * ``level2`` — the aggregated bridge connections crossing the group
        boundary (the slow cross-pod links).

    For a P2P table every connection is level-2 (each flow leaves the
    device individually), matching the flat all-to-all accounting.
    """
    from repro_torch.core.routing import connection_components

    direct, forward, aggregated = connection_components(tb, threshold=threshold)
    if tb.method == "p2p":
        return {"level1": 0, "level2": int(direct.sum())}
    return {
        "level1": int(direct.sum() + forward.sum()),
        "level2": int(aggregated.sum()),
    }
