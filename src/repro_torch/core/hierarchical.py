"""Two-level (hierarchical) dispatch accounting — the numpy half of the
reference's ``repro.core.hierarchical``.

The paper forwards cross-group traffic through per-group bridge devices,
collapsing ``O(N²)`` logical flows into ``O(G²)`` aggregated flows.  This
module keeps the analytic message and byte counts of that bridge pattern
for a uniform ``pods × inner`` mesh (:func:`dispatch_bytes`,
:func:`dispatch_messages`), the wire-level ``(src, dst, nbytes)`` rounds
that :mod:`repro_torch.netsim` replays (:func:`dispatch_rounds`), and the
counts measured on an Algorithm-2 routing table
(:func:`dispatch_messages_from_table`).

The reference module's collective half — ``flat_all_to_all``,
``two_level_all_to_all``, ``two_level_all_gather``, ``flat_psum``,
``hierarchical_psum`` and ``make_exchange_fns`` — is ``jax.lax``
collectives inside ``shard_map``; its port to the torch communicator is
ROADMAP M6 and not here yet.
"""
from __future__ import annotations

__all__ = [
    "dispatch_bytes",
    "dispatch_messages",
    "dispatch_messages_from_table",
    "dispatch_rounds",
]


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
