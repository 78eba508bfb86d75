"""Structural invariants of the plan-chain artifacts (shared checkers).

One function per artifact, raising ``ValueError`` with the planlint rule
id in the message.  These are the *single* home of the invariant logic:
the artifacts' ``validate()`` methods (:class:`~repro_torch.core.graph.CommGraph`,
:class:`~repro_torch.core.traffic.TrafficMatrix`,
:class:`~repro_torch.core.partition.PartitionResult`,
:class:`~repro_torch.core.routing.RoutingTable`,
:class:`~repro_torch.snn.sparse.BlockSynapses`) delegate here, and the rule
registry in :mod:`repro.analysis.rules` wraps the same functions into
:class:`~repro.analysis.rules.Rule` checks — so construction-time
validation and the batch linter can never disagree.

Everything is duck-typed over numpy attributes (no repro_torch imports) so the
core modules can lazy-import this module from their ``validate()``
bodies without a cycle.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "check_comm_graph",
    "check_traffic_matrix",
    "check_partition",
    "check_block_synapses",
    "check_routing_table",
    "check_bridge_shares",
]


def check_comm_graph(g) -> None:
    """PL001 — CSR communication-graph structure (CommGraph.validate)."""
    m = g.num_vertices
    if g.indptr.shape != (m + 1,):
        raise ValueError("PL001: indptr must have shape (M + 1,)")
    if g.indptr[0] != 0 or g.indptr[-1] != g.num_edges:
        raise ValueError("PL001: indptr must start at 0 and end at nnz")
    if np.any(np.diff(g.indptr) < 0):
        raise ValueError("PL001: indptr must be nondecreasing")
    if g.num_edges and (g.indices.min() < 0 or g.indices.max() >= m):
        raise ValueError("PL001: edge indices out of range")
    if np.any(g.probs < 0) or np.any(g.probs > 1):
        raise ValueError("PL001: probs must lie in [0, 1]")
    if np.any(g.weights < 0):
        raise ValueError("PL001: weights must be nonnegative")


def check_traffic_matrix(tm) -> None:
    """PL002 — device-traffic CSR structure (TrafficMatrix.validate)."""
    n = tm.n_devices
    if tm.indptr[0] != 0 or tm.indptr[-1] != tm.nnz:
        raise ValueError("PL002: indptr must start at 0 and end at nnz")
    if np.any(np.diff(tm.indptr) < 0):
        raise ValueError("PL002: indptr must be nondecreasing")
    if tm.data.shape != tm.indices.shape:
        raise ValueError("PL002: indices and data must have equal length")
    if tm.nnz:
        if tm.indices.min() < 0 or tm.indices.max() >= n:
            raise ValueError("PL002: column indices out of range")
        rows = tm.rows()
        if np.any(rows == tm.indices):
            raise ValueError("PL002: diagonal entries are not allowed")
        # sorted-columns / merged-duplicates: within a row, columns must
        # be strictly increasing (equality = unmerged duplicate,
        # decrease = unsorted) — searchsorted/reduceat consumers
        # silently misread anything else
        same_row = rows[1:] == rows[:-1]
        if np.any(same_row & (np.diff(tm.indices) <= 0)):
            raise ValueError(
                "PL002: column indices must be strictly increasing within "
                "each row (sorted, duplicates merged)"
            )
    if np.any(tm.data <= 0):
        raise ValueError("PL002: stored traffic must be positive")


def check_partition(assign, n_parts: int, n_vertices: int) -> None:
    """PL003 — partition assignment ranges (PartitionResult.validate)."""
    assign = np.asarray(assign)
    if assign.shape != (n_vertices,):
        raise ValueError("PL003: assign must map every vertex")
    if assign.min() < 0 or assign.max() >= n_parts:
        raise ValueError("PL003: assign out of range")


def check_block_synapses(syn) -> None:
    """PL004 — block-CSR synapse structure (BlockSynapses.validate)."""
    n = syn.n_blocks
    if syn.indptr.shape != (n + 1,) or syn.indptr[0] != 0:
        raise ValueError("PL004: indptr must be [n_blocks + 1] starting at 0")
    if syn.indptr[-1] != syn.nnzb or np.any(np.diff(syn.indptr) < 0):
        raise ValueError("PL004: indptr must be nondecreasing and end at nnzb")
    if syn.nnzb and (syn.src_ids.min() < 0 or syn.src_ids.max() >= n):
        raise ValueError("PL004: src_ids out of range")
    if syn.blocks.shape != (syn.nnzb, syn.block_size, syn.block_size):
        raise ValueError("PL004: blocks must be [nnzb, B, B]")
    # sorted-unique src per destination ⇔ the combined CSR key is
    # strictly increasing (src_ids < n, so dst·n + src never wraps)
    key = syn.dst_of() * n + syn.src_ids
    if np.any(np.diff(key) <= 0):
        raise ValueError("PL004: src_ids not sorted-unique within a destination")


def check_routing_table(tb) -> None:
    """PL005 — routing-table structure: group range + bridge membership
    (RoutingTable.validate)."""
    n = tb.n_devices
    g = tb.n_groups
    if tb.group_of.min() < 0 or tb.group_of.max() >= g:
        raise ValueError("PL005: group_of out of range")
    if tb.bridge.size == 0:
        return
    if tb.bridge.shape != (g, g):
        raise ValueError(f"PL005: bridge must be [G, G], got {tb.bridge.shape}")
    offdiag = ~np.eye(g, dtype=bool)
    b = tb.bridge[offdiag]
    gs_idx = np.broadcast_to(np.arange(g)[:, None], (g, g))[offdiag]
    bad = (b < 0) | (b >= n)
    bad |= tb.group_of[np.clip(b, 0, n - 1)] != gs_idx
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"PL005: bridge for group pair ({gs_idx[i]}, ·) = {b[i]} is not "
            f"a member of group {gs_idx[i]}"
        )


def check_bridge_shares(tb) -> None:
    """PL121 — ``share_coo`` consistency with the bridge matrix.

    Grouped tables: share devices are members of the source group, dst
    groups are in range, fractions are in (0, 1] and sum to 1 per
    (source-group, dst-group) flow that carries a share, and the primary
    ``bridge[gs, gd]`` is itself one of that flow's share devices.

    P2P tables (``bridge.size == 0``) historically escaped *all* share
    checking via the early return in ``RoutingTable.validate()``; a P2P
    table must not carry shares at all (there are no bridges to split
    load across).
    """
    if tb.bridge.size == 0:
        if tb.share_coo is not None and tb.share_coo[0].size:
            raise ValueError(
                "PL121: P2P table carries share_coo entries but has no "
                "bridges to assign load to"
            )
        return
    if tb.share_coo is None:
        return  # hand-built table: primary bridges carry flows whole
    n, g = tb.n_devices, tb.n_groups
    dev, grp, frac = tb.share_coo
    if not (dev.shape == grp.shape == frac.shape):
        raise ValueError("PL121: share_coo triplets must be equal-length")
    if dev.size == 0:
        return
    if dev.min() < 0 or dev.max() >= n:
        raise ValueError("PL121: share_coo device out of range")
    if grp.min() < 0 or grp.max() >= g:
        raise ValueError("PL121: share_coo destination group out of range")
    if np.any(frac <= 0) or np.any(frac > 1 + 1e-9):
        raise ValueError("PL121: share fractions must lie in (0, 1]")
    gsrc = tb.group_of[dev]
    if np.any(gsrc == grp):
        i = int(np.argmax(gsrc == grp))
        raise ValueError(
            f"PL121: device {dev[i]} holds a share toward its own group "
            f"{grp[i]} (diagonal flows never bridge)"
        )
    # fractions must sum to 1 per (source group, dst group) flow
    key = gsrc * g + grp
    sums = np.bincount(key, weights=frac, minlength=g * g)
    present = np.bincount(key, minlength=g * g) > 0
    bad = present & ~np.isclose(sums, 1.0, rtol=1e-9, atol=1e-9)
    if bad.any():
        k = int(np.argmax(bad))
        raise ValueError(
            f"PL121: share fractions for flow ({k // g} -> {k % g}) sum to "
            f"{sums[k]:.6g}, expected 1"
        )
    # the primary bridge of every shared flow must be among its share
    # devices (the share_coo rows must match the bridge matrix)
    prim = tb.bridge[gsrc, grp]
    share_key = dev * g + grp
    prim_key = prim * g + grp
    order = np.argsort(share_key, kind="stable")
    pos = np.searchsorted(share_key[order], prim_key)
    pos = np.minimum(pos, max(share_key.size - 1, 0))
    missing = share_key[order][pos] != prim_key
    if missing.any():
        i = int(np.argmax(missing))
        raise ValueError(
            f"PL121: primary bridge {prim[i]} of flow "
            f"({gsrc[i]} -> {grp[i]}) has no share_coo entry (bridge and "
            "shares desynced)"
        )
