"""Ragged level-2 spike exchange: bridge-compacted, column-pruned payloads.

``exchange='sparse'`` schedules only the masked group pairs, but
every scheduled transfer still ships the full ``R·B`` group spike block,
replicated across all ``R`` inner mesh positions — an ``R×`` (and
density-blind) redundancy.  The paper's Algorithm-2 bridge eliminates
exactly this: *one* member per group carries the aggregated cross-group
flow, and the payload is sized by what the receiver consumes.

The planner here turns the synapse tiles into a **static ragged
schedule**:

* **Column pruning** — for a scheduled group pair ``(gs, gd)`` only the
  source columns some receiver actually consumes (nonzero rows of a
  stored tile, :meth:`~repro_torch.snn.sparse.BlockSynapses.tile_occupancy`)
  enter the payload; the rest of the group block never moves.
* **Bridge compaction** — the packed payload crosses the slow axis once,
  from the sending group's bridge device to the receiving group's bridge
  (a single pair in a joint-axis ``lax.ppermute``), instead of once per
  inner position.  Received payloads are re-broadcast *inside* the group
  over the fast axis (level-1 territory, like the paper's bridge fan-out).
* **Static shapes** — SPMD needs one trace, so payloads are padded to the
  per-round maximum width ``K_r``; pad lanes are routed to a trash slot
  on the receive side.  The executed (= accounted) bytes per round are
  ``|pairs_r| · K_r · 4``.

The executor lives in :meth:`repro_torch.snn.distributed.DistributedSNN`
(``exchange='ragged'``); :func:`repro_torch.snn.sparse.exchange_volume` reports
the resulting byte accounting next to the flat and sparse schedules.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "RaggedRound",
    "RaggedPlan",
    "build_ragged_plan",
    "build_ragged_plan_from_mask",
    "bridge_inner_from_table",
]


@dataclasses.dataclass(frozen=True)
class RaggedRound:
    """One level-2 shift round of the ragged schedule.

    Attributes:
      shift: ring shift ``r`` — pairs are ``(gs, (gs + r) % G)``.
      pairs: the scheduled ``(gs, gd)`` group pairs of this round.
      width: ``K_r`` — static payload lanes (max pruned pair width this
        round; pairs narrower than ``K_r`` are zero-padded).
      perm:  flat-device ``(src, dst)`` pairs for the joint-axis
        ``lax.ppermute`` — exactly one (bridge) device per scheduled pair.
      send_idx: ``int32[n_dev, width]`` — per device, the columns of its
        group spike block ``[R·B]`` packed into the payload (pad → 0;
        pad lanes are discarded by the receiver).
      recv_idx: ``int32[n_dev, width]`` — per device, the destination
        slots of the received payload inside a ``[R·B + 1]`` buffer row;
        the extra slot ``R·B`` is the trash lane for padding (and for
        devices whose group receives nothing this round).
    """

    shift: int
    pairs: tuple[tuple[int, int], ...]
    width: int
    perm: tuple[tuple[int, int], ...]
    send_idx: np.ndarray
    recv_idx: np.ndarray

    @property
    def nbytes(self) -> int:
        """Slow-axis bytes this round moves per simulation step."""
        return len(self.pairs) * self.width * 4


@dataclasses.dataclass(frozen=True)
class RaggedPlan:
    """Static ragged level-2 schedule for a ``(G, R)`` mesh.

    ``pair_cols[(gs, gd)]`` holds the sorted consumed source columns
    (positions inside group ``gs``'s ``[R·B]`` spike block) of every
    scheduled pair — the planner's ground truth the tests audit against.
    """

    mesh_shape: tuple[int, int]
    block_size: int
    rounds: tuple[RaggedRound, ...]
    pair_cols: dict[tuple[int, int], np.ndarray]

    @property
    def n_devices(self) -> int:
        return self.mesh_shape[0] * self.mesh_shape[1]

    @property
    def bytes_per_step(self) -> int:
        """Executed slow-axis bytes per step — padding included, so this
        matches the ``ppermute`` payloads bit for bit."""
        return sum(rnd.nbytes for rnd in self.rounds)

    @property
    def packed_bytes_per_step(self) -> int:
        """Pruned bytes before per-round padding (the lower bound the
        static-shape constraint pads up from)."""
        return sum(4 * int(cols.size) for cols in self.pair_cols.values())

    def round_messages(self) -> list[list[tuple[int, int, int]]]:
        """Flat-device ``(src, dst, nbytes)`` triples per executed round.

        The wire-level view of the plan: one padded ``K_r · 4``-byte
        payload per ``(bridge, bridge)`` pair of each round's joint-axis
        ``ppermute`` — exactly what the ragged executor moves, so the
        total equals :attr:`bytes_per_step` (padding included).  This is
        the replay input :mod:`repro.netsim` pins its byte accounting
        against ``exchange_volume(..., plan=...)['ragged']`` with.
        """
        return [
            [(src, dst, rnd.width * 4) for src, dst in rnd.perm]
            for rnd in self.rounds
        ]


def bridge_inner_from_table(tb) -> np.ndarray:
    """Map an Algorithm-2 routing table's bridges to mesh inner indices.

    Devices are laid out group-contiguously by
    :func:`repro_torch.snn.distributed.group_mesh_permutation` (stable argsort
    of ``group_of``), so the inner mesh index of a device is its rank
    inside its group.  Returns ``int64[G, G]`` with ``out[gs, gd]`` the
    inner index of ``bridge[gs, gd]`` (diagonal −1); feed it to
    :func:`build_ragged_plan` so the ragged schedule crosses the slow
    axis on exactly the table's bridge devices.
    """
    g = tb.n_groups
    perm = np.argsort(tb.group_of, kind="stable")
    rank = np.empty(tb.n_devices, dtype=np.int64)
    counts = np.bincount(tb.group_of, minlength=g)
    rank[perm] = np.arange(tb.n_devices) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    out = np.full((g, g), -1, dtype=np.int64)
    if tb.bridge.size:
        off = ~np.eye(g, dtype=bool)
        valid = off & (tb.bridge >= 0)
        out[valid] = rank[tb.bridge[valid]]
    return out


def _pair_columns(
    syn, group_of: np.ndarray, r: int, mask: np.ndarray | None
) -> dict[tuple[int, int], np.ndarray]:
    """Consumed source columns per cross-group pair.

    Tile-driven: the union over stored tiles ``src ∈ gs → dst ∈ gd`` of
    the tile's occupied rows, offset by the source device's position in
    its group.  When ``mask`` (a device-level superset, e.g. from a
    routing table) schedules a pair no tile realizes, the pair's payload
    is the *full* block of every masked source device — the safe superset
    when column occupancy is unknown.
    """
    b = syn.block_size
    occ = syn.tile_occupancy()
    dst = syn.dst_of()
    gs_t = group_of[syn.src_ids]
    gd_t = group_of[dst]
    cross = gs_t != gd_t
    cols: dict[tuple[int, int], set] = {}
    if np.any(cross):
        k_idx, c_idx = np.nonzero(occ[cross])
        src_c = syn.src_ids[cross][k_idx]
        pos = (src_c % r) * b + c_idx
        for gs, gd, p in zip(
            gs_t[cross][k_idx].tolist(), gd_t[cross][k_idx].tolist(), pos.tolist()
        ):
            cols.setdefault((gs, gd), set()).add(int(p))
    if mask is not None:
        # masked source devices without a stored tile for the pair ship
        # their full block (occupancy unknown — the safe superset)
        tiled_devices: dict[tuple[int, int], set] = {}
        for k in np.flatnonzero(cross).tolist():
            tiled_devices.setdefault(
                (int(gs_t[k]), int(gd_t[k])), set()
            ).add(int(syn.src_ids[k]))
        src_d, dst_d = np.nonzero(np.asarray(mask, dtype=bool))
        for sd, dd in zip(src_d.tolist(), dst_d.tolist()):
            gs, gd = int(group_of[sd]), int(group_of[dd])
            if gs == gd or sd in tiled_devices.get((gs, gd), set()):
                continue
            base = (sd % r) * b
            cols.setdefault((gs, gd), set()).update(range(base, base + b))
    return {
        pair: np.array(sorted(s), dtype=np.int64) for pair, s in cols.items() if s
    }


def build_ragged_plan(
    syn,
    mesh_shape: tuple[int, int],
    *,
    bridge_inner: np.ndarray | None = None,
    mask: np.ndarray | None = None,
) -> RaggedPlan:
    """Plan the ragged level-2 exchange for ``syn`` on a ``(G, R)`` mesh.

    Args:
      syn: :class:`~repro_torch.snn.sparse.BlockSynapses` with ``G·R`` blocks
        laid out group-contiguously (device ``d`` in group ``d // R``).
      mesh_shape: ``(G, R)`` — slow-axis groups × devices per group.
      bridge_inner: ``int[G, G]`` — inner index of the member of ``gs``
        bridging the ``gs → gd`` flow (sender side; the receiver's bridge
        for the same flow is ``bridge_inner[gd, gs]``).  ``None`` spreads
        bridge duty round-robin by destination group, the balanced
        default matching :func:`~repro.core.hierarchical.two_level_all_to_all`'s
        uniform bridge spread.  Use :func:`bridge_inner_from_table` to
        plan on an Algorithm-2 table's bridges instead.
      mask: optional device-level consumer mask (e.g.
        :func:`repro_torch.core.routing.needed_sources`) — a safe superset of
        the tile structure; masked pairs without stored tiles get
        full-block payloads.

    Returns:
      :class:`RaggedPlan` with one :class:`RaggedRound` per ring shift.
    """
    g, r = int(mesh_shape[0]), int(mesh_shape[1])
    n_dev = g * r
    if syn.n_blocks != n_dev:
        raise ValueError(
            f"syn has {syn.n_blocks} blocks for a ({g}, {r}) mesh ({n_dev} devices)"
        )
    b = syn.block_size
    group_of = np.arange(n_dev, dtype=np.int64) // r
    bridge_inner = _normalize_bridge_inner(bridge_inner, g, r)
    pair_cols = _pair_columns(syn, group_of, r, mask)
    return RaggedPlan(
        mesh_shape=(g, r),
        block_size=b,
        rounds=_rounds_from_pair_cols(pair_cols, g, r, b, bridge_inner),
        pair_cols=pair_cols,
    )


def build_ragged_plan_from_mask(
    mask: np.ndarray,
    mesh_shape: tuple[int, int],
    block_size: int,
    *,
    bridge_inner: np.ndarray | None = None,
) -> RaggedPlan:
    """Plan the ragged level-2 exchange from a consumer mask alone.

    The out-of-core path (:func:`repro.core.outofcore.plan_out_of_core`):
    at planning time no synapse tiles exist yet, only the routing table's
    device-level consumer mask, so every masked cross-group pair ships
    the full ``block_size`` lanes of each masked source device — the same
    safe superset :func:`build_ragged_plan`'s ``mask`` branch uses for
    tile-less pairs, with identical round construction (shared helper),
    so the resulting plan passes the same PL102/PL140–142 lints.

    Args:
      mask: ``bool[n_dev, n_dev]`` consumer mask in **mesh order**
        (device ``d`` in group ``d // R`` — permute a routing table's
        :func:`~repro_torch.core.routing.needed_sources` output with the
        group-contiguous layout first).
      mesh_shape: ``(G, R)``.
      block_size: spike lanes per device block ``B``.
      bridge_inner: as in :func:`build_ragged_plan`.

    Returns:
      :class:`RaggedPlan` whose payloads cover every masked cross-group
      flow at full block width.
    """
    g, r = int(mesh_shape[0]), int(mesh_shape[1])
    n_dev = g * r
    mask = np.asarray(mask, dtype=bool)
    if mask.shape != (n_dev, n_dev):
        raise ValueError(f"mask must be [{n_dev}, {n_dev}] for a ({g}, {r}) mesh")
    b = int(block_size)
    if b <= 0:
        raise ValueError("block_size must be positive")
    bridge_inner = _normalize_bridge_inner(bridge_inner, g, r)
    pair_cols = _pair_columns_from_mask(mask, g, r, b)
    return RaggedPlan(
        mesh_shape=(g, r),
        block_size=b,
        rounds=_rounds_from_pair_cols(pair_cols, g, r, b, bridge_inner),
        pair_cols=pair_cols,
    )


def _pair_columns_from_mask(
    mask: np.ndarray, g: int, r: int, b: int
) -> dict[tuple[int, int], np.ndarray]:
    """Full-block consumed columns per masked cross-group pair (mesh
    order): the union over masked source devices of their ``b``-lane
    slots inside the group block."""
    src_d, dst_d = np.nonzero(mask)
    gs_a, gd_a = src_d // r, dst_d // r
    cross = gs_a != gd_a
    if not np.any(cross):
        return {}
    pk = gs_a[cross] * g + gd_a[cross]
    slot = src_d[cross] % r
    order = np.argsort(pk, kind="stable")
    pk, slot = pk[order], slot[order]
    keys, starts = np.unique(pk, return_index=True)
    bounds = np.append(starts, pk.size)
    lanes = np.arange(b, dtype=np.int64)
    out: dict[tuple[int, int], np.ndarray] = {}
    for key, lo, hi in zip(keys.tolist(), bounds[:-1].tolist(), bounds[1:].tolist()):
        slots = np.unique(slot[lo:hi])
        out[(key // g, key % g)] = (slots[:, None] * b + lanes[None, :]).ravel()
    return out


def _normalize_bridge_inner(
    bridge_inner: np.ndarray | None, g: int, r: int
) -> np.ndarray:
    """Validate a ``[G, G]`` bridge-inner map, or build the round-robin
    default (member ``gd % R`` of ``gs`` bridges ``gs → gd``)."""
    if bridge_inner is None:
        bridge_inner = np.arange(g, dtype=np.int64)[None, :] % r
        bridge_inner = np.broadcast_to(bridge_inner, (g, g)).copy()
        np.fill_diagonal(bridge_inner, -1)
        return bridge_inner
    bridge_inner = np.asarray(bridge_inner, dtype=np.int64)
    if bridge_inner.shape != (g, g):
        raise ValueError("bridge_inner must be [G, G]")
    off = ~np.eye(g, dtype=bool)
    bad = off & ((bridge_inner < 0) | (bridge_inner >= r))
    if bad.any():
        gs_bad, gd_bad = np.argwhere(bad)[0]
        raise ValueError(
            f"bridge_inner[{gs_bad}, {gd_bad}] = "
            f"{bridge_inner[gs_bad, gd_bad]} outside [0, {r})"
        )
    return bridge_inner


def _rounds_from_pair_cols(
    pair_cols: dict[tuple[int, int], np.ndarray],
    g: int,
    r: int,
    b: int,
    bridge_inner: np.ndarray,
) -> tuple[RaggedRound, ...]:
    """Assemble the per-shift :class:`RaggedRound`\\ s from consumed
    columns — shared by the tile-driven and mask-driven planners so both
    produce byte-identical schedules for identical ``pair_cols``."""
    n_dev = g * r
    rb = r * b
    rounds: list[RaggedRound] = []
    for shift in range(1, g):
        pairs = [
            (gs, (gs + shift) % g)
            for gs in range(g)
            if (gs, (gs + shift) % g) in pair_cols
        ]
        if not pairs:
            rounds.append(
                RaggedRound(
                    shift=shift,
                    pairs=(),
                    width=0,
                    perm=(),
                    send_idx=np.zeros((n_dev, 0), dtype=np.int32),
                    recv_idx=np.zeros((n_dev, 0), dtype=np.int32),
                )
            )
            continue
        width = max(int(pair_cols[p].size) for p in pairs)
        send_idx = np.zeros((n_dev, width), dtype=np.int32)
        recv_idx = np.full((n_dev, width), rb, dtype=np.int32)  # trash slot
        perm = []
        for gs, gd in pairs:
            cols = pair_cols[(gs, gd)]
            w = int(cols.size)
            src_flat = gs * r + int(bridge_inner[gs, gd])
            dst_flat = gd * r + int(bridge_inner[gd, gs])
            perm.append((src_flat, dst_flat))
            members_s = np.arange(gs * r, (gs + 1) * r)
            members_d = np.arange(gd * r, (gd + 1) * r)
            send_idx[members_s, :w] = cols[None, :]
            recv_idx[members_d, :w] = cols[None, :]
        rounds.append(
            RaggedRound(
                shift=shift,
                pairs=tuple(pairs),
                width=width,
                perm=tuple(perm),
                send_idx=send_idx,
                recv_idx=recv_idx,
            )
        )
    return tuple(rounds)
