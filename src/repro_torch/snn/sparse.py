"""Block-CSR synapse storage + the masked spike-exchange schedule.

The distributed engine partitions the permuted synapse matrix ``W[M, M]``
into an ``n_blocks × n_blocks`` grid of ``B × B`` tiles (``B = M /
n_blocks``, one block row/column per device).  Brain connectivity is
community-structured, so after Algorithm-1 placement most tiles are
exactly zero — :class:`BlockSynapses` stores only the nonzero tiles in
CSR-over-destination-blocks form and never materializes ``[M, M]``.

The same structure drives the *exchange*: device ``d`` only needs the
spike blocks of sources ``src`` with ``mask[src, d]`` — the paper's
routing-table claim ("which bytes move") applied to the simulation loop.
:func:`exchange_schedule` turns a (group-pooled) block mask into rounds
of ``lax.ppermute`` pairs over the slow mesh axis; pairs absent from the
mask are simply never scheduled, which is where the byte savings come
from (:func:`exchange_volume` accounts for them).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "BlockSynapses",
    "exchange_schedule",
    "exchange_messages",
    "exchange_volume",
]


@dataclasses.dataclass(frozen=True)
class BlockSynapses:
    """Nonzero ``B × B`` tiles of a block-partitioned synapse matrix.

    CSR over **destination** blocks (the device that consumes the tile):
    tile ``k`` with ``indptr[d] <= k < indptr[d+1]`` holds
    ``W[src_ids[k]·B:(src_ids[k]+1)·B, d·B:(d+1)·B]`` — presynaptic rows
    from block ``src_ids[k]``, postsynaptic columns of block ``d``.

    Attributes:
      indptr:  ``int64[n_blocks + 1]`` CSR pointers over destinations.
      src_ids: ``int64[nnzb]`` source block per stored tile (sorted and
               unique within each destination).
      blocks:  ``float32[nnzb, B, B]`` the tile values.
      n_blocks: grid size (= device count in the distributed engine).
    """

    indptr: np.ndarray
    src_ids: np.ndarray
    blocks: np.ndarray
    n_blocks: int

    @property
    def block_size(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def nnzb(self) -> int:
        return int(self.src_ids.shape[0])

    @property
    def n_neurons(self) -> int:
        return self.n_blocks * self.block_size

    @property
    def density(self) -> float:
        """Fraction of the ``n_blocks²`` tile grid that is stored."""
        return self.nnzb / float(self.n_blocks * self.n_blocks)

    @property
    def nbytes(self) -> int:
        return int(self.blocks.nbytes + self.src_ids.nbytes + self.indptr.nbytes)

    def dst_of(self) -> np.ndarray:
        """Destination block for every stored tile."""
        return np.repeat(
            np.arange(self.n_blocks, dtype=np.int64), np.diff(self.indptr)
        )

    def mask(self) -> np.ndarray:
        """``bool[n_blocks, n_blocks]`` — ``mask[src, dst]`` is True when
        destination ``dst`` stores a tile from source ``src``.  The
        diagonal is always True (a device consumes its own spikes even if
        the self tile happens to be empty)."""
        out = np.zeros((self.n_blocks, self.n_blocks), dtype=bool)
        out[self.src_ids, self.dst_of()] = True
        np.fill_diagonal(out, True)
        return out

    def tile_occupancy(self) -> np.ndarray:
        """``bool[nnzb, B]`` — ``occ[k, i]`` is True when row ``i`` of tile
        ``k`` holds any nonzero weight, i.e. the destination block consumes
        source neuron ``i`` of block ``src_ids[k]``.  This is the per-tile
        consumed-column set the ragged exchange planner prunes payloads
        with (:mod:`repro_torch.snn.ragged`): a source spike whose row is empty
        in every tile of a group pair never needs to cross the slow axis.
        """
        return np.abs(self.blocks).sum(axis=2) > 0

    def to_dense(self) -> np.ndarray:
        """Materialize ``f32[M, M]`` (small models / parity tests only)."""
        b = self.block_size
        out = np.zeros((self.n_neurons, self.n_neurons), dtype=np.float32)
        for k, dst in zip(range(self.nnzb), self.dst_of()):
            src = self.src_ids[k]
            out[src * b : (src + 1) * b, dst * b : (dst + 1) * b] = self.blocks[k]
        return out

    def padded(self) -> tuple[np.ndarray, np.ndarray]:
        """Zero-padded per-destination arrays for static-shape SPMD.

        Returns ``(src_ids[n_blocks, K], blocks[n_blocks, K, B, B])`` with
        ``K = max in-degree`` (≥ 1): destination ``d``'s real tiles first,
        then padding tiles pointing at source 0 with all-zero weights (so
        they contribute nothing to the accumulation).
        """
        deg = np.diff(self.indptr)
        k = max(int(deg.max()) if deg.size else 0, 1)
        b = self.block_size
        src = np.zeros((self.n_blocks, k), dtype=np.int64)
        blk = np.zeros((self.n_blocks, k, b, b), dtype=np.float32)
        for d in range(self.n_blocks):
            lo, hi = int(self.indptr[d]), int(self.indptr[d + 1])
            src[d, : hi - lo] = self.src_ids[lo:hi]
            blk[d, : hi - lo] = self.blocks[lo:hi]
        return src, blk

    def validate(self) -> None:
        # delegated to the planlint rule registry (rule PL004) so
        # construction-time checks and `python -m repro.analysis` agree
        from repro_torch.analysis import invariants

        invariants.check_block_synapses(self)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_tiles(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        tiles: np.ndarray,
        n_blocks: int,
    ) -> "BlockSynapses":
        """Build from COO tiles ``(src[k], dst[k], tiles[k, B, B])``;
        duplicates are rejected, all-zero tiles are dropped."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        tiles = np.asarray(tiles, dtype=np.float32)
        if tiles.shape[0]:
            keep = np.abs(tiles).sum(axis=(1, 2)) > 0
            src, dst, tiles = src[keep], dst[keep], tiles[keep]
        key = dst * n_blocks + src
        if np.unique(key).size != key.size:
            raise ValueError("duplicate (src, dst) tiles")
        order = np.argsort(key, kind="stable")
        src, tiles = src[order], tiles[order]
        counts = np.bincount(dst, minlength=n_blocks)
        indptr = np.zeros(n_blocks + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        syn = cls(indptr=indptr, src_ids=src, blocks=tiles, n_blocks=n_blocks)
        syn.validate()
        return syn

    @classmethod
    def from_dense(cls, w: np.ndarray, n_blocks: int) -> "BlockSynapses":
        """Tile a dense ``[M, M]`` matrix, keeping nonzero tiles only."""
        w = np.asarray(w, dtype=np.float32)
        m = w.shape[0]
        if w.shape != (m, m) or m % n_blocks:
            raise ValueError("W must be square with n_blocks dividing M")
        b = m // n_blocks
        tiled = w.reshape(n_blocks, b, n_blocks, b).transpose(0, 2, 1, 3)
        src, dst = np.nonzero(np.abs(tiled).sum(axis=(2, 3)) > 0)
        return cls.from_tiles(src, dst, tiled[src, dst], n_blocks)


def exchange_schedule(
    gmask: np.ndarray,
) -> list[list[tuple[int, int]]]:
    """Rounds of ``lax.ppermute`` pairs realizing a masked block exchange.

    ``gmask[src, dst]`` (bool, group granularity) says destination group
    ``dst`` consumes source group ``src``'s aggregated spike block.  Round
    ``r`` (1 ≤ r < G) holds the shift-``r`` pairs ``(g, (g+r) % G)`` that
    the mask requires; a receiver not targeted in a round gets zeros from
    ``ppermute`` and its buffer slot stays empty — harmless because its
    synapse storage holds no tile from that source.  The diagonal never
    schedules (own spikes are local).
    """
    g = int(gmask.shape[0])
    rounds: list[list[tuple[int, int]]] = []
    for r in range(1, g):
        pairs = [
            (gs, (gs + r) % g) for gs in range(g) if gmask[gs, (gs + r) % g]
        ]
        rounds.append(pairs)
    return rounds


def exchange_messages(
    gmask: np.ndarray,
    mesh_shape: tuple[int, ...],
    block_bytes: int,
) -> list[list[tuple[int, int, int]]]:
    """Flat-device ``(src, dst, nbytes)`` triples per ``ppermute`` round.

    The wire-level view of :func:`exchange_schedule`, mirroring exactly
    what :meth:`repro_torch.snn.distributed.DistributedSNN` executes with
    ``exchange='sparse'``: each scheduled group pair ``(gs, gd)`` runs
    once per inner mesh position (``ppermute`` over the slow axis is
    per inner index), and every message carries the aggregated
    ``R · B`` group spike block (``r · block_bytes`` wire bytes).  The
    sum over all triples therefore equals
    ``exchange_volume(...)['sparse']`` for the same mask — the
    invariant :mod:`repro.netsim` replays pin their byte accounting to.
    On a 1-D mesh (``mesh_shape=(n,)``) every device is its own group
    and each triple moves one ``block_bytes`` block.

    Pass a full (off-diagonal) ``gmask`` to obtain the flat schedule's
    triples — ``exchange_volume(...)['flat']`` by the same accounting.
    """
    if len(mesh_shape) == 1:
        g, r = int(mesh_shape[0]), 1
    else:
        g, r = int(mesh_shape[0]), int(np.prod(mesh_shape[1:]))
    if gmask.shape != (g, g):
        raise ValueError(f"gmask {gmask.shape} incompatible with G = {g}")
    nbytes = r * block_bytes
    return [
        [(gs * r + i, gd * r + i, nbytes) for gs, gd in pairs for i in range(r)]
        for pairs in exchange_schedule(gmask)
    ]


def exchange_volume(
    mask: np.ndarray,
    *,
    mesh_shape: tuple[int, ...] | None = None,
    block_bytes: int,
    plan=None,
) -> dict[str, int]:
    """Slow-axis bytes received per simulation step: flat vs masked vs ragged.

    ``mask`` is the device-level block mask (``bool[n_dev, n_dev]``,
    diagonal ignored).  On a 1-D mesh (``mesh_shape=None`` or ``(n,)``)
    every off-diagonal pair is a slow-axis transfer; on a 2-D ``(G, R)``
    mesh only the level-2 (cross-group) stage counts — level-1 gathers are
    identical for all schedules.  Each scheduled cross-group pair moves
    the group-aggregated block (``R · block_bytes``) once per inner
    position (``ppermute`` over the slow axis runs per inner index),
    mirroring what :func:`exchange_schedule` actually executes.

    When ``plan`` (a :class:`repro_torch.snn.ragged.RaggedPlan` for the same
    mask and mesh) is given, the result gains a ``'ragged'`` entry:
    the bridge-compacted, column-pruned payload bytes the ragged executor
    moves — per round, ``|pairs_r| · K_r · 4`` with ``K_r`` the padded
    payload width, so the accounting matches the executed ``ppermute``
    schedule exactly (padding included).
    """
    n = int(mask.shape[0])
    if mesh_shape is None or len(mesh_shape) == 1:
        off = ~np.eye(n, dtype=bool)
        out = {
            "flat": n * (n - 1) * block_bytes,
            "sparse": int(np.count_nonzero(mask & off)) * block_bytes,
        }
        if plan is not None:
            if plan.mesh_shape != (n, 1):
                raise ValueError(
                    f"plan mesh {plan.mesh_shape} incompatible with 1-D mask [{n}]"
                )
            out["ragged"] = plan.bytes_per_step
        return out
    from repro_torch.core.routing import pool_block_mask

    g, r = int(mesh_shape[0]), int(np.prod(mesh_shape[1:]))
    if g * r != n:
        raise ValueError(f"mesh {mesh_shape} incompatible with mask [{n},{n}]")
    # the same pooling the engine schedules from, minus the diagonal
    # (own-group blocks are level-1 territory and never cross the slow axis)
    gm = pool_block_mask(mask, np.arange(n) // r, g)
    np.fill_diagonal(gm, False)
    pair_bytes = r * (r * block_bytes)  # R inner copies of the R·B block
    out = {
        "flat": g * (g - 1) * pair_bytes,
        "sparse": int(np.count_nonzero(gm)) * pair_bytes,
    }
    if plan is not None:
        if plan.mesh_shape != (g, r):
            raise ValueError(
                f"plan mesh {plan.mesh_shape} incompatible with mesh {mesh_shape}"
            )
        out["ragged"] = plan.bytes_per_step
    return out
