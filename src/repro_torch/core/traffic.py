"""Sparse device-level traffic matrices (CSR).

Algorithm 2 consumes the *device* traffic graph ``T[N, N]`` aggregated
from the neuron/population :class:`~repro_torch.core.graph.CommGraph`.  A dense
``float64[N, N]`` caps the routing subsystem near the paper's N = 2,000
GPUs (800 MB at N = 10,000); real inter-device traffic is sparse — each
device talks to a bounded neighborhood — so we carry it in the same CSR
shape the rest of the pipeline uses (``indptr / indices / data``), with
``data`` holding the aggregated traffic volume instead of a connection
probability.

:class:`TrafficMatrix` is the canonical representation of the sparse
routing core in :mod:`repro_torch.core.routing`; the dense path survives as a
parity oracle in :mod:`repro.core.routing_dense`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TrafficMatrix"]


def _ranges(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(lo[i], hi[i]) for i]`` without a Python loop."""
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    # start-of-segment offsets into the flat output
    starts = np.zeros(cnt.shape[0], dtype=np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    out = np.arange(total, dtype=np.int64)
    out += np.repeat(lo - starts, cnt)
    return out


def _merge_by_key(key: np.ndarray, vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sort COO entries by flat key and sum equal-key runs.

    Stable sort keeps equal-key contributions in input order, so merged
    sums are reproducible (run boundaries + ``reduceat`` — cheaper than
    ``np.unique``, which would sort again)."""
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    if not key.size:
        return key, vals
    first = np.empty(key.shape[0], dtype=bool)
    first[0] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    start = np.nonzero(first)[0]
    return key[start], np.add.reduceat(vals, start)


def _csr_from_sorted_keys(
    uniq: np.ndarray, merged: np.ndarray, n_devices: int
) -> "TrafficMatrix":
    """Assemble a validated CSR from sorted unique flat keys + values."""
    rows = uniq // n_devices
    cols = uniq % n_devices
    counts = np.bincount(rows, minlength=n_devices)
    indptr = np.zeros(n_devices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    tm = TrafficMatrix(indptr=indptr, indices=cols, data=merged)
    tm.validate()
    return tm


@dataclasses.dataclass(frozen=True)
class TrafficMatrix:
    """CSR matrix of aggregated device-to-device traffic.

    Invariants (enforced by the constructors below): column indices are
    sorted within each row, duplicates are merged by summation, the
    diagonal is empty, and every stored value is positive.

    Attributes:
      indptr:  ``int64[N + 1]`` CSR row pointers.
      indices: ``int64[nnz]`` column (destination device) indices.
      data:    ``float64[nnz]`` traffic volumes.
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def n_devices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def rows(self) -> np.ndarray:
        """CSR row index for every stored entry."""
        return np.repeat(
            np.arange(self.n_devices, dtype=np.int64), np.diff(self.indptr)
        )

    def row_sums(self) -> np.ndarray:
        """Total egress traffic per device."""
        return np.bincount(
            self.rows(), weights=self.data, minlength=self.n_devices
        )

    def total(self) -> float:
        return float(self.data.sum())

    def to_dense(self) -> np.ndarray:
        """Materialize ``float64[N, N]`` (small N only)."""
        n = self.n_devices
        out = np.zeros((n, n))
        out[self.rows(), self.indices] = self.data
        return out

    def consumer_mask(self) -> np.ndarray:
        """Dense ``bool[N, N]`` — ``mask[src, dst]`` is True when device
        ``dst`` receives traffic from ``src`` (a stored entry), plus the
        diagonal (a device always consumes its own spikes).

        This is the "needed columns" export the distributed SNN engine
        schedules its sparse spike exchange from: device ``dst`` only
        needs the spike blocks of sources with ``mask[src, dst]``.  One
        bool per device pair — fine up to tens of thousands of devices.
        """
        n = self.n_devices
        out = np.zeros((n, n), dtype=bool)
        out[self.rows(), self.indices] = True
        np.fill_diagonal(out, True)
        return out

    def payload_widths(self, block_size: int) -> np.ndarray:
        """``int64[N, N]`` per-pair spike-payload widths (f32 lanes).

        ``widths[src, dst]`` is how many of source ``src``'s spike-block
        columns destination ``dst`` may consume.  Device traffic carries
        no column-level structure, so every stored pair (and the
        diagonal) gets the full ``block_size`` — the safe superset the
        ragged exchange planner pads up to when synapse tiles are not
        available; tile occupancy
        (:meth:`repro_torch.snn.sparse.BlockSynapses.tile_occupancy`) refines
        these widths down on the realized model.
        """
        return self.consumer_mask().astype(np.int64) * int(block_size)

    def transpose(self) -> "TrafficMatrix":
        return TrafficMatrix.from_coo(
            self.indices, self.rows(), self.data, self.n_devices
        )

    def is_symmetric(self, *, rtol: float = 1e-9, atol: float = 0.0) -> bool:
        """True when both directions are stored with (numerically) equal
        volume — i.e. the matrix equals its transpose."""
        tt = self.transpose()
        return (
            np.array_equal(self.indptr, tt.indptr)
            and np.array_equal(self.indices, tt.indices)
            and np.allclose(self.data, tt.data, rtol=rtol, atol=atol)
        )

    def symmetrized(self, *, halve: bool) -> "TrafficMatrix":
        """Return ``(T + Tᵀ)/2`` (``halve=True``; storage already held both
        directions) or ``T + Tᵀ`` (``halve=False``; each pair stored once)."""
        r, c, v = self.rows(), self.indices, self.data
        if halve:
            v = v / 2.0
        return TrafficMatrix.from_coo(
            np.concatenate([r, c]),
            np.concatenate([c, r]),
            np.concatenate([v, v]),
            self.n_devices,
        )

    def validate(self) -> None:
        # delegated to the planlint rule registry (rule PL002) so
        # construction-time checks and `python -m repro.analysis` agree
        from repro_torch.analysis import invariants

        invariants.check_traffic_matrix(self)

    def apply_delta(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        dvals: np.ndarray,
    ) -> "TrafficMatrix":
        """Incrementally edit the matrix; returns a new validated CSR.

        ``dvals[k]`` is *added* to entry ``(src[k], dst[k])`` — positive
        to grow or create a flow, negative to shrink or remove one.
        Duplicate delta triplets sum; self-loops are dropped (a device
        never stores traffic to itself); entries whose merged volume
        lands at or below zero are removed, matching
        :meth:`from_coo` dropping non-positive aggregates — so editing
        via deltas and rebuilding from the edited COO agree exactly.

        Cost is O((nnz + |delta|) log |delta|)-ish: one merge pass over
        the stored entries plus a sort of the delta — no re-aggregation
        of the neuron graph, which is the point (structural plasticity
        and fault evacuation edit a handful of device pairs per event).
        """
        n = self.n_devices
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        dvals = np.asarray(dvals, dtype=np.float64)
        if not (src.shape == dst.shape == dvals.shape and src.ndim == 1):
            raise ValueError("delta triplets must be equal-length 1-D arrays")
        if src.size and (
            min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n
        ):
            raise ValueError("delta device indices out of range")
        keep = src != dst
        src, dst, dvals = src[keep], dst[keep], dvals[keep]
        key = np.concatenate([self.rows() * n + self.indices, src * n + dst])
        vals = np.concatenate([self.data, dvals])
        uniq, merged = _merge_by_key(key, vals)
        pos = merged > 0
        return _csr_from_sorted_keys(uniq[pos], merged[pos], n)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_coo(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        vals: np.ndarray,
        n_devices: int,
    ) -> "TrafficMatrix":
        """Build from COO triplets: duplicates are *summed* (aggregation
        semantics), self-loops and non-positive values are dropped."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        keep = (src != dst) & (vals > 0)
        src, dst, vals = src[keep], dst[keep], vals[keep]
        uniq, merged = _merge_by_key(src * n_devices + dst, vals)
        return _csr_from_sorted_keys(uniq, merged, n_devices)

    @classmethod
    def from_dense(cls, t: np.ndarray) -> "TrafficMatrix":
        """Build from a dense ``[N, N]`` matrix (zeros/diagonal dropped)."""
        t = np.asarray(t, dtype=np.float64)
        n = t.shape[0]
        if t.shape != (n, n):
            raise ValueError("traffic matrix must be square")
        src, dst = np.nonzero(t)
        return cls.from_coo(src, dst, t[src, dst], n)
