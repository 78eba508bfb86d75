"""Communicators of the distributed SNN engine: the collectives it issues
and the slow-axis byte ledger they keep.

The counterpart of the ``shard_map`` collectives the reference engine
issues (``repro/snn/distributed.py:299-304`` and ``:533-599``).  A mesh is
``(G,)`` or ``(G, R)``; rank ``g·R + i`` is position ``i`` of group ``g``.
Axis 0 of the mesh is the slow axis (across groups), the rest is the fast
``inner`` axis (inside a group).  A collective runs over one axis:
``"inner"`` (the R ranks of a group), ``"slow"`` (the G ranks of one inner
position, one per group) or ``"joint"`` (every rank); an axis group's
members are ordered by global rank.

A communicator holds the global ranks :attr:`Comm.ranks`, and every tensor
it takes or gives is stacked over them, ``[len(ranks), ...]``:

* :class:`LoopbackComm` holds every rank of the mesh in one process, on one
  device (``ranks = range(n_dev)``): each collective is a reshape, a
  gather or a sum;
* :class:`ProcessGroupComm` holds one rank per process over
  ``torch.distributed`` (``ranks = range(rank, rank + 1)``): NCCL on the
  card, gloo on the CPU, or gloo staged through pinned host buffers so that
  several processes can share one card.

The interface — what :mod:`repro_torch.snn.distributed` and
:mod:`repro_torch.core.hierarchical` call:

* :meth:`~Comm.all_gather` ``(x [n, L, ...], axis)`` → ``[n, k·L, ...]``,
  the axis group's ``k`` blocks in member order;
* :meth:`~Comm.ppermute` ``(x, pairs, axis)`` — ``x[src]`` lands on
  ``dst`` for every pair; a rank that no pair targets receives zeros,
  exactly as ``lax.ppermute`` gives it;
* :meth:`~Comm.psum` ``(x, axis)`` — the sum over the axis group, on
  every member;
* :meth:`~Comm.all_to_all` ``(x [n, k, ...], axis)`` — block ``j`` goes
  to the group's ``j``-th member; block ``j`` of the result came from it;
* :meth:`~Comm.psum_scatter` ``(x [n, L, ...], axis)`` — member ``j``
  receives the sum of every member's ``j``-th slab of ``L/k`` rows;
* :meth:`~Comm.collect` ``(x)`` — every rank's rows ``[n_dev, ...]``, on
  every rank and uncharged (for results read after a run);
* :meth:`~Comm.new_step`, :attr:`~Comm.step_bytes` and
  :meth:`~Comm.ledger_total` — the byte ledger.

Every call adds the bytes its ranks receive across the slow axis to the
current step of :attr:`~Comm.step_bytes`, each collective counted as its
direct exchange: one message from every peer of the axis group that sits
in another group (none over ``"inner"``, ``G - 1`` over ``"slow"``,
``n_dev - R`` over ``"joint"``), a ``ppermute`` one message per pair whose
ends lie in different groups.  That is the rule
``repro_torch.snn.sparse.exchange_messages`` and
``RaggedPlan.round_messages`` define, so one step's ledger summed over the
ranks (:meth:`~Comm.ledger_total`) equals ``exchange_volume`` for the
schedule the engine ran, in a process or in the loopback alike.  A step
replayed from a CUDA graph runs none of this Python: the graph records the
entry its capture charged and credits it once per replay
(:class:`repro_torch.graphs.StepGraph`), and the index tensors of
:meth:`LoopbackComm.ppermute` are made by the eager first step that comes
before any capture.  Fast-axis traffic (level-1 gathers, the bridge
re-broadcast) is level-1 territory and is not charged.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

__all__ = ["Comm", "LoopbackComm", "ProcessGroupComm"]

AXES = ("inner", "slow", "joint")


class Comm:
    """What the communicators share: the mesh, its axis groups and the
    ledger.  ``capturable``: a CUDA graph may capture the collectives."""

    capturable = True

    def __init__(self, mesh_shape: tuple[int, ...], device: torch.device | str):
        if len(mesh_shape) not in (1, 2) or min(mesh_shape) < 1:
            raise ValueError(f"mesh shape {mesh_shape} must be (G,) or (G, R)")
        self.mesh_shape = tuple(int(x) for x in mesh_shape)
        self.g = self.mesh_shape[0]
        self.r = self.mesh_shape[1] if len(self.mesh_shape) == 2 else 1
        self.n_dev = self.g * self.r
        self.device = torch.device(device)
        self.ranks = range(self.n_dev)
        self.step_bytes: list[int] = []

    # -- ledger -------------------------------------------------------------

    def new_step(self) -> None:
        """Open the ledger entry of the next simulation step."""
        self.step_bytes.append(0)

    def _charge(self, nbytes: int) -> None:
        if not self.step_bytes:
            self.new_step()
        self.step_bytes[-1] += int(nbytes)

    def ledger_total(self) -> list[int]:
        """Each step's bytes summed over every rank of the mesh."""
        return list(self.step_bytes)

    # -- axis groups --------------------------------------------------------

    def members(self, axis: str, rank: int) -> list[int]:
        """The global ranks of ``rank``'s group over ``axis``, in order."""
        if axis == "inner":
            lo = rank // self.r * self.r
            return list(range(lo, lo + self.r))
        if axis == "slow":
            return list(range(rank % self.r, self.n_dev, self.r))
        if axis == "joint":
            return list(range(self.n_dev))
        raise ValueError(f"unknown axis {axis!r}")

    def _remote(self, axis: str) -> int:
        """Peers of a rank's ``axis`` group that sit in another group."""
        if axis not in AXES:
            raise ValueError(f"unknown axis {axis!r}")
        return {"inner": 0, "slow": self.g - 1, "joint": self.n_dev - self.r}[axis]

    def _charge_axis(self, x: torch.Tensor, axis: str, parts: int = 1) -> None:
        """One message of ``x[0]``'s bytes (over ``parts``) from each
        remote peer, for every rank held."""
        per_rank = x[0].numel() * x.element_size() // parts
        self._charge(x.shape[0] * self._remote(axis) * per_rank)

    def _width(self, x: torch.Tensor, axis: str) -> int:
        """The ``axis`` group's size, which must divide ``x``'s dim 1."""
        k = len(self.members(axis, 0))
        if x.shape[1] % k:
            raise ValueError(f"dim 1 of {tuple(x.shape)} does not split over {k} ranks")
        return k


class LoopbackComm(Comm):
    """All ranks of a ``(G,)`` or ``(G, R)`` mesh, stacked on one device."""

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x [n_dev, L, ...]`` → every rank's concatenation over ``axis``:
        ``"inner"`` → ``[n_dev, R·L, ...]`` (its group), ``"slow"`` →
        ``[n_dev, G·L, ...]`` (its inner position across groups),
        ``"joint"`` → ``[n_dev, n_dev·L, ...]`` (every rank)."""
        n, rest = x.shape[0], tuple(x.shape[1:])
        flat = x.reshape(n, -1)
        length = flat.shape[1]
        g, r = self.g, self.r
        if axis == "inner":
            grp = flat.reshape(g, 1, r * length).expand(g, r, r * length)
            out, k = grp.reshape(n, r * length), r
        elif axis == "slow":
            col = flat.reshape(g, r, length).transpose(0, 1).reshape(1, r, g * length)
            out, k = col.expand(g, r, g * length).reshape(n, g * length), g
        elif axis == "joint":
            out, k = flat.reshape(1, n * length).expand(n, n * length), n
        else:
            raise ValueError(f"unknown axis {axis!r}")
        self._charge_axis(x, axis)
        return out.reshape(n, k * rest[0], *rest[1:])

    def ppermute(
        self, x: torch.Tensor, pairs: tuple[tuple[int, int], ...], axis: str
    ) -> torch.Tensor:
        """Send ``x[src]`` to ``dst`` for every pair; untargeted ranks get
        zeros.  ``axis="slow"``: ``pairs`` are group pairs and run once per
        inner position (rank ``gs·R+i`` → ``gd·R+i``); ``axis="joint"``:
        ``pairs`` are flat rank pairs."""
        src, dst, n_cross = _perm_index(
            tuple(pairs), axis, self.g, self.r, str(self.device)
        )
        out = torch.zeros_like(x)
        if src.numel():
            out[dst] = x[src]
        self._charge(n_cross * x[0].numel() * x.element_size())
        return out

    def psum(self, x: torch.Tensor, axis: str = "inner") -> torch.Tensor:
        """Sum over the ``axis`` group of each rank, result on every member
        (the engine's only psum: the ragged bridge re-broadcast, over
        ``"inner"``)."""
        g, r, rest = self.g, self.r, tuple(x.shape[1:])
        if axis == "inner":
            tot = x.reshape(g, r, *rest).sum(dim=1, keepdim=True)
            out = tot.expand(g, r, *rest).reshape(x.shape)
        elif axis == "slow":
            tot = x.reshape(g, r, *rest).sum(dim=0, keepdim=True)
            out = tot.expand(g, r, *rest).reshape(x.shape)
        elif axis == "joint":
            out = x.sum(dim=0, keepdim=True).expand(x.shape).contiguous()
        else:
            raise ValueError(f"unknown axis {axis!r}")
        self._charge_axis(x, axis)
        return out

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x [n_dev, k, ...]``: block ``j`` of each rank goes to the
        ``j``-th member of its ``axis`` group; block ``j`` of the result
        came from that member."""
        if x.shape[1] != len(self.members(axis, 0)):
            raise ValueError(f"all_to_all over {axis!r} needs one block per member")
        g, r, rest = self.g, self.r, tuple(x.shape[2:])
        if axis == "inner":
            out = x.reshape(g, r, r, *rest).transpose(1, 2)
        elif axis == "slow":
            out = x.reshape(g, r, g, *rest).transpose(0, 2)
        else:
            out = x.transpose(0, 1)
        self._charge_axis(x[:, 0], axis)
        return out.reshape(x.shape)

    def psum_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x [n_dev, L, ...]`` → ``[n_dev, L/k, ...]``: the ``j``-th
        member of each ``axis`` group holds the sum of the group's ``j``-th
        slabs."""
        k = self._width(x, axis)
        n, g, r = self.n_dev, self.g, self.r
        c, rest = x.shape[1] // k, tuple(x.shape[2:])
        if axis == "inner":
            out = x.reshape(g, r, r, c, *rest).sum(dim=1)
        elif axis == "slow":
            out = x.reshape(g, r, g, c, *rest).sum(dim=0).transpose(0, 1)
        else:
            out = x.reshape(n, n, c, *rest).sum(dim=0)
        self._charge_axis(x, axis, parts=k)
        return out.reshape(n, c, *rest)

    def collect(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows: the loopback holds them all already."""
        return x


class ProcessGroupComm(Comm):
    """One rank of a ``(G,)`` or ``(G, R)`` mesh per process, over the
    ``torch.distributed`` default group (initialised by the caller, world
    size = ``G·R``; rank ``d`` of the world is mesh rank ``d``).

    The sub-groups are made once, by every process in the same order: one
    per group of the mesh (``"inner"``) and one per inner position
    (``"slow"``); ``"joint"`` is the world.  The calls:
    :meth:`all_gather` → ``all_gather_into_tensor``, :meth:`ppermute` → one
    ``batch_isend_irecv`` (zeros where no pair lands), :meth:`psum` →
    ``all_reduce``, :meth:`all_to_all` → ``all_to_all_single``,
    :meth:`psum_scatter` → ``reduce_scatter_tensor``.  Each rank charges
    its own receipts; :meth:`ledger_total` sums them over the world.

    ``backend`` must be the process group's and match ``device``: ``"nccl"``
    takes CUDA tensors; ``"gloo"`` takes CPU tensors, or CUDA tensors staged
    through pinned host buffers (a copy each way per collective), so that
    several processes can share one card.  Nothing else is accepted, and
    gloo never stands in for NCCL.

    ``capturable``: a CUDA graph may capture NCCL's calls at world size 1,
    the only size at which a capture of them has run on a card (one card;
    its steps issue ``all_gather`` alone, since a one-rank ``ppermute`` is
    a local copy).  Across ranks NCCL ran in no test: neither its
    point-to-point calls nor any collective under capture, so there its
    steps run eagerly (``graph=True`` raises) until a run on several cards
    shows a capture to be right.  gloo's calls are never captured.
    """

    def __init__(self, mesh_shape: tuple[int, ...], backend: str,
                 device: torch.device | str):
        super().__init__(mesh_shape, device)
        kind = self.device.type
        if (backend, kind) not in (("nccl", "cuda"), ("gloo", "cpu"), ("gloo", "cuda")):
            raise ValueError(f"backend {backend!r} does not take {kind} tensors")
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs torch.distributed.init_process_group")
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
        if dist.get_world_size() != self.n_dev:
            raise ValueError(
                f"world size {dist.get_world_size()} != {self.n_dev} ranks of mesh {mesh_shape}"
            )
        if kind == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = backend
        self.staged = backend == "gloo" and kind == "cuda"
        self.capturable = backend == "nccl" and self.n_dev == 1
        self.rank = dist.get_rank()
        self.ranks = range(self.rank, self.rank + 1)
        self._groups = {"joint": dist.group.WORLD}
        for axis, heads in (("inner", range(0, self.n_dev, self.r)), ("slow", range(self.r))):
            for head in heads:
                ranks = self.members(axis, head)
                grp = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = grp
        self._pinned: dict[tuple, torch.Tensor] = {}
        if backend == "nccl":
            # NCCL asks every rank of a group to join the group's first
            # batch_isend_irecv; a ppermute posts ops on its pairs' ranks
            # only, so a collective over the world comes first
            dist.all_reduce(torch.zeros(1, device=self.device))

    # -- the wire: the tensors a backend takes ------------------------------

    def _one(self, x: torch.Tensor) -> None:
        if x.shape[0] != 1 or x.device != self.device:
            raise ValueError(
                f"a process rank takes [1, ...] on {self.device}, got "
                f"{tuple(x.shape)} on {x.device}"
            )

    def _buffer(self, slot: str, shape, dtype) -> torch.Tensor:
        """A pinned host buffer, kept for the next call of this shape."""
        key = (slot, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        return buf

    def _wire(self, x: torch.Tensor, slot: str = "in", written: bool = False) -> torch.Tensor:
        """``x`` as the backend takes it: contiguous on the device (a copy
        where the call writes it), or staged, a pinned host copy (the
        device → host copy waits for the card)."""
        if not self.staged:
            return x.clone(memory_format=torch.contiguous_format) if written else x.contiguous()
        return self._buffer(slot, x.shape, x.dtype).copy_(x)

    def _out(self, shape, dtype, slot: str = "out") -> torch.Tensor:
        if self.staged:
            return self._buffer(slot, shape, dtype)
        return torch.empty(tuple(shape), dtype=dtype, device=self.device)

    def _home(self, y: torch.Tensor) -> torch.Tensor:
        """A result on the device (staged: copied before the buffer is
        reused)."""
        return y.to(self.device) if self.staged else y

    def _group(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"unknown axis {axis!r}")
        return self._groups[axis]

    # -- collectives --------------------------------------------------------

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        self._one(x)
        grp, k = self._group(axis), len(self.members(axis, self.rank))
        inp = self._wire(x[0])
        out = self._out((k * inp.shape[0], *inp.shape[1:]), x.dtype)
        _all_gather(out, inp, group=grp)
        self._charge_axis(x, axis)
        return self._home(out)[None]

    def ppermute(
        self, x: torch.Tensor, pairs: tuple[tuple[int, int], ...], axis: str
    ) -> torch.Tensor:
        self._one(x)
        flat, _ = _flat_pairs(tuple(pairs), axis, self.g, self.r)
        me = self.rank
        sources = [s for s, d in flat if d == me]
        ops, buf = [], None
        dsts = [d for s, d in flat if s == me and d != me]
        if dsts:
            send = self._wire(x[0], "send")
            ops += [dist.P2POp(dist.isend, send, d) for d in dsts]
        if sources and sources[0] != me:
            buf = self._out(x.shape[1:], x.dtype, "recv")
            ops.append(dist.P2POp(dist.irecv, buf, sources[0]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if not sources:
            out = torch.zeros_like(x)
        elif buf is None:  # a rank sends to itself
            out = x.clone()
        else:
            out = self._home(buf)[None]
            if sources[0] // self.r != me // self.r:
                self._charge(x[0].numel() * x.element_size())
        return out

    def psum(self, x: torch.Tensor, axis: str = "inner") -> torch.Tensor:
        self._one(x)
        grp = self._group(axis)
        t = self._wire(x[0], written=True)
        dist.all_reduce(t, group=grp)
        self._charge_axis(x, axis)
        return self._home(t)[None]

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        self._one(x)
        if x.shape[1] != len(self.members(axis, self.rank)):
            raise ValueError(f"all_to_all over {axis!r} needs one block per member")
        grp = self._group(axis)
        inp = self._wire(x[0])
        out = self._out(inp.shape, x.dtype)
        dist.all_to_all_single(out, inp, group=grp)
        self._charge_axis(x[:, 0], axis)
        return self._home(out)[None]

    def psum_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        self._one(x)
        k = self._width(x, axis)
        grp = self._group(axis)
        inp = self._wire(x[0])
        out = self._out((inp.shape[0] // k, *inp.shape[1:]), x.dtype)
        _reduce_scatter(out, inp, group=grp)
        self._charge_axis(x, axis, parts=k)
        return self._home(out)[None]

    def collect(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows ``[n_dev, ...]`` on every rank (uncharged)."""
        self._one(x)
        inp = self._wire(x, "collect")
        out = self._out((self.n_dev, *inp.shape[1:]), x.dtype, "collected")
        _all_gather(out, inp)
        return self._home(out)

    def ledger_total(self) -> list[int]:
        """Each step's bytes summed over the world (a collective: every
        rank calls it)."""
        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        t = torch.tensor(self.step_bytes, dtype=torch.int64, device=dev)
        dist.all_reduce(t)
        return [int(v) for v in t.tolist()]


# the names torch gives these calls now (older releases: *_into_tensor / *_tensor)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@functools.lru_cache(maxsize=256)
def _flat_pairs(
    pairs: tuple[tuple[int, int], ...], axis: str, g: int, r: int
) -> tuple[tuple[tuple[int, int], ...], int]:
    """A ppermute's flat ``(src, dst)`` rank pairs, checked, and how many
    of its messages cross the slow axis."""
    if axis == "slow":
        flat = [(gs * r + i, gd * r + i) for gs, gd in pairs for i in range(r)]
    elif axis == "joint":
        flat = list(pairs)
    else:
        raise ValueError(f"unknown axis {axis!r}")
    n = g * r
    dsts = [d for _, d in flat]
    if any(not (0 <= s < n and 0 <= d < n) for s, d in flat):
        raise ValueError(f"ppermute pairs {pairs} outside {n} ranks")
    if len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute pairs {pairs} target a rank twice")
    return tuple(flat), sum(1 for s, d in flat if s // r != d // r)


@functools.lru_cache(maxsize=256)
def _perm_index(
    pairs: tuple[tuple[int, int], ...], axis: str, g: int, r: int, device: str
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Source / destination rank indices of a ppermute, and how many of its
    messages cross the slow axis."""
    flat, n_cross = _flat_pairs(pairs, axis, g, r)
    src = torch.tensor([s for s, _ in flat], dtype=torch.long, device=device)
    dst = torch.tensor([d for _, d in flat], dtype=torch.long, device=device)
    return src, dst, n_cross

