"""Loopback communicator: every logical rank of a mesh on one device.

The counterpart of the ``shard_map`` collectives the reference engine
issues (``repro/snn/distributed.py:299-304`` and ``:533-599``).  All
``n_dev`` ranks of a ``(G,)`` or ``(G, R)`` mesh live in one process as
rank-stacked tensors ``[n_dev, ...]``; rank ``g·R + i`` is position ``i``
of group ``g``.  Axis 0 of the mesh is the slow axis (across groups), the
rest is the fast ``inner`` axis (inside a group).

* :meth:`LoopbackComm.all_gather` — over ``"inner"``, ``"slow"`` or
  ``"joint"`` (all axes): a reshape / broadcast;
* :meth:`LoopbackComm.ppermute` — a gather by pair list; a rank that no
  pair targets receives zeros, exactly as ``lax.ppermute`` gives it;
* :meth:`LoopbackComm.psum` over the inner axis — a sum over the
  group's ranks.

Every call adds the bytes it moves across the slow axis to the current
step of :attr:`LoopbackComm.step_bytes`, counted per message as
``repro_torch.snn.sparse.exchange_messages`` and
``RaggedPlan.round_messages`` define them, so one step's ledger equals
``exchange_volume`` for the schedule the engine ran.  A step replayed from
a CUDA graph runs none of this Python: the graph records the entry its
capture charged and credits it once per replay
(:class:`repro_torch.graphs.StepGraph`), and the index tensors of
:meth:`LoopbackComm.ppermute` are made by the eager first step that comes
before any capture.  Fast-axis traffic
(level-1 gathers, the bridge re-broadcast) is level-1 territory and is
not charged.  A ``torch.distributed``/NCCL backend behind this interface
is a later slice of the port.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["LoopbackComm"]


class LoopbackComm:
    """All ranks of a ``(G,)`` or ``(G, R)`` mesh, stacked on one device."""

    def __init__(self, mesh_shape: tuple[int, ...], device: torch.device | str):
        if len(mesh_shape) not in (1, 2) or min(mesh_shape) < 1:
            raise ValueError(f"mesh shape {mesh_shape} must be (G,) or (G, R)")
        self.mesh_shape = tuple(int(x) for x in mesh_shape)
        self.g = self.mesh_shape[0]
        self.r = self.mesh_shape[1] if len(self.mesh_shape) == 2 else 1
        self.n_dev = self.g * self.r
        self.device = torch.device(device)
        self.step_bytes: list[int] = []

    # -- ledger -------------------------------------------------------------

    def new_step(self) -> None:
        """Open the ledger entry of the next simulation step."""
        self.step_bytes.append(0)

    def _charge(self, nbytes: int) -> None:
        if not self.step_bytes:
            self.new_step()
        self.step_bytes[-1] += int(nbytes)

    # -- collectives --------------------------------------------------------

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x [n_dev, L]`` → every rank's concatenation over ``axis``:
        ``"inner"`` → ``[n_dev, R·L]`` (its group), ``"slow"`` →
        ``[n_dev, G·L]`` (its inner position across groups), ``"joint"``
        → ``[n_dev, n_dev·L]`` (every rank)."""
        n, length = x.shape
        g, r = self.g, self.r
        nbytes = length * x.element_size()
        if axis == "inner":
            grp = x.reshape(g, 1, r * length).expand(g, r, r * length)
            return grp.reshape(n, r * length)
        if axis == "slow":
            # each rank receives the G-1 blocks of its inner column
            self._charge(n * (g - 1) * nbytes)
            col = x.reshape(g, r, length).transpose(0, 1).reshape(1, r, g * length)
            return col.expand(g, r, g * length).reshape(n, g * length)
        if axis == "joint":
            # each rank receives the n - R blocks held outside its group
            self._charge(n * (n - r) * nbytes)
            return x.reshape(1, n * length).expand(n, n * length)
        raise ValueError(f"unknown axis {axis!r}")

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

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ``inner`` ranks of each group, result on every one
        (the engine's only psum: the ragged bridge re-broadcast)."""
        g, r = self.g, self.r
        tot = x.reshape(g, r, *x.shape[1:]).sum(dim=1, keepdim=True)
        return tot.expand(g, r, *x.shape[1:]).reshape(x.shape)


@functools.lru_cache(maxsize=256)
def _perm_index(
    pairs: tuple[tuple[int, int], ...], axis: str, g: int, r: int, device: str
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Source / destination rank indices of a ppermute, and how many of its
    messages cross the slow axis."""
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
    n_cross = sum(1 for s, d in flat if s // r != d // r)
    src = torch.tensor([s for s, _ in flat], dtype=torch.long, device=device)
    dst = torch.tensor(dsts, dtype=torch.long, device=device)
    return src, dst, n_cross
