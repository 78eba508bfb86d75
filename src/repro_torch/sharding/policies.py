"""Sharding policies — how every tensor maps onto the production mesh.

Port of ``repro/sharding/policies.py`` onto DTensor: a
:class:`torch.distributed.device_mesh.DeviceMesh` takes the place of the
JAX ``Mesh``, DTensor's per-op sharding propagation the place of XLA's SPMD
partitioner, and ``DTensor.redistribute`` the place of
``with_sharding_constraint``.

Axis roles (the reference's):

* ``pod``   — pure data parallelism between pods.  Parameters are
  replicated across pods; the only cross-pod traffic is the per-step
  gradient all-reduce.  ``fsdp_over_pod`` extends FSDP across pods.
* ``data``  — batch parallelism + FSDP: parameters and optimizer state are
  sharded over this axis and all-gathered where a layer uses them.
* ``model`` — tensor parallelism: MLP hidden, expert, vocab and
  attention-sequence dims.

A :class:`PartitionSpec` names, for each tensor dim, ``None`` (replicated),
one mesh axis or a tuple of them (major to minor), exactly as the
reference's ``jax.sharding.PartitionSpec`` does entry by entry.
:meth:`ShardingPolicy.placements` turns it into DTensor placements, one per
mesh dim: ``Shard(d)`` where the axis names tensor dim ``d``, else
``Replicate()``.  DTensor splits a tensor dim over several mesh dims in
mesh-dim order, the first one major, so a tuple entry must list its axes
in the mesh's order (every role of the policy does: ``("pod", "data")``,
``("pod", "model")``), which is JAX's major-to-minor layout.  DTensor cuts
an uneven dim as ``torch.chunk`` does (shards of ``ceil(n / k)`` rows, the
last ones shorter or empty), where JAX pads every shard to ``ceil(n / k)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Iterator
from typing import Any

import torch

__all__ = ["PartitionSpec", "ShardingPolicy", "make_policy", "replicated_constants"]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names.  A one-name tuple is stored as the name (the reference's ``P``
    does the same), so two specs are equal exactly when JAX's are."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        out = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            out.append(e)
        return super().__new__(cls, out)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes_of(self, dim: int) -> tuple[str, ...]:
        """The mesh axes tensor dim ``dim`` is split over, major first."""
        e = self[dim]
        return (e,) if isinstance(e, str) else (e or ())

    def axes(self) -> list[tuple[int, str]]:
        """``(tensor dim, mesh axis)`` for every axis named, major first."""
        return [(d, a) for d in range(len(self)) for a in self.axes_of(d)]


@contextlib.contextmanager
def replicated_constants() -> Iterator[None]:
    """Inside, a plain tensor that meets a DTensor counts as replicated on
    every mesh dim (DTensor's ``implicit_replication``): the constants a
    layer makes — positions, masks, zeros to pad with, running softmax
    statistics — are the same on every rank.  Unlike the public context
    manager this one nests: it puts back the setting it found."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    before = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = before


def is_dtensor(x: Any) -> bool:
    """``x`` is a DTensor (without importing DTensor where torch lacks
    ``torch.distributed``)."""
    if not isinstance(x, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Resolves logical dim roles to mesh axes (or no-ops without a mesh).

    Roles: 'batch' (pod+data), 'batch_minus_ep' (batch without the axes
    expert parallelism claims), 'fsdp' (data [+pod]), 'tp' (model), 'ep'
    (expert-parallel axes), None (replicated).
    """

    mesh: Any = None  # a DeviceMesh with mesh_dim_names, or None
    batch_axes: tuple[str, ...] = ()
    fsdp_axes: tuple[str, ...] = ()
    tp_axis: str | None = None
    ep_axes: tuple[str, ...] = ()
    # attention head/seq reshard strategy (the reference's):
    #   'a2a'    — project with natural feature sharding, then an
    #              activation all-to-all into sequence sharding
    #   'gather' — constrain q to sequence sharding directly
    attn_mode: str = "a2a"

    def resolve(self, role: str | None):
        if role is None:
            return None
        if role == "batch":
            return self.batch_axes or None
        if role == "batch_minus_ep":
            # batch sharding on tensors that also carry an 'ep' dim — drop
            # axes claimed by expert parallelism (a mesh axis may appear
            # at most once per spec)
            axes = tuple(a for a in self.batch_axes if a not in self.ep_axes)
            return axes or None
        if role == "fsdp":
            return self.fsdp_axes or None
        if role == "tp":
            return self.tp_axis
        if role == "ep":
            return self.ep_axes or None
        raise ValueError(role)

    def spec(self, *roles: str | None) -> PartitionSpec:
        return PartitionSpec(*[self.resolve(r) for r in roles])

    def placements(self, spec: PartitionSpec) -> tuple:
        """DTensor placements of ``spec`` on the mesh, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        if self.mesh is None:
            raise ValueError("a policy without a mesh has no placements")
        names = tuple(self.mesh.mesh_dim_names)
        out: list = [Replicate()] * len(names)
        seen: dict[int, int] = {}  # tensor dim -> the last mesh dim it took
        for d, axis in spec.axes():
            if axis not in names:
                raise ValueError(f"{spec}: axis {axis!r} is not in the mesh {names}")
            m = names.index(axis)
            if not isinstance(out[m], Replicate):
                raise ValueError(f"{spec}: mesh axis {axis!r} appears twice")
            if seen.get(d, -1) > m:
                raise ValueError(f"{spec}: axes of dim {d} are not in the mesh's order {names}")
            seen[d] = m
            out[m] = Shard(d)
        return tuple(out)

    def shard(self, x: torch.Tensor, *roles: str | None) -> torch.Tensor:
        """``x`` redistributed to the roles' placements when a mesh is
        attached (the reference's ``with_sharding_constraint``), else
        ``x`` itself.  With a mesh, ``x`` must be a DTensor on it."""
        if self.mesh is None:
            return x
        if not is_dtensor(x):
            raise TypeError(f"pol.shard{roles}: a plain {type(x).__name__} under a mesh")
        if len(roles) != x.ndim:
            raise ValueError(f"pol.shard{roles}: {len(roles)} roles for a {x.ndim}-d tensor")
        return x.redistribute(self.mesh, self.placements(self.spec(*roles)))

    def named(self, *roles: str | None) -> Any:
        """``(mesh, placements)`` of the roles, or ``None`` without a mesh."""
        if self.mesh is None:
            return None
        return self.mesh, self.placements(self.spec(*roles))

    def named_from_spec(self, spec: PartitionSpec) -> Any:
        if self.mesh is None:
            return None
        return self.mesh, self.placements(spec)

    def constants(self):
        """:func:`replicated_constants` under a mesh, else nothing."""
        return replicated_constants() if self.mesh is not None else contextlib.nullcontext()

    def _size(self, axis: str) -> int:
        return self.mesh.size(tuple(self.mesh.mesh_dim_names).index(axis))

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self._size(self.tp_axis)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.batch_axes:
            n *= self._size(a)
        return n


def make_policy(
    mesh: Any,
    *,
    fsdp_over_pod: bool = False,
    ep_over_pod: bool = False,
    attn_mode: str = "a2a",
) -> ShardingPolicy:
    """Derive the policy from the mesh's axis names.

    Meshes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
    multi-pod.  ``fsdp_over_pod`` / ``ep_over_pod`` extend FSDP /
    expert-parallel sharding across the pod boundary.
    """
    if mesh is None:
        return ShardingPolicy()
    names = tuple(mesh.mesh_dim_names)
    has_pod = "pod" in names
    batch = ("pod", "data") if has_pod else ("data",)
    fsdp = ("pod", "data") if (has_pod and fsdp_over_pod) else ("data",)
    ep = ("pod", "model") if (has_pod and ep_over_pod) else ("model",)
    return ShardingPolicy(
        mesh=mesh,
        batch_axes=tuple(a for a in batch if a in names),
        fsdp_axes=tuple(a for a in fsdp if a in names),
        tp_axis="model" if "model" in names else None,
        ep_axes=tuple(a for a in ep if a in names),
        attn_mode=attn_mode,
    )
