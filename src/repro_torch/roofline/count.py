"""Per-chip counts of one step by dispatch — the port's counterpart of
``repro/roofline/hlo.py``.

The reference reads the post-SPMD HLO of a compiled step.  The port has no
HLO: :func:`count` runs the step once under a ``TorchDispatchMode`` with its
tensors on the ``meta`` device (shape and dtype, no data: nothing is
computed or allocated) and its parameters as meta DTensors on a
``DeviceMesh`` of the ``fake`` process-group backend (every rank but this
one imagined), and counts what rank 0 does.  The mode declines DTensor
arguments, so DTensor unwraps them and runs each local op through the mode:
the counts are rank 0's local shapes, per chip as the reference's
post-partitioning HLO is.  The global-shape ops DTensor's sharding
propagation runs under its own ``FakeTensorMode`` are not counted.

* **FLOPs**: ``torch.utils.flop_counter``'s formulas (products,
  convolutions, attention); elementwise ops and reductions count none.
* **HBM bytes**: the reference's fusion model (``hlo.py:50-59``): only ops
  that materialise data are charged, their results' and operands' bytes
  (products, reductions, gathers and scatters, index copies, ``cat``,
  pads, copies); elementwise ops and dtype casts ride along free.  A
  kernel's plain version (on meta tensors ``kernels/ops.py`` announces it,
  :mod:`repro_torch.kernels._meta`) is charged as the kernel is: its
  inputs and outputs once, its products' FLOPs, not the intermediates the
  kernel keeps on chip.
* **Collectives**: the ``_c10d_functional`` ops DTensor (and the sharded
  decode's combine) issue, each with its group's size and ranks from its
  process group, operand and ring bytes by the reference's formulas
  (``hlo.py:378-390``), and ``cross_pod`` when the group's ranks lie in
  more than one pod of ``pod_size`` ranks.  On a CPU mesh DTensor runs an
  all-to-all as an all-gather and a chunk (gloo has none); the count
  charges it as the all-to-all a mesh of cards runs.
* **Peak live bytes** (an estimate, ``Totals.peak_bytes``): the largest sum,
  over the step, of the op outputs still referenced from Python, a tensor
  counting from the op that makes it until its last Python reference dies
  (a tensor autograd saves without one leaves the count early).
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections.abc import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _meta

__all__ = ["Totals", "count", "top_collectives"]

aten = torch.ops.aten

#: ops that materialise data (the reference's ``_HBM_OPS``, in aten)
_HBM_OPS = {
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.argmax,
    aten.argmin, aten.logsumexp, aten._softmax, aten._log_softmax, aten.cumsum,
    aten.prod, aten.any, aten.all, aten.var_mean, aten.linalg_vector_norm,
    aten.gather, aten.scatter, aten.scatter_add, aten.scatter_reduce, aten.index,
    aten.index_select, aten.index_put, aten.index_put_, aten.index_add, aten.index_add_,
    aten.index_copy, aten.index_copy_, aten.embedding, aten.embedding_dense_backward,
    aten.cat, aten.constant_pad_nd, aten.clone, aten.copy_, aten.slice_scatter,
    aten.select_scatter, aten.sort, aten.topk,
}

_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


@dataclasses.dataclass
class Totals:
    """``HloTotals``' fields and ``add``; and, from :func:`count`, the peak
    of live bytes and one row per collective call (:func:`top_collectives`)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_operand_bytes: float = 0.0
    coll_ring_bytes: float = 0.0
    cross_pod_bytes: float = 0.0
    coll_counts: dict[str, int] = dataclasses.field(default_factory=dict)
    coll_bytes_by_kind: dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0
    rows: list[dict] = dataclasses.field(default_factory=list)

    def add(self, other: "Totals", mult: float = 1.0):
        self.flops += mult * other.flops
        self.hbm_bytes += mult * other.hbm_bytes
        self.coll_operand_bytes += mult * other.coll_operand_bytes
        self.coll_ring_bytes += mult * other.coll_ring_bytes
        self.cross_pod_bytes += mult * other.cross_pod_bytes
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + int(mult * v)
        for k, v in other.coll_bytes_by_kind.items():
            self.coll_bytes_by_kind[k] = self.coll_bytes_by_kind.get(k, 0.0) + mult * v


def _nbytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0.0


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _site() -> str:
    """``file:line function`` of the innermost frame of the port's model
    code that led here."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and "roofline" not in name:
            return f"{name.split('repro_torch/')[-1]}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return ""


def _in_alltoall() -> bool:
    """Called from DTensor's all-to-all (run as an all-gather on a CPU mesh)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


class _Counter(TorchDispatchMode):
    def __init__(self, pod_size: int):
        super().__init__()
        self.t = Totals()
        self.pod_size = pod_size
        self.kernel_depth = 0
        self.live = 0.0

    # -- kernels' plain versions (kernels/_meta.py) --------------------------
    def on_kernel(self, event: str, name: str, tensors: tuple) -> None:
        if event == "enter":
            self.kernel_depth += 1
            self.t.hbm_bytes += _nbytes(tensors)
        else:
            self.kernel_depth -= 1
            self.t.hbm_bytes += _nbytes(tensors)
            for x in _tensors(tensors):
                self._track(x)

    def _track(self, x: torch.Tensor) -> None:
        n = float(x.numel() * x.element_size())
        self.live += n
        self.t.peak_bytes = max(self.t.peak_bytes, self.live)
        weakref.finalize(x, self._free, n)

    def _free(self, n: float) -> None:
        self.live -= n

    # -- every op ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor unwraps and runs the local op through here
        if func.namespace in ("_c10d_functional", "_dtensor"):
            out = _meta_collective(func, args)
            out = func(*args, **kwargs) if out is None else out
            if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is None:
                self._collective(func, args, out)
            return out
        if func is aten.equal.default and args[0].device.type == "meta":
            # meta tensors hold no values to compare: DTensor asks whether a
            # vocab-parallel embedding's mask is the one it kept (musicgen's
            # codebooks share one), and the step's ops are the same either way
            return True
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's propagation of global shapes, not rank 0's work
        packet = func._overloadpacket
        from torch.utils.flop_counter import flop_registry

        if packet in flop_registry:
            self.t.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if self.kernel_depth:
            return out
        if packet in _HBM_OPS:
            self.t.hbm_bytes += _nbytes(out) + sum(_nbytes(a) for a in args)
        if not any(r.alias_info for r in func._schema.returns):  # a new tensor
            for x in _tensors(out):
                self._track(x)
        return out

    def _collective(self, func, args, out) -> None:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        name = func._overloadpacket.__name__
        kind = "all-to-all" if name == "shard_dim_alltoall" else _KINDS.get(name)
        if kind is None:  # wait_tensor, _wrap_tensor_autograd, ...
            return
        group = next(a for a in reversed(args) if isinstance(a, str))
        ranks = dist.get_process_group_ranks(_resolve_process_group(group))
        g = len(ranks)
        rb = _nbytes(out)
        if kind == "all-gather" and _in_alltoall():
            kind, rb = "all-to-all", rb / g  # what the chunk keeps: an all-to-all's result
        if kind == "all-gather":
            operand_b = rb / max(g, 1)
            ring_b = rb - operand_b
        elif kind == "reduce-scatter":
            operand_b = rb * g
            ring_b = operand_b * (g - 1) / max(g, 1)
        elif kind == "all-reduce":
            operand_b = rb
            ring_b = 2.0 * rb * (g - 1) / max(g, 1)
        else:  # all-to-all, broadcast
            operand_b = rb
            ring_b = rb * (g - 1) / max(g, 1) if g > 1 else rb
        t = self.t
        t.coll_operand_bytes += operand_b
        t.coll_ring_bytes += ring_b
        t.coll_counts[kind] = t.coll_counts.get(kind, 0) + 1
        t.coll_bytes_by_kind[kind] = t.coll_bytes_by_kind.get(kind, 0.0) + operand_b
        cross = len({r // self.pod_size for r in ranks}) > 1
        if cross:
            t.cross_pod_bytes += ring_b
        x = _tensors(out)[0]
        shape = f"{str(x.dtype).split('.')[-1]}{list(x.shape)}"
        t.rows.append({"ring_bytes": ring_b, "kind": kind, "shape": shape, "group": g,
                       "cross_pod": cross, "op_name": _site()})


def _meta_collective(func, args):
    """The result of a functional collective on a meta tensor, made here
    from its shape (the fake backend's own builds one empty tensor a rank
    and concatenates them, which at 256 ranks is most of a count's time);
    ``None`` where the op or the device is not one of these."""
    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if x is None or x.device.type != "meta":
        return None
    name = func._overloadpacket.__name__
    if name in ("wait_tensor", "all_reduce_"):
        return x
    if name in ("all_reduce", "broadcast"):
        return torch.empty_like(x)
    if name == "all_gather_into_tensor":
        return x.new_empty((x.shape[0] * args[1], *x.shape[1:]))
    if name == "reduce_scatter_tensor":
        return x.new_empty((x.shape[0] // args[2], *x.shape[1:]))
    if name == "all_to_all_single":
        rows = sum(args[1]) if args[1] else x.shape[0]
        return x.new_empty((rows, *x.shape[1:]))
    return None


def count(fn: Callable, *args, n_devices: int, pod_size: int | None = None, **kwargs) -> Totals:
    """The per-chip :class:`Totals` of ``fn(*args, **kwargs)``, run once
    under the counter (see the module docstring).  ``n_devices``: the
    mesh's ranks; ``pod_size``: ranks per pod (for cross-pod traffic),
    default ``n_devices`` (nothing crosses)."""
    counter = _Counter(pod_size or n_devices)
    with _meta.listening(counter.on_kernel), counter:
        fn(*args, **kwargs)
    return counter.t


def top_collectives(totals: Totals, k: int = 12) -> list[dict]:
    """The collectives of a count ranked by ring bytes, calls of one kind,
    shape, group size and call site merged (``mult`` the number of calls,
    ``ring_bytes`` their sum): the reference's ``top_collectives``
    (``hlo.py:408``) over the dispatched calls."""
    merged: dict[tuple, dict] = {}
    for r in totals.rows:
        key = (r["kind"], r["shape"], r["group"], r["cross_pod"], r["op_name"])
        row = merged.setdefault(key, {**r, "ring_bytes": 0.0, "mult": 0})
        row["ring_bytes"] += r["ring_bytes"]
        row["mult"] += 1
    rows = sorted(merged.values(), key=lambda r: -r["ring_bytes"])
    return rows[:k]
