"""The training step: microbatched gradient accumulation + optional
gradient compression + AdamW — the port of ``repro.train.train_step``.

The batch ``[B, ...]`` is split into ``n_microbatches`` of ``B/n``; each
microbatch's loss is differentiated with ``torch.autograd.grad`` over the
parameter leaves (its activations freed before the next), the gradients
summed in float32 and divided by ``n`` at the end, as the reference's
``lax.scan`` over microbatches does.  With one microbatch the gradients
keep each parameter's dtype, as ``jax.value_and_grad``'s do.

:func:`make_train_step` runs op by op and reads nothing back to the host.
:class:`CompiledTrainStep` (built by :func:`compile_train_step`, which the
launcher uses) is the port's counterpart of the reference's ``jax.jit`` of
the step (``repro/launch/train.py:62``): the same step over static state —
the first call's parameters, moments, master, count and residuals, and one
set of batch buffers per batch shape — run eagerly on the CPU and, on the
card, run once eagerly and then replayed from a CUDA graph of one step per
batch shape (:mod:`repro_torch.graphs`).

Under a policy with a mesh (``pol``, :mod:`repro_torch.sharding`) the
parameters are DTensors laid out by ``lm.distribute_params``, the batch
is split over the batch axes (``lm.distribute_batch``), and DTensor
propagates the layout through every op, as XLA's partitioner does for the
reference's ``pol.shard`` constraints.  Each gradient comes back
redistributed to its parameter's placements: a partial sum over the batch
axes is reduce-scattered onto an FSDP shard or all-reduced onto a
replicated leaf, the reduction the reference's compiler inserts.  The
returned loss is the replicated value as a plain 0-d tensor, so the
``Supervisor`` reads it as on one device.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from repro_torch import graphs
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.sharding.policies import ShardingPolicy, is_dtensor
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, adamw_update, tree_leaves, tree_map

__all__ = ["TrainStepConfig", "make_train_step", "make_grad_fn", "CompiledTrainStep",
           "compile_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    n_microbatches: int = 1
    adamw: AdamWConfig = AdamWConfig()
    compression: str = "none"  # none | int8_ef | topk_ef


def _split_microbatches(batch: dict, n: int) -> dict:
    """[B, ...] → [n, B/n, ...] for every leaf."""
    return tree_map(lambda x: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])), batch)


def _local_scalar(x: torch.Tensor) -> torch.Tensor:
    """A 0-d DTensor as its value on every rank (a pending partial sum over
    the batch axes is reduced first); a tensor as itself."""
    return x.full_tensor() if is_dtensor(x) else x


def make_grad_fn(cfg: ArchConfig, n_microbatches: int,
                 pol: ShardingPolicy = ShardingPolicy()) -> Callable:
    """(params, batch) → (mean loss, grads) with grad accumulation.

    The parameters need not require grad: each leaf is differentiated
    through a detached alias of it (same storage), so plain tensors — a
    checkpoint restored by the ``Supervisor`` — train as leaves that
    require grad do.  The loss is a detached 0-d float32 tensor.  Under a
    mesh each gradient has its parameter's placements."""

    def value_and_grad(params, batch):
        xs = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(xs)
        with pol.constants():  # the backward's recompute makes constants too
            loss = lm.loss_fn(xs, batch, cfg, pol)
            grads = torch.autograd.grad(loss, leaves)
            if pol.mesh is not None:
                grads = [g.redistribute(x.device_mesh, x.placements)
                         for g, x in zip(grads, leaves)]
        by_id = dict(zip(map(id, leaves), grads))
        return _local_scalar(loss.detach()), tree_map(lambda x: by_id[id(x)], xs)

    def grad_fn(params, batch):
        # a plain batch is split into microbatches here and each one laid
        # out over the batch axes by ``loss_fn``
        if n_microbatches == 1:
            return value_and_grad(params, batch)
        mbs = _split_microbatches(batch, n_microbatches)
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        loss_sum = None
        for i in range(n_microbatches):
            loss, g = value_and_grad(params, tree_map(lambda x: x[i], mbs))
            tree_map(lambda acc, gi: acc.add_(gi), gsum, g)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            del g
        inv = 1.0 / n_microbatches
        return loss_sum * inv, tree_map(lambda g: g.mul_(inv), gsum)

    return grad_fn


def make_train_step(cfg: ArchConfig, ts: TrainStepConfig = TrainStepConfig(),
                    pol: ShardingPolicy = ShardingPolicy()) -> Callable:
    """Build ``train_step(params, opt_state, batch) -> (loss, params,
    opt_state, metrics)``, the signature the ``Supervisor`` drives.

    ``batch``: ``tokens`` and ``labels`` [B, S] integer tensors on the
    parameters' device.  The parameters, moments and master are updated in
    place (:func:`repro_torch.train.optimizer.adamw_update`) and returned.
    Under a mesh (``pol``) the parameters are DTensors
    (``lm.distribute_params``) and so are the moments and master."""
    grad_fn = make_grad_fn(cfg, ts.n_microbatches, pol)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        if ts.compression != "none":
            grads, opt_state = compression.apply(ts.compression, grads, opt_state, pol)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, ts.adamw)
        metrics["loss"] = loss
        return loss, params, opt_state, metrics

    return train_step


def _same_leaves(a, b) -> bool:
    """Whether two trees of dicts hold the same tensor objects."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_leaves(a[k], b[k]) for k in a)
    return a is b


def _copy_into(dst, src, path: str = "") -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` in place
    (a leaf that is already ``dst``'s is left alone)."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or dst.keys() != src.keys():
            raise ValueError(f"state {path or '/'} does not have the step's keys")
        for k in dst:
            _copy_into(dst[k], src[k], f"{path}/{k}")
    elif src is not dst:
        dst.copy_(src)


class CompiledTrainStep:
    """``train_step(params, opt_state, batch) -> (loss, params, opt_state,
    metrics)`` over static state, the signature the ``Supervisor`` drives.

    * **Static state.**  The first call's ``params`` and ``opt_state``
      tensors become the step's own (with compression, zero residuals are
      added when ``opt_state`` has none, as :func:`compression.apply`
      would make them) and are updated in place on every call; each call
      returns them.  When the caller hands back other tensors — the
      ``Supervisor`` after a rollback or ``resume_with`` — they are copied
      into the static ones in place (missing residuals are zeroed), and
      nothing is captured again.
    * **Batches.**  Each batch shape (the keys, shapes and dtypes of
      ``batch``: ``tokens``, ``labels``, a vlm's ``vision_embed``, an
      audio config's codebook streams) gets static buffers of its own on
      the device, and the batch is copied into them before the step runs,
      outside any capture (a pageable host-to-device copy cannot be
      captured).
    * **Replay** (``graph``; ``None``: on the card yes, on the CPU no;
      ``True`` on the CPU raises ``ValueError``): each batch shape's step
      runs eagerly at its first call and is captured at its second and
      replayed from then on (:class:`repro_torch.graphs.StepGraph`, a
      memory pool of its own), the microbatch loop, the layers' recompute
      (``torch.utils.checkpoint``), the gradient compression and AdamW
      inside the graph.  The returned loss and metrics are the graph's
      static outputs: valid until the next call, as the ``Supervisor``'s
      ``float(loss)`` and its non-finite check read them at once.
      ``Checkpointer.save_async`` copies every leaf to the host on the
      caller's thread before it returns, so its snapshot is taken before
      the next replay rewrites the state.

    A step that returns state tensors other than the ones it was given
    raises ``ValueError``: a graph captured over it would read the first
    step's state on every replay.  Under a mesh use :func:`make_train_step`
    (:func:`compile_train_step` returns it there): DTensor's collectives
    over gloo cannot be captured."""

    def __init__(self, cfg: ArchConfig, ts: TrainStepConfig = TrainStepConfig(), *,
                 device: str | torch.device | None = None, graph: bool | None = None):
        self.device = resolve_device(device)
        self.graph = graphs.use_graph(graph, self.device)
        self.ts = ts
        self._plain = make_train_step(cfg, ts)
        self.params: dict | None = None
        self.opt_state: dict | None = None
        self.runs: dict[tuple, tuple[dict, Callable]] = {}

    def __call__(self, params, opt_state, batch: dict):
        if self.params is None:
            self._adopt(params, opt_state)
        else:
            self._restore(params, opt_state)
        key = tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in batch.items()))
        if key not in self.runs:
            self.runs[key] = self._bucket(batch)
        bufs, run = self.runs[key]
        with torch.no_grad():
            for k, buf in bufs.items():
                buf.copy_(batch[k])
        loss, metrics = run()
        return loss, self.params, self.opt_state, metrics

    def _adopt(self, params, opt_state) -> None:
        opt_state = dict(opt_state)
        if self.ts.compression != "none" and "ef" not in opt_state:
            opt_state["ef"] = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                       params)
        self.params, self.opt_state = params, opt_state

    @torch.no_grad()
    def _restore(self, params, opt_state) -> None:
        _copy_into(self.params, params)
        opt_state = dict(opt_state)
        if "ef" in self.opt_state and "ef" not in opt_state:
            tree_map(lambda e: e.zero_(), self.opt_state["ef"])
            opt_state["ef"] = self.opt_state["ef"]
        _copy_into(self.opt_state, opt_state)

    def _bucket(self, batch: dict) -> tuple[dict, Callable]:
        """Static buffers of ``batch``'s shape and the step over them (a
        closure over the state and buffers, not over ``self``: no cycle
        keeps a graph's memory alive once the step is dropped)."""
        bufs = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                for k, v in batch.items()}
        plain, params, opt_state = self._plain, self.params, self.opt_state

        def step():
            loss, p, o, metrics = plain(params, opt_state, bufs)
            if not (_same_leaves(p, params) and _same_leaves(o, opt_state)):
                raise ValueError("the train step returned state tensors other than the ones "
                                 "it was given: a replay would read stale state")
            return loss, metrics

        return bufs, graphs.stepper(step, self.device, self.graph, name="train.step")


def compile_train_step(cfg: ArchConfig, ts: TrainStepConfig = TrainStepConfig(),
                       pol: ShardingPolicy = ShardingPolicy(), *,
                       device: str | torch.device | None = None,
                       graph: bool | None = None) -> Callable:
    """The launcher's step: a :class:`CompiledTrainStep` on ``device``
    (replayed on the card unless ``graph=False``), or under a mesh
    (``pol``) :func:`make_train_step`'s eager step (``graph=True`` raises
    there)."""
    if pol.mesh is None:
        return CompiledTrainStep(cfg, ts, device=device, graph=graph)
    if graph:
        raise ValueError("a train step under a mesh runs eagerly: DTensor's collectives "
                         "cannot be captured")
    return make_train_step(cfg, ts, pol)
