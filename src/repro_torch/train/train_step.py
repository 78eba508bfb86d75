"""The training step: microbatched gradient accumulation + optional
gradient compression + AdamW — the port of ``repro.train.train_step``.

The batch ``[B, ...]`` is split into ``n_microbatches`` of ``B/n``; each
microbatch's loss is differentiated with ``torch.autograd.grad`` over the
parameter leaves (its activations freed before the next), the gradients
summed in float32 and divided by ``n`` at the end, as the reference's
``lax.scan`` over microbatches does.  With one microbatch the gradients
keep each parameter's dtype, as ``jax.value_and_grad``'s do.

The step runs eagerly, op by op; it reads nothing back to the host, so
replaying it from one CUDA graph (the counterpart of ``jax.jit`` of the
step) is left to a later change.

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

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.sharding.policies import ShardingPolicy, is_dtensor
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, adamw_update, tree_leaves, tree_map

__all__ = ["TrainStepConfig", "make_train_step", "make_grad_fn"]


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
