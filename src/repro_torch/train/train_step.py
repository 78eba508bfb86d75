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
step) is left to a later change.  There is no sharding: the gradient
all-reduce the reference's policy places has nothing to reduce over on
one card.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
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


def make_grad_fn(cfg: ArchConfig, n_microbatches: int) -> Callable:
    """(params, batch) → (mean loss, grads) with grad accumulation.

    The parameters need not require grad: each leaf is differentiated
    through a detached alias of it (same storage), so plain tensors — a
    checkpoint restored by the ``Supervisor`` — train as leaves that
    require grad do.  The loss is a detached 0-d float32 tensor."""

    def value_and_grad(params, batch):
        xs = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(xs)
        loss = lm.loss_fn(xs, batch, cfg)
        by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
        return loss.detach(), tree_map(lambda x: by_id[id(x)], xs)

    def grad_fn(params, batch):
        if n_microbatches == 1:
            return value_and_grad(params, batch)
        mbs = _split_microbatches(batch, n_microbatches)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        for i in range(n_microbatches):
            loss, g = value_and_grad(params, tree_map(lambda x: x[i], mbs))
            tree_map(lambda acc, gi: acc.add_(gi), gsum, g)
            loss_sum = loss_sum + loss
            del g
        inv = 1.0 / n_microbatches
        return loss_sum * inv, tree_map(lambda g: g.mul_(inv), gsum)

    return grad_fn


def make_train_step(cfg: ArchConfig, ts: TrainStepConfig = TrainStepConfig()) -> Callable:
    """Build ``train_step(params, opt_state, batch) -> (loss, params,
    opt_state, metrics)``, the signature the ``Supervisor`` drives.

    ``batch``: ``tokens`` and ``labels`` [B, S] integer tensors on the
    parameters' device.  The parameters, moments and master are updated in
    place (:func:`repro_torch.train.optimizer.adamw_update`) and returned."""
    grad_fn = make_grad_fn(cfg, ts.n_microbatches)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        if ts.compression != "none":
            grads, opt_state = compression.apply(ts.compression, grads, opt_state)
        params, opt_state, metrics = adamw_update(params, grads, opt_state, ts.adamw)
        metrics["loss"] = loss
        return loss, params, opt_state, metrics

    return train_step
