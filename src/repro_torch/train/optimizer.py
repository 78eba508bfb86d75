"""AdamW with a cosine schedule and global-norm clipping over dicts of
tensors — the port of ``repro.train.optimizer``, in its arithmetic:
warmup then cosine, the global norm clipped to ``clip_norm``, bias
correction, and the weight decay added to the step on the float32
master copy, whose value is cast back to each parameter's dtype.

``torch.optim.AdamW`` is not used: it keeps no master copy and decays the
weights before the Adam step instead of adding the decay to it.

The state lives beside the parameters on their device: ``m``, ``v`` and
``master`` (float32, one per parameter) and an int32 ``count``.  The
update goes in place, under ``torch.no_grad()`` — the count, the moments,
the master and the parameters are rewritten, not reallocated, so a step
needs one leaf's temporaries beyond the state (the reference returns new
trees), and a CUDA graph captured over one step reads the advanced state
on its next replay (``train_step.CompiledTrainStep``).  The learning
rate, the clip scale and the bias corrections are 0-d float32 tensors on
the device, as the reference's traced scalars are: nothing is read back
to the host.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import operator
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.sharding.policies import is_dtensor, replicated_constants

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "cosine_lr", "global_norm",
           "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts in ``jax.tree.leaves``' order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor) as float32: linear warmup,
    then a cosine from ``peak_lr`` to ``min_lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any) -> dict:
    """m/v moments + fp32 master weights (for bf16 compute params), and
    the step count, on the parameters' device.  A DTensor parameter's
    moments and master are DTensors of its placements."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in key order) of each leaf's sum of
    squares, in float32.  On DTensor leaves each sum is a partial one on
    every rank and the total is reduced once, for the ``sqrt``: a
    replicated 0-d DTensor, nothing read on the host."""
    squares = [torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree)]
    return torch.sqrt(functools.reduce(operator.add, squares))


@torch.no_grad()
def adamw_update(
    params: Any, grads: Any, opt_state: dict, cfg: AdamWConfig
) -> tuple[Any, dict, dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, opt_state, metrics); the params,
    ``m``, ``v``, ``master`` and ``count`` are the given tensors, updated
    in place.  An ``"ef"`` entry (gradient compression's error feedback)
    is carried through."""
    count = opt_state["count"].add_(1)
    lr = cosine_lr(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** count.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** count.to(torch.float32)

    def upd(p, g, m, v, master):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        step.add_(cfg.weight_decay * master)
        master.sub_(lr * step)
        p.copy_(master)

    with replicated_constants():  # the schedule's 0-d tensors meet DTensor leaves
        tree_map(upd, params, grads, opt_state["m"], opt_state["v"], opt_state["master"])
    out_state = {"m": opt_state["m"], "v": opt_state["v"], "master": opt_state["master"],
                 "count": count}
    if "ef" in opt_state:
        out_state["ef"] = opt_state["ef"]
    if is_dtensor(gnorm):
        gnorm = gnorm.full_tensor()  # replicated: the value on every rank
    return params, out_state, {"lr": lr, "grad_norm": gnorm}
