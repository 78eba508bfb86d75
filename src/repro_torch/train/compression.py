"""Gradient compression with error feedback — the port of
``repro.train.compression``.

``int8_ef`` quantizes each gradient tensor to symmetric int8 (one scale a
tensor), ``topk_ef`` keeps the largest-magnitude fraction of each tensor
as a dense masked tensor; what a step does not send is carried in
``opt_state["ef"]`` and added to the next step's gradient (EF-SGD), so
the sum of what is sent telescopes to the sum of the gradients less the
last residual.  Both are exact-shape (compress, then decompress at once),
as in the reference.  On one card nothing is exchanged: the transforms
model the bytes a cross-pod all-reduce would move, and train the same
way.

The residuals are rewritten in place once they exist (the first step
makes them), as AdamW's state is, so a CUDA graph of the step reads each
step's residuals on its next replay.

Rounding follows the reference's: ``torch.round`` rounds half to even,
as ``jnp.round`` does; the top-k threshold is the k-th largest magnitude
(``torch.topk``, as ``jax.lax.top_k``), and every entry at or above it
is kept.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.sharding.policies import ShardingPolicy
from repro_torch.train.optimizer import tree_map

__all__ = ["apply", "int8_compress", "int8_decompress", "topk_mask"]


def int8_compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_mask(g: torch.Tensor, frac: float = 0.1) -> torch.Tensor:
    """Keep the top-|frac| magnitude entries (dense masked form)."""
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(torch.abs(g) >= thresh, g, 0.0)


def apply(kind: str, grads: Any, opt_state: dict,
          pol: ShardingPolicy = ShardingPolicy()) -> tuple[Any, dict]:
    """Compress grads with error feedback carried in opt_state["ef"]
    (float32, one residual a gradient; zeros when absent, then updated in
    place).  Returns (the sent gradients, float32, and a new opt_state dict
    holding the residuals).  ``pol`` is the
    reference's argument: on DTensor gradients the residuals take each
    gradient's placements, and the scale's max and the top-k threshold are
    global (DTensor reduces them over the mesh)."""
    ef = opt_state.get("ef")
    if ef is None:
        ef = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        corrected = g.to(torch.float32) + e
        if kind == "int8_ef":
            q, s = int8_compress(corrected)
            sent = int8_decompress(q, s)
        elif kind == "topk_ef":
            sent = topk_mask(corrected)
        else:
            raise ValueError(kind)
        e.copy_(corrected - sent)
        return sent

    with pol.constants():
        sent = tree_map(one, grads, ef)
    opt_state = dict(opt_state)
    opt_state["ef"] = ef
    return sent, opt_state
