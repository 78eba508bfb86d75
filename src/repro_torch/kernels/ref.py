"""Plain PyTorch versions of the port's kernels — the CPU path and the
oracle each CUDA kernel is held against on the card.

The same einsums / matmul as ``repro/kernels/ref.py``: dense masked
attention (:22, :56) and the spike accumulations (:140-153), in the JAX
functions' layouts.  The spike versions take the per-rank signature of the
JAX functions; the block version also takes rank-stacked inputs (a leading
rank dimension on all three arguments).  They compute in float32, or in
float64 when given float64 inputs (the yardstick the kernels are held to at
large sizes).  The attention versions compute in float32 and return the
query's dtype.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "attention_ref",
    "decode_attention_ref",
    "spike_accum_ref",
    "spike_accum_blocks_ref",
]

_MASK = -1e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Dense masked attention.  q: [B,Hq,Sq,D]; k/v: [B,Hkv,Sk,D]."""
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(torch.where(mask, s, _MASK), dim=-1)
    # fully masked rows: softmax of all -1e30 is uniform; zero them like the kernel
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    seq_lens: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Single-token attention vs a KV cache.

    q: [B,Hq,D]; k/v: [B,Hkv,S,D]; seq_lens: optional int[B] valid lengths.
    """
    _, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), kk) * sm_scale
    if seq_lens is not None:
        valid = torch.arange(s, device=q.device)[None, None, :] < seq_lens[:, None, None]
        logits = torch.where(valid, logits, _MASK)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vv).to(q.dtype)


def _float(*xs: torch.Tensor) -> list[torch.Tensor]:
    """``xs`` in their common floating type, at least float32."""
    dtype = torch.float32
    for x in xs:
        dtype = torch.promote_types(dtype, x.dtype)
    return [x.to(dtype) for x in xs]


def spike_accum_ref(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """I = s @ W."""
    s, w = _float(spikes, w)
    return s @ w


def spike_accum_blocks_ref(
    s_blocks: torch.Tensor, src_ids: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """Block-CSR accumulation: ``I = Σ_k s_blocks[src_ids[k]] @ blocks[k]``.

    Per rank: ``s_blocks [n_blocks, B]``, ``src_ids [K]``,
    ``blocks [K, B, Bj]`` → ``[Bj]``.  Rank-stacked: a leading ``n_dev``
    on all three → ``[n_dev, Bj]``.
    """
    s, blocks = _float(s_blocks, blocks)
    idx = src_ids.to(torch.long)
    if s.dim() == 2:
        return torch.einsum("kb,kbj->j", s[idx], blocks)
    rank = torch.arange(s.shape[0], device=s.device)[:, None]
    return torch.einsum("dkb,dkbj->dj", s[rank, idx], blocks)
