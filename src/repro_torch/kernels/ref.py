"""Plain PyTorch versions of the port's kernels — the CPU path and the
oracle each CUDA kernel is held against on the card.

The same einsum / matmul as ``repro/kernels/ref.py:140-153``.  Both take
the per-rank signature of the JAX functions; the block version also takes
rank-stacked inputs (a leading rank dimension on all three arguments).
They compute in float32, or in float64 when given float64 inputs (the
yardstick the kernels are held to at large sizes).
"""
from __future__ import annotations

import torch

__all__ = ["spike_accum_ref", "spike_accum_blocks_ref"]


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
