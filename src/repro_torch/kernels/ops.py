"""Dispatch for the port's kernel layer.

The tensor's device decides — there is no policy flag: a CPU tensor
takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA
tensor takes the hand-written kernel (:mod:`repro_torch.kernels.spike_accum`)
or raises.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import spike_accum as _cuda

__all__ = ["spike_currents", "spike_currents_blocks"]


def spike_currents(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``I = s @ W`` (the single-device engine's current hook)."""
    if spikes.device.type == "cpu":
        return _ref.spike_accum_ref(spikes, w)
    return _cuda.spike_accum(spikes, w)


def spike_currents_blocks(
    s_blocks: torch.Tensor, src_ids: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """Block-CSR synaptic accumulation (the ``exchange='sparse'`` /
    ``'ragged'`` layout; the distributed engine's per-step hot spot),
    per rank or rank-stacked."""
    if s_blocks.device.type == "cpu":
        return _ref.spike_accum_blocks_ref(s_blocks, src_ids, blocks)
    return _cuda.spike_accum_blocks(s_blocks, src_ids, blocks)
