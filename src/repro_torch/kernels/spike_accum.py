"""CUDA wrappers for the spike → current kernels (``csrc/spike_accum.cu``).

* :func:`spike_accum_blocks` replaces the Pallas
  ``repro/kernels/spike_accum.py:spike_accum_blocks`` (:133): block-CSR
  accumulation ``I = Σ_k s_blocks[src_ids[k]] @ blocks[k]``, per rank or
  rank-stacked (one launch covers every rank).
* :func:`spike_accum` replaces the Pallas
  ``repro/kernels/spike_accum.py:spike_accum`` (:62): ``I = s @ W``.

Both are bound by memory on an H100: the least time is the bytes of the
weight rows whose spike fired (plus spikes, indices and output) over the
card's memory rate, 3.35 TB/s on an H100 SXM.  The kernels read only those
rows — the TPU kernel reads every weight of a tile with any spike — with a
fixed summation order and no atomics (see the source for the design).

The wrappers take CUDA tensors only: they check device, dtype, shape and
contiguity, allocate the output with ``torch.empty``, launch on the
current stream, raise when the launch reports an error, and count their
launches in :data:`LAUNCHES` (shared by every kernel of the port).  The
dispatch between these kernels and their plain versions lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import LAUNCHES, load_library, raise_on, reset_launches

__all__ = ["LAUNCHES", "reset_launches", "spike_accum", "spike_accum_blocks"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = load_library("spike_accum")
        lib.spike_accum_blocks_launch.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _P
        ]
        lib.spike_accum_blocks_launch.restype = _I
        lib.spike_accum_launch.argtypes = [_P, _P, _P, _I, _I, _P]
        lib.spike_accum_launch.restype = _I
        _bound = lib
    return _bound


def _check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: all inputs must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev


def spike_accum_blocks(
    s_blocks: torch.Tensor, src_ids: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """Block-CSR accumulation on the card.

    Per rank: ``s_blocks f32[n_blocks, B]``, ``src_ids int[K]``,
    ``blocks f32[K, B, Bj]`` → ``f32[Bj]``.  Rank-stacked: a leading
    ``n_dev`` on all three → ``f32[n_dev, Bj]``.  ``src_ids`` must lie in
    ``[0, n_blocks)`` (a tile outside it adds nothing).  ``K = 0`` returns
    zeros without a launch.
    """
    stacked = s_blocks.dim() == 3
    if not stacked:
        if s_blocks.dim() != 2:
            raise ValueError(f"s_blocks must be [n_blocks, B], got {tuple(s_blocks.shape)}")
        s_blocks, src_ids, blocks = s_blocks[None], src_ids[None], blocks[None]
    n_dev, n_blocks, b = s_blocks.shape
    if blocks.dim() != 4 or src_ids.dim() != 2:
        raise ValueError("blocks must be [n_dev, K, B, Bj] and src_ids [n_dev, K]")
    _, k, bi, bj = blocks.shape
    if bi != b or blocks.shape[0] != n_dev or tuple(src_ids.shape) != (n_dev, k):
        raise ValueError(
            f"blocks {tuple(blocks.shape)} / src_ids {tuple(src_ids.shape)} "
            f"incompatible with s_blocks {tuple(s_blocks.shape)}"
        )
    if s_blocks.dtype != torch.float32 or blocks.dtype != torch.float32:
        raise ValueError("s_blocks and blocks must be float32")
    if src_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"src_ids must be int32 (or int64), got {src_ids.dtype}")
    dev = _check_cuda("spike_accum_blocks", s_blocks, src_ids, blocks)
    if src_ids.dtype != torch.int32:
        src_ids = src_ids.to(torch.int32)
    if k == 0:  # no tiles → no currents
        out = torch.zeros((n_dev, bj), dtype=torch.float32, device=dev)
        return out if stacked else out[0]
    out = torch.empty((n_dev, bj), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().spike_accum_blocks_launch(
            s_blocks.data_ptr(), src_ids.data_ptr(), blocks.data_ptr(),
            out.data_ptr(), n_dev, n_blocks, b, k, bj,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "spike_accum_blocks")
    LAUNCHES["spike_accum_blocks"] += 1
    return out if stacked else out[0]


def spike_accum(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``I = spikes @ W`` on the card, reading only the rows that fired.

    ``spikes f32[M]``, ``w f32[M, N]`` → ``f32[N]``.  Spikes may be
    weighted (any float32 value).
    """
    if w.dim() != 2 or tuple(spikes.shape) != (w.shape[0],):
        raise ValueError(
            f"spikes {tuple(spikes.shape)} incompatible with W {tuple(w.shape)}"
        )
    if spikes.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("spikes and W must be float32")
    dev = _check_cuda("spike_accum", spikes, w)
    m, n = w.shape
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().spike_accum_launch(
            spikes.data_ptr(), w.data_ptr(), out.data_ptr(), m, n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "spike_accum")
    LAUNCHES["spike_accum"] += 1
    return out
