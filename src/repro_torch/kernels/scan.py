"""CUDA wrappers for the sequence-scan kernels (``csrc/scan.cu``).

* :func:`ssd_scan` replaces the Pallas ``repro/kernels/ssd_scan.py:ssd_scan``
  (:81): Mamba-2's chunked SSD scan, the ``[N, P]`` state carried across
  chunks in order (prefill of ``ssm`` layers).
* :func:`rglru_scan` replaces the Pallas
  ``repro/kernels/rglru_scan.py:rglru_scan`` (:53): the diagonal
  recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``, its trace returned (prefill of
  ``rglru`` layers).

Both take and return float32 in the JAX kernels' layouts and raise their
``ValueError``s on bad shapes.  The SSD scan is bound by the float32 rate
of the CUDA cores at mamba2-1.3b's shapes and the RG-LRU scan by memory;
the source says what each design does about it.  The TPU kernel's tiling
arguments (``rglru_scan``'s ``chunk`` and ``block_d``) have no counterpart
here: the recurrence runs over the whole sequence in one pass.

The wrappers take contiguous CUDA tensors only: they check device, dtype,
shape and contiguity, allocate the output with ``torch.empty``, launch on
the current stream, raise when the launch reports an error, and count
their launches in :data:`~repro_torch.kernels._build.LAUNCHES`.  The
dispatch between these kernels and their plain versions lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import LAUNCHES, load_library, raise_on

__all__ = ["ssd_scan", "rglru_scan"]

SSD_HEAD_DIMS = (16, 32, 64, 128)
SSD_MAX_CHUNK = 128
SMEM_LIMIT = 232_448  # shared memory one block may opt into on Hopper

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = load_library("scan")
        lib.ssd_scan_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.ssd_scan_launch.restype = _I
        lib.ssd_scan_smem_bytes.argtypes = [_I, _I, _I]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.rglru_scan_launch.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.rglru_scan_launch.restype = _I
        _bound = lib
    return _bound


def _check(name: str, **tensors: torch.Tensor) -> torch.device:
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: all inputs must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors.values()]}"
            )
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def ssd_scan(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
) -> torch.Tensor:
    """Chunked SSD scan on the card.

    x ``[B, S, H, P]`` (Δ-scaled), a ``[B, S, H]`` decay in (0, 1], b/c
    ``[B, S, G, N]`` with ``H % G == 0``; ``chunk = min(chunk, S)`` must
    divide S and be at most 128 (any length, not only powers of two).
    Returns y ``[B, S, H, P]``.
    """
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"bad shapes x={tuple(x.shape)} a={tuple(a.shape)} b={tuple(b.shape)}")
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (tuple(a.shape) != (bs, s, h) or c.shape != b.shape or tuple(b.shape[:2]) != (bs, s)
            or g == 0 or h % g):
        raise ValueError(f"bad shapes x={tuple(x.shape)} a={tuple(a.shape)} b={tuple(b.shape)}")
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError("S must divide chunk")
    if chunk > SSD_MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} > {SSD_MAX_CHUNK}")
    if p not in SSD_HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim {p} not in {SSD_HEAD_DIMS}")
    dev = _check("ssd_scan", x=x, a=a, b=b, c=c)
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(chunk, n, p)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"ssd_scan: state {n}x{p} at chunk {chunk} needs {smem} B of shared memory")
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.ssd_scan_launch(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            bs, s, h, g, n, p, chunk, torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The gated diagonal recurrence on the card.

    a ``[B, S, D]`` decay gates in (0, 1), b ``[B, S, D]`` gated inputs.
    Returns the state trace h ``[B, S, D]`` (``h_{-1} = 0``).
    """
    if b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} != b {tuple(b.shape)}")
    if a.dim() != 3:
        raise ValueError(f"a must be [B, S, D], got {tuple(a.shape)}")
    dev = _check("rglru_scan", a=a, b=b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    bs, s, d = a.shape
    with torch.cuda.device(dev):
        err = _lib().rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bs, s, d,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return out
