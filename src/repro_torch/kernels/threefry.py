"""CUDA wrapper for the threefry kernel (``csrc/random.cu``): JAX's random
streams drawn on the card.

:func:`draw` makes ``[R, n]`` draws, row ``r`` from key row ``r`` (raw
bits, uniform, normal or gumbel, float32 or bfloat16), optionally
splitting each key first; :func:`split` makes ``[R, n, 2]`` new keys.  The
plain version, and the public functions that dispatch here for a key on a
CUDA device, are :mod:`repro_torch.random`.  No Pallas kernel is replaced:
XLA lowers the reference's ``threefry2x32`` itself.

The wrappers take an ``int64`` key tensor ``[R, 2]`` on one CUDA device,
allocate their outputs with ``torch.empty``, launch on the current stream,
raise when the launch reports an error, and count their launches in
:data:`~repro_torch.kernels._build.LAUNCHES` (``"threefry"``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import LAUNCHES, load_library, raise_on

__all__ = ["draw", "split", "HASH_OPS"]

#: integer operations of one threefry2x32 hash (20 rounds of add, rotate
#: and xor, 5 key injections of two adds, the first injection): the
#: kernel's bound counts these per element
HASH_OPS = 20 * 3 + 5 * 2 + 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = load_library("random")
        lib.threefry_draw_launch.argtypes = [_P, _P, _P, _L, _L, _I, _I, _F, _F, _I, _P]
        lib.threefry_draw_launch.restype = _I
        lib.threefry_split_launch.argtypes = [_P, _P, _L, _L, _P]
        lib.threefry_split_launch.restype = _I
        _bound = lib
    return _bound


def _keys(keys: torch.Tensor) -> torch.device:
    if keys.device.type != "cuda":
        raise ValueError(f"threefry: keys must lie on a CUDA device, got {keys.device}")
    if keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"threefry: keys must be int64 [R, 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("threefry: keys must be contiguous")
    if len(keys) == 0:
        raise ValueError("threefry: no key rows")
    return keys.device


def draw(keys: torch.Tensor, n: int, kind: int, dtype: torch.dtype, lo: float = 0.0,
         diff: float = 1.0, *, split_first: bool = False):
    """``[R, n]`` draws of ``kind`` (0 bits as ``int64``, 1 uniform, 2
    normal, 3 gumbel, from the uniform ``[lo, lo + diff)`` of
    :func:`repro_torch.random.bounds`) in ``dtype`` (float32 or bfloat16),
    row ``r`` from key row ``r``.  With ``split_first`` each key
    is split first and the draw comes from its subkey: returns ``(new_keys,
    draws)``, one launch."""
    dev = _keys(keys)
    if kind != 0 and dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"threefry: dtype must be float32 or bfloat16, got {dtype}")
    out = torch.empty((len(keys), n), dtype=torch.int64 if kind == 0 else dtype, device=dev)
    new = torch.empty_like(keys) if split_first else None
    if n or split_first:
        with torch.cuda.device(dev):
            err = _lib().threefry_draw_launch(
                keys.data_ptr(), None if new is None else new.data_ptr(), out.data_ptr(),
                len(keys), n, kind, int(dtype == torch.bfloat16), lo, diff,
                int(split_first), torch.cuda.current_stream(dev).cuda_stream,
            )
        raise_on(err, "threefry")
        LAUNCHES["threefry"] += 1
    return (new, out) if split_first else out


def split(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[R, n, 2]``: ``jax.random.split`` of each key row into ``n``."""
    dev = _keys(keys)
    if n <= 0:
        raise ValueError(f"threefry: split into {n} keys")
    out = torch.empty((len(keys), n, 2), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _lib().threefry_split_launch(keys.data_ptr(), out.data_ptr(), len(keys), n,
                                           torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "threefry")
    LAUNCHES["threefry"] += 1
    return out
