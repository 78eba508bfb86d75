"""CUDA wrappers for the attention kernels (``csrc/attention.cu``).

* :func:`flash_attention` replaces the Pallas
  ``repro/kernels/flash_attention.py:flash_attention`` (:116): online-softmax
  attention with GQA, causal and sliding-window masks (prefill).
* :func:`decode_attention` replaces the Pallas
  ``repro/kernels/decode_attention.py:decode_attention`` (:94): one query
  token against a KV cache with per-row valid lengths (decode), and, for
  windowed layers, the ring buffer's per-slot validity (``slot_pos``).

Both take the JAX kernels' layouts — q ``[B, Hq, Sq, D]`` (decode
``[B, Hq, D]``), k/v ``[B, Hkv, S, D]`` — with any strides whose last
dimension is contiguous, so the model passes transposed views of its
``[B, S, H, D]`` tensors and of its cache and nothing is copied.  Prefill
is bound by the tensor cores (bf16) at the serving shapes and decode by the
bytes of the valid cache rows; the source says what each design does about
it.  In bf16, prefill at head dims 64-256 reads its tiles by TMA through
tensor maps that the library builds from the strides passed here (hence
the 16-byte alignment of base and strides), and decode serves up to
:data:`TC_GROUP` q heads of a kv head per block on the tensor cores.

The wrappers take CUDA tensors only: they check device, dtype, shape and
strides, allocate outputs and scratch with ``torch.empty``, launch on the
current stream, raise when the launch reports an error, and count their
launches in :data:`~repro_torch.kernels._build.LAUNCHES`.  The dispatch
between these kernels and their plain versions lives in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import LAUNCHES, load_library, raise_on

__all__ = ["flash_attention", "decode_attention", "decode_splits"]

FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)
DECODE_HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 8  # q heads one float32 decode block serves from one read of the rows
TC_GROUP = 32  # the same for bfloat16 (tensor cores, two 16-head tiles)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = load_library("attention")
        lib.flash_attention_launch.argtypes = [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _F, _I, _I, _P
        ]
        lib.flash_attention_launch.restype = _I
        lib.decode_attention_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _F, _P
        ]
        lib.decode_attention_launch.restype = _I
        _bound = lib
    return _bound


def _check(name: str, tensors: dict[str, torch.Tensor], head_dims) -> torch.device:
    """One CUDA device, one dtype (float32 or bfloat16), a supported head
    dim, the last dim contiguous, and for bfloat16 the 16-byte alignment of
    base and (batch, head, row) strides the kernel's vector loads need."""
    first = next(iter(tensors.values()))
    dev, dtype = first.device, first.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: float32 or bfloat16 inputs, got {dtype}")
    d = first.shape[-1]
    if d not in head_dims:
        raise ValueError(f"{name}: head dim {d} not in {head_dims}")
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: all inputs must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors.values()]}"
            )
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} is {t.dtype}, q is {dtype}")
        if t.shape[-1] != d or t.stride(-1) != 1:
            raise ValueError(f"{name}: {key} needs head dim {d}, contiguous")
        if dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1])
        ):
            raise ValueError(f"{name}: bfloat16 {key} must be 16-byte aligned")
    return dev


def _strides(*tensors: torch.Tensor) -> ctypes.Array:
    """(batch, head, row) strides of each tensor (``[B, H, D]`` tensors get
    row stride 0), as the kernels' int64[3 * n] argument."""
    vals = []
    for t in tensors:
        st = t.stride()
        vals += [st[0], st[1], st[2] if t.dim() == 4 else 0]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Block attention on the card.

    q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]`` with ``Hq % Hkv == 0``;
    ``window``: position ``i`` attends to ``(i - window, i]``.  Returns
    ``[B, Hq, Sq, D]`` in q's dtype, with q's strides.  Rows with no valid
    key are 0.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or hq % hkv:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    dev = _check("flash_attention", {"q": q, "k": k, "v": v}, FLASH_HEAD_DIMS)
    out = torch.empty_like(q)  # a transposed view of q gives one of out
    if sq == 0:
        return out
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    with torch.cuda.device(dev):
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, d,
            _strides(q, k, v, out), float(sm_scale), int(causal),
            int(window or 0), torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def decode_splits(b: int, hkv: int, s: int, n_sm: int, group: int = 1,
                  heads_per_block: int = MAX_GROUP) -> tuple[int, int]:
    """``(n_split, chunk)``: enough cache splits for about two blocks per
    SM (a kv head with more than ``heads_per_block`` q heads takes one
    block per ``heads_per_block`` of them), each split at least 64 rows,
    ``n_split * chunk >= s``."""
    blocks = b * hkv * -(-group // heads_per_block)
    n_split = max(1, min(-(-2 * n_sm // blocks), -(-s // 64)))
    return n_split, max(1, -(-s // n_split))


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    seq_lens: torch.Tensor | None = None,
    sm_scale: float | None = None,
    slot_pos: torch.Tensor | None = None,
    slot_lo: int | torch.Tensor = -1,
) -> torch.Tensor:
    """One-token attention against a KV cache on the card.

    q ``[B, Hq, D]``, k/v ``[B, Hkv, S, D]`` (``Hq % Hkv == 0``),
    ``seq_lens`` optional ``int[B]`` valid lengths (default ``S``, with no
    tensor made for it; rows past it are not read).  ``slot_pos`` optional
    ``int32[S]`` shared by the batch: row ``w`` then also needs
    ``slot_pos[w] >= 0`` and ``slot_pos[w] > slot_lo`` (the kernel reads
    it; rows that fail are not read).  ``slot_lo`` is an ``int`` or a 0-d
    ``int32`` tensor on q's device, which the kernel reads when it runs (a
    decode step replayed from a CUDA graph reads the bound of its own
    position); an ``int`` other than -1 is put on the device first.
    Returns ``[B, Hq, D]`` in q's dtype; a row with no valid key is 0.
    """
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    if k.shape[0] != b or hq % hkv:
        raise ValueError(f"bad shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    dev = _check("decode_attention", {"q": q, "k": k, "v": v}, DECODE_HEAD_DIMS)
    if seq_lens is not None:
        if tuple(seq_lens.shape) != (b,) or seq_lens.device != dev:
            raise ValueError(f"seq_lens must be int[{b}] on {dev}")
        if seq_lens.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"seq_lens must be int32 (or int64), got {seq_lens.dtype}")
        seq_lens = seq_lens.to(torch.int32).contiguous()
    if slot_pos is not None and (
        tuple(slot_pos.shape) != (s,) or slot_pos.device != dev
        or slot_pos.dtype != torch.int32 or not slot_pos.is_contiguous()
    ):
        raise ValueError(f"slot_pos must be contiguous int32[{s}] on {dev}")
    if isinstance(slot_lo, torch.Tensor):
        if slot_lo.shape != () or slot_lo.device != dev or slot_lo.dtype != torch.int32:
            raise ValueError(f"slot_lo must be an int or a 0-d int32 tensor on {dev}")
    elif slot_lo > -1:
        slot_lo = torch.full((), slot_lo, dtype=torch.int32, device=dev)
    else:
        slot_lo = None  # -1: every slot with slot_pos >= 0
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    n_split, chunk = decode_splits(
        b, hkv, s, torch.cuda.get_device_properties(dev).multi_processor_count, hq // hkv,
        TC_GROUP if q.dtype == torch.bfloat16 else MAX_GROUP)
    part_m = torch.empty((b, hq, n_split), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hq, n_split, d), dtype=torch.float32, device=dev)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib().decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seq_lens is None else seq_lens.data_ptr(),
            None if slot_pos is None else slot_pos.data_ptr(),
            None if slot_lo is None else slot_lo.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), int(q.dtype == torch.bfloat16), b, hq, hkv,
            s, d, n_split, chunk, _strides(q, k, v, out), float(sm_scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_on(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
