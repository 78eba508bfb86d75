"""Dispatch for the port's kernel layer.

The tensor's device decides — there is no policy flag: a CPU tensor
takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA
tensor takes the hand-written kernel (:mod:`repro_torch.kernels.spike_accum`,
:mod:`repro_torch.kernels.attention`, :mod:`repro_torch.kernels.scan`) or
raises.  There is no fallback from
the kernel to the plain version.  A ``meta`` tensor (shape and dtype, no
data: the dry-run's) takes the plain version too, announced to
:mod:`repro_torch.kernels._meta`'s listeners, so a step is counted without a
card; it holds no data, so nothing is computed there.  The signatures and
layouts are those of ``repro/kernels/ops.py``.

The hand-written kernels have no backward (nor have the reference's
Pallas kernels): a wrapper fills its output through ``ctypes``, so the
result would be cut from the autograd graph without a word.  On the card,
``attention``, ``decode_attention``, ``ssd`` and ``rglru`` therefore raise
``RuntimeError`` when grad mode is on and an input requires grad; training
takes the model's training route (``train=True``), which calls none of
them.  The CPU branch keeps its plain versions, which autograd
differentiates.

A DTensor (:mod:`repro_torch.sharding`) is refused by every wrapper, on
the CPU and on the card alike, with a ``TypeError``: a kernel takes one
device's tensors, and unwrapping a shard here would compute on part of the
data without a word.  Under a mesh the model's serving route hands each
kernel its rank's local shards itself (``repro_torch.models.layers``: q
rows with their ``q_offset``, the rank's heads, channels or cache slots)
and puts the result back as a DTensor; the training route calls no kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _meta
from repro_torch.kernels import attention as _attn
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import scan as _scan
from repro_torch.kernels import spike_accum as _cuda
from repro_torch.sharding.policies import is_dtensor

__all__ = [
    "attention", "decode_attention", "ssd", "rglru", "spike_currents", "spike_currents_blocks",
]


def _refuse_dtensor(name: str, *xs: torch.Tensor | None) -> None:
    """Raise if a DTensor reached a kernel wrapper."""
    if any(is_dtensor(x) for x in xs):
        raise TypeError(
            f"{name}: a DTensor reached the kernel wrapper; the kernels take one device's "
            "tensors: under a mesh the serving route (lm.prefill / lm.decode_step with a "
            "ShardingPolicy) passes each rank's local shards, and the training route "
            "launches no kernel")


def _plain(name: str, fn, inputs: tuple, *args, **kwargs):
    """The plain version ``fn``: directly on the CPU, announced to the
    counters' listeners on meta tensors."""
    if inputs[0].device.type == "meta":
        return _meta.run(name, fn, tuple(x for x in inputs if x is not None), *args, **kwargs)
    return fn(*args, **kwargs)


def _is_plain(x: torch.Tensor) -> bool:
    """CPU and meta tensors take the plain version."""
    return x.device.type in ("cpu", "meta")


def _refuse_grad(name: str, *xs: torch.Tensor | None) -> None:
    """Raise if a kernel launch would cut the autograd graph."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and an input requires grad; train "
            "through the model's training route (lm.loss_fn / forward(train=True)), or run "
            "under torch.no_grad()")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Masked attention (prefill).  q ``[B, Hq, Sq, D]``, k/v
    ``[B, Hkv, Sk, D]``, any strides with the last dim contiguous; q row
    ``r`` at position ``q_offset + r`` (a rank's rows of a sequence split
    over ``tp``)."""
    _refuse_dtensor("flash_attention", q, k, v)
    kw = dict(causal=causal, window=window, sm_scale=sm_scale, q_offset=q_offset)
    if _is_plain(q):
        return _plain("flash_attention", _ref.attention_ref, (q, k, v), q, k, v, **kw)
    _refuse_grad("flash_attention", q, k, v)
    return _attn.flash_attention(q, k, v, **kw)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    seq_lens: torch.Tensor | None = None,
    sm_scale: float | None = None,
    slot_pos: torch.Tensor | None = None,
    slot_lo: int | torch.Tensor = -1,
    return_lse: bool = False,
):
    """One-token attention against a KV cache (decode).  q ``[B, Hq, D]``,
    k/v ``[B, Hkv, S, D]``, ``seq_lens`` optional ``int[B]``; ``slot_pos``
    optional ``int[S]`` (row ``w`` valid only when ``slot_pos[w] >= 0`` and
    ``slot_pos[w] > slot_lo``: the windowed ring buffer's rule; ``slot_lo``
    an ``int`` or a 0-d ``int32`` tensor on q's device).  ``return_lse``:
    also each row's log-sum-exp ``[B, Hq]`` float32 (``-inf``, with ``o =
    0``, for a row with no valid key), for a cache whose slots are split
    over ``tp``."""
    _refuse_dtensor("decode_attention", q, k, v, seq_lens, slot_pos)
    kw = dict(seq_lens=seq_lens, sm_scale=sm_scale, slot_pos=slot_pos, slot_lo=slot_lo,
              return_lse=return_lse)
    if _is_plain(q):
        return _plain("decode_attention", _ref.decode_attention_ref, (q, k, v, slot_pos),
                      q, k, v, **kw)
    _refuse_grad("decode_attention", q, k, v)
    return _attn.decode_attention(q, k, v, **kw)


def ssd(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
    return_state: bool = False,
):
    """Mamba-2 chunked SSD scan (prefill).  x ``[B, S, H, P]``, a
    ``[B, S, H]``, b/c ``[B, S, G, N]``; ``min(chunk, S)`` must divide S.
    With ``return_state`` returns ``(y, h_S)``, the final state
    ``[B, H, N, P]``."""
    _refuse_dtensor("ssd_scan", x, a, b, c)
    if _is_plain(x):
        return _plain("ssd_scan", _ref.ssd_chunked, (x, a, b, c), x, a, b, c, chunk=chunk,
                      return_state=return_state)
    _refuse_grad("ssd_scan", x, a, b, c)
    return _scan.ssd_scan(x, a, b, c, chunk=chunk, return_state=return_state)


def rglru(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """RG-LRU diagonal recurrence (prefill).  a, b ``[B, S, D]`` → the h
    trace."""
    _refuse_dtensor("rglru_scan", a, b)
    if _is_plain(a):
        return _plain("rglru_scan", _ref.rglru_ref, (a, b), a, b)
    _refuse_grad("rglru_scan", a, b)
    return _scan.rglru_scan(a, b)


def spike_currents(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``I = s @ W`` (the single-device engine's current hook)."""
    _refuse_dtensor("spike_accum", spikes, w)
    if _is_plain(spikes):
        return _plain("spike_accum", _ref.spike_accum_ref, (spikes, w), spikes, w)
    return _cuda.spike_accum(spikes, w)


def spike_currents_blocks(
    s_blocks: torch.Tensor, src_ids: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """Block-CSR synaptic accumulation (the ``exchange='sparse'`` /
    ``'ragged'`` layout; the distributed engine's per-step hot spot),
    per rank or rank-stacked."""
    _refuse_dtensor("spike_accum_blocks", s_blocks, src_ids, blocks)
    if _is_plain(s_blocks):
        return _plain("spike_accum_blocks", _ref.spike_accum_blocks_ref,
                      (s_blocks, src_ids, blocks), s_blocks, src_ids, blocks)
    return _cuda.spike_accum_blocks(s_blocks, src_ids, blocks)
