"""Plain PyTorch versions of the port's kernels — the CPU path and the
oracle each CUDA kernel is held against on the card.

The same einsums / matmul as ``repro/kernels/ref.py``: dense masked
attention (:22, :56), the SSD and RG-LRU recurrences (:86, :117) and the
spike accumulations (:140-153), in the JAX functions' layouts; and
:func:`ssd_chunked`, the chunked SSD of ``repro/kernels/ops.py:
_ssd_chunked_jnp`` (:136), which the reference's model calls.  The spike
versions take the per-rank signature of the JAX functions; the block
version also takes rank-stacked inputs (a leading rank dimension on all
three arguments).  The spike and scan versions compute in float32, or in
float64 when given float64 inputs (the yardstick the kernels are held to
at large sizes).  The attention versions compute in float32 and return the
query's dtype.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "attention_ref",
    "decode_attention_ref",
    "ssd_ref",
    "ssd_chunked",
    "rglru_ref",
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
    slot_pos: torch.Tensor | None = None,
    slot_lo: int | torch.Tensor = -1,
) -> torch.Tensor:
    """Single-token attention vs a KV cache.

    q: [B,Hq,D]; k/v: [B,Hkv,S,D]; seq_lens: optional int[B] valid lengths.
    slot_pos: optional int[S], the position each cache row holds (shared by
    the batch); row ``w`` then also needs ``slot_pos[w] >= 0`` and
    ``slot_pos[w] > slot_lo`` — the windowed decode's rule
    (``repro/models/layers.py:260-262``, ``slot_lo = pos - window``), an
    ``int`` or a 0-d tensor.
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
    if slot_pos is not None:
        valid = (slot_pos >= 0) & (slot_pos > slot_lo)
        logits = torch.where(valid[None, None, :], logits, _MASK)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vv).to(q.dtype)


def _float(*xs: torch.Tensor) -> list[torch.Tensor]:
    """``xs`` in their common floating type, at least float32."""
    dtype = torch.float32
    for x in xs:
        dtype = torch.promote_types(dtype, x.dtype)
    return [x.to(dtype) for x in xs]


def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD by direct recurrence.

    x: [B,S,H,P]; a: [B,S,H] decay in (0,1]; b,c: [B,S,G,N] with H % G == 0.
    h_t = a_t·h_{t-1} + b_t ⊗ x_t;  y_t = cᵗ_t·h_t.
    """
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    xf, af, bf, cf = _float(x, a, b, c)
    bb = bf.repeat_interleave(h // g, dim=2)  # [B,S,H,N]
    cc = cf.repeat_interleave(h // g, dim=2)
    state = torch.zeros((bs, h, n, p), dtype=xf.dtype, device=x.device)
    ys = []
    for t in range(s):
        state = af[:, t, :, None, None] * state + bb[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cc[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
    return_state: bool = False,
):
    """The chunked SSD of ``_ssd_chunked_jnp``: ``chunk = min(chunk, S)``
    must divide S (the reference's reshape fails otherwise; here
    ``ValueError``).  Within a chunk ``((C Bᵀ) ⊙ causal decay) X``; across
    chunks the ``[N, P]`` state, carried in order.  The ``[B, nc, L, L]``
    decay matrix is built one head at a time, as in the reference.  With
    ``return_state`` also the carried state after the last chunk,
    ``[B, H, N, P]`` in the computing dtype."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    xf, af, bf, cf = _float(x, a, b, c)
    xc = xf.reshape(bs, nc, chunk, h, p)
    ac = af.reshape(bs, nc, chunk, h)
    bc = bf.reshape(bs, nc, chunk, g, n)
    cc = cf.reshape(bs, nc, chunk, g, n)
    tpos = torch.arange(chunk, device=x.device)
    causal = tpos[:, None] >= tpos[None, :]  # [L, L]
    y = torch.empty_like(xc)
    final = torch.empty((bs, h, n, p), dtype=xf.dtype, device=x.device)
    for gi in range(g):
        b_g, c_g = bc[:, :, :, gi], cc[:, :, :, gi]  # [B,nc,L,N]
        cb_g = torch.einsum("bktn,bksn->bkts", c_g, b_g)  # [B,nc,L,L]
        for hi in range(gi * rep, (gi + 1) * rep):
            x_h, a_h = xc[:, :, :, hi], ac[:, :, :, hi]  # [B,nc,L,P], [B,nc,L]
            cum = torch.cumsum(torch.log(a_h), dim=2)
            # mask before exp: above the diagonal cum_t - cum_s > 0 overflows
            diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], -torch.inf)
            y_intra = torch.einsum("bkts,bksp->bktp", cb_g * torch.exp(diff), x_h)
            decay_end = torch.exp(cum[:, :, -1:] - cum)  # [B,nc,L]
            states = torch.einsum("bktn,bkt,bktp->bknp", b_g, decay_end, x_h)
            chunk_decay = torch.exp(cum[:, :, -1])  # [B,nc]
            h_prev = torch.zeros((bs, nc, n, p), dtype=xf.dtype, device=x.device)
            carry = torch.zeros((bs, n, p), dtype=xf.dtype, device=x.device)
            for k in range(nc):
                h_prev[:, k] = carry
                carry = chunk_decay[:, k, None, None] * carry + states[:, k]
            y_inter = torch.einsum("bktn,bknp,bkt->bktp", c_g, h_prev, torch.exp(cum))
            y[:, :, :, hi] = y_intra + y_inter
            final[:, hi] = carry
    y = y.reshape(bs, s, h, p).to(x.dtype)
    return (y, final) if return_state else y


def rglru_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t ⊙ h_{t-1} + b_t.

    a, b: [B, S, D]; returns the h trace [B, S, D] in a's dtype.
    """
    af, bf = _float(a, b)
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=af.dtype, device=a.device)
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


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
