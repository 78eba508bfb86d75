"""Model building blocks of the port: norms, RoPE, GQA attention (prefill
and decode, full or windowed), the SwiGLU MLP, the top-k mixture of experts
with capacity-based dispatch, and the recurrent mixers —
Mamba-2 (SSD) and RG-LRU blocks with their causal depthwise convs —
functions over parameter dicts, parameterized by
:class:`repro_torch.configs.ArchConfig`.

Port of ``repro/models/layers.py``.  The
hot spots go through :mod:`repro_torch.kernels.ops`: on the card the
hand-written kernels (``flash_attention`` and ``decode_attention`` for
attention, ``ssd_scan`` for the Mamba-2 prefill, ``rglru_scan`` for the
RG-LRU prefill), on the CPU their plain versions.  A decode step of the
recurrent mixers is one recurrence step in PyTorch ops, as in the
reference.  Matmuls run in :data:`COMPUTE_DTYPE` (bf16), read at call time
as in the reference; softmax, normalizers, gates and recurrent state in
fp32.  Decode updates the caches in place (they are views into the model's
stacked caches; the reference returns new ones) at a position held on the
device, so one decode step captured in a CUDA graph serves every position.
The experts run as batched torch products, as the reference's are XLA
einsums (no Pallas kernel).

Under a sharding policy with a mesh (``pol``, :mod:`repro_torch.sharding`)
the blocks take DTensors and ``pol.shard`` them where the reference's blocks
constrain their activations: attention's context-parallel layout (either
``attn_mode``), SwiGLU's hidden over ``tp``, the MoE's EP and TP modes, the
recurrent mixers' channels over ``tp``.  On the serving route every kernel
runs on the rank's local shards (``pol.local``), and its result is put back
as a DTensor (``pol.from_local``): K3 on the rank's q rows, whose positions
start at ``q_offset``, against the whole K/V; K4 on the rank's heads, or on
its slots of a cache whose slots are split over ``tp`` (the ranks' rows then
combine by their log-sum-exps, one all-gather and one all-reduce over
``tp``); K5 and K6 on the rank's heads and channels.  The decode caches are
DTensors at ``lm.cache_specs``' placements, written in place through their
local shards.  The recurrent scans of the training route run on the rank's
heads and channels too, autograd going through ``to_local`` /
``from_local``.  The constants a block makes meet DTensors as replicated ones
(``pol.constants()``).  DTensor has a sharding rule for every other op the
route runs (``scatter_add``, ``cumsum``, ``index_add``, the index gathers);
where a rule needs the whole of a dim it all-gathers it itself.  The MoE's dispatch and combine, which index across the batch,
are replicated explicitly before them.

Training takes another route through the mixers, chosen by the caller
(``train=True``, passed down by :func:`repro_torch.models.lm.forward` and
``loss_fn``), never from ``requires_grad`` or the grad mode: the reference's
training forward calls no Pallas kernel, and none has a backward, so the
port's calls none of the hand-written ones either.  Attention goes through
:func:`blocked_attention` (``repro/models/layers.py:73``), the Mamba-2 scan
through :func:`ssd_chunked` (``_ssd_chunked_jnp``, ``repro/kernels/ops.py:136``)
and the RG-LRU recurrence through :func:`rglru_trace` (``rglru_ref``,
``repro/kernels/ref.py:117``) — torch ops that autograd differentiates, each
building its result with ``torch.stack`` rather than writing slices of a
preallocated tensor (whose backward would copy the whole tensor once a
slice).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import _meta, ops
from repro_torch.kernels.ref import rglru_closed_form
from repro_torch.sharding.policies import ShardingPolicy, is_dtensor

_NO_MESH = ShardingPolicy()

__all__ = [
    "rms_norm",
    "rope",
    "device_position",
    "blocked_attention",
    "attention_block",
    "attention_decode",
    "cache_roles",
    "swiglu_mlp",
    "moe_route",
    "moe_block",
    "causal_conv1d",
    "conv1d_step",
    "mamba2_block",
    "mamba2_decode",
    "rglru_block",
    "rglru_decode",
    "ssd_chunked",
    "rglru_trace",
]

_MASK = -1.0e30
COMPUTE_DTYPE = torch.bfloat16


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor | int, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, hd]; positions: [S], or one
    position (decode) as an int or a 0-d tensor: the angles are the same
    float32 products ``float(pos) * freq`` either way."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    pos = torch.as_tensor(positions, device=x.device)
    angles = pos.float().reshape(-1, 1) * freqs  # [S, half]
    cos = torch.cos(angles)[..., None, :]  # [S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def device_position(pos: torch.Tensor | int, device: torch.device) -> torch.Tensor:
    """A decode position as a 0-d int32 tensor on ``device`` (an int is
    copied there; a tensor already there is returned as it is)."""
    return torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(())


def _window(cfg: ArchConfig, mixer: str) -> int | None:
    if mixer == "swa":
        return cfg.window
    if mixer == "local":
        return cfg.local_window
    return None


def _qkv(xb: torch.Tensor, p: dict, cfg: ArchConfig, pol: ShardingPolicy = _NO_MESH,
         roles: tuple | None = None):
    """q/k/v projections of ``xb`` [..., D] → [..., H, hd] (bias, qk-norm).
    Under a mesh in ``a2a`` mode each projection keeps its natural feature
    sharding over ``tp``, then moves to sequence sharding by an activation
    all-to-all (the reference's ``_proj``); ``roles`` (the sharded decode's)
    lays each projection out before its heads are split instead.  DTensor
    cannot split a feature dim into heads the ``tp`` axis does not divide
    (JAX pads): in ``gather`` mode such a projection moves to sequence
    sharding first, where the block puts q anyway, and the biases are
    replicated before the split."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = xb.shape[:-1]

    def proj(w, heads):
        y = xb @ _bf(w)
        if roles is not None:
            y = pol.shard(y, *roles)
        elif pol.attn_mode == "a2a":
            y = pol.shard(y, "batch", None, "tp")
            y = pol.shard(y, "batch", "tp", None)
        elif heads % pol.tp_size:
            y = pol.shard(y, "batch", "tp", None)
        return y.view(*lead, heads, hd)

    def bias(b, heads):
        b = _bf(b)
        return (b if pol.mesh is None else pol.shard(b, None)).view(heads, hd)

    q, k, v = proj(p["wq"], hq), proj(p["wk"], hkv), proj(p["wv"], hkv)
    if cfg.qkv_bias:
        q = q + bias(p["bq"], hq)
        k = k + bias(p["bk"], hkv)
        v = v + bias(p["bv"], hkv)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    kv_chunk: int = 1024,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks, the training route's
    attention (``repro/models/layers.py:73``).

    q: [B, Sq, Hq, hd]; k/v: [B, Skv, Hkv, hd].  Scores, the running max,
    the normalizer and the accumulator in float32; masked scores are
    -1e30.  The chunk is the largest divisor of Skv not above
    ``kv_chunk``, so memory is bounded by one [B, Sq, Hq, chunk] score
    block.  Written in torch ops, so autograd differentiates it.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (hd**0.5)
    kv_chunk = min(kv_chunk, skv)
    while skv % kv_chunk:  # largest divisor of skv <= requested chunk
        kv_chunk -= 1
    qf = q.reshape(b, sq, hkv, group, hd).float() * sm_scale
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, sq, hkv, group, 1), _MASK, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, hkv, group, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hkv, group, hd), dtype=torch.float32, device=q.device)
    for j in range(skv // kv_chunk):
        kb = k[:, j * kv_chunk : (j + 1) * kv_chunk].float()
        vb = v[:, j * kv_chunk : (j + 1) * kv_chunk].float()
        k_pos = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        mask = torch.ones((sq, kv_chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask[None, :, None, None, :], s, _MASK)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = corr * acc + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).reshape(b, sq, hq, hd).to(q.dtype)


def attention_block(
    x: torch.Tensor,
    p: dict,
    cfg: ArchConfig,
    mixer: str,
    *,
    positions: torch.Tensor | None = None,
    return_kv: bool = False,
    train: bool = False,
    pol: ShardingPolicy = _NO_MESH,
):
    """GQA attention over a full sequence (prefill, or training with
    ``train``).  x: [B, S, D].

    Prefill: the attention is :func:`repro_torch.kernels.ops.attention` on
    ``[B, H, S, hd]`` views of the projections (nothing is copied for the
    kernel); its output comes back with the same strides.  Training:
    :func:`blocked_attention` on the ``[B, S, H, hd]`` projections.

    Under a mesh (``pol``), the reference's context-parallel layout: q
    sequence-sharded over ``tp``, K/V replicated over it (the all-gather a
    layer costs), the output back to feature sharding (``a2a``) for the
    out-projection against its resident ``tp`` shard of ``wo``.  At
    prefill each rank runs the kernel on its own q rows, masked by their
    global positions (``q_offset``), against the whole K/V.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(_bf(x), p, cfg, pol)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = pol.shard(q, "batch", "tp", None, None)
    k = pol.shard(k, "batch", None, None, None)
    v = pol.shard(v, "batch", None, None, None)
    if train:
        of = blocked_attention(q, k, v, causal=True, window=_window(cfg, mixer))
    else:
        of = _prefill_attention(q, k, v, _window(cfg, mixer), pol)
    of = pol.shard(of, "batch", "tp", None, None)
    of = of.reshape(b, s, cfg.n_heads * cfg.head_dim)
    if pol.attn_mode == "a2a":
        of = pol.shard(of, "batch", None, "tp")
    out = pol.shard(_bf(of) @ _bf(p["wo"]), "batch", None, None)
    if return_kv:
        return out, (k, v)
    return out


def _prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       window: int | None, pol: ShardingPolicy) -> torch.Tensor:
    """The prefill kernel on ``[B, S, H, hd]`` projections: on ``[B, H, S,
    hd]`` views of them (nothing copied), the output with the same strides.
    Under a mesh, on this rank's shards: its q rows (the sequence over
    ``tp``), whose first position is the shard's offset, against the whole
    K/V of its batch rows; the result is the DTensor of q's layout."""
    if pol.mesh is None:
        o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=True, window=window)
        return o.transpose(1, 2)
    q_roles, kv_roles = ("batch", "tp", None, None), ("batch", None, None, None)
    _, off = pol.local_box(tuple(q.shape), *q_roles)
    ql, kl, vl = pol.local(q, *q_roles), pol.local(k, *kv_roles), pol.local(v, *kv_roles)
    o = ops.attention(ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
                      causal=True, window=window, q_offset=off[1])
    return pol.from_local(o.transpose(1, 2), tuple(q.shape), *q_roles)


def cache_roles(cfg: ArchConfig, pol: ShardingPolicy) -> tuple:
    """Roles of an attention cache ``[B, W, Hkv, hd]`` (the reference's
    layout, ``repro/models/layers.py:237-240``): the KV heads over ``tp``
    when they divide it, else the cache's slots."""
    if pol.tp_size > 1 and cfg.n_kv_heads % pol.tp_size == 0:
        return ("batch", None, "tp", None)
    return ("batch", "tp", None, None)


def _write_row(k_cache, v_cache, k, v, slot, keep, lo: int):
    """Write one new K/V row per batch row at cache slot ``slot`` (a 1-element
    int64 device tensor) where ``keep`` holds, in place: ``k_cache`` holds
    the slots ``[lo, lo + W_local)`` (a rank's share of a cache whose slots
    are split over ``tp``); a slot outside them, or ``keep`` false, writes
    the clamped slot's row back as it was, so nothing is read on the host."""
    w_local = k_cache.shape[1]
    if w_local == 0:
        return
    li = slot - lo
    keep = keep & (li >= 0) & (li < w_local)
    li = li.clamp(0, w_local - 1)
    k = torch.where(keep, k, k_cache.index_select(1, li)[:, 0])
    v = torch.where(keep, v, v_cache.index_select(1, li)[:, 0])
    k_cache.index_copy_(1, li, k[:, None])
    v_cache.index_copy_(1, li, v[:, None])


def _combine_over_tp(o: torch.Tensor, lse: torch.Tensor, pol: ShardingPolicy) -> torch.Tensor:
    """The attention over every rank's slots, from each rank's ``(o,
    lse)`` over its own: one all-gather of the ``[tp, B, Hq]`` log-sum-exps
    and one all-reduce of the weighted ``o`` over ``tp`` (the weights of
    :func:`repro_torch.kernels.ref.lse_weights`)."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.kernels.ref import lse_weights

    dim = tuple(pol.mesh.mesh_dim_names).index(pol.tp_axis)
    group = (pol.mesh, dim)
    lses = funcol.all_gather_single(lse.contiguous(), 0, group).view(pol.tp_size, *lse.shape)
    w = lse_weights(lses)[pol.mesh.get_local_rank(dim)]
    return funcol.all_reduce(o.float() * w[..., None], "sum", group).to(o.dtype)


def _attention_decode_sharded(x, p, cache, pos, cfg, mixer, pol):
    """:func:`attention_decode` under a mesh: the projections as DTensors,
    then K4 on this rank's shards of the cache (``cache_roles``): its KV
    heads with their q heads, or its slots with every q head and the
    ranks' results combined over ``tp``.  The new row is written into the
    rank's shard by a device-side slot (only the rank holding the slot
    keeps it); ``slot_pos`` is replicated and written on every rank."""
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    roles = cache_roles(cfg, pol)
    heads_tp = roles[2] == "tp"
    hroles = ("batch", "tp", None) if heads_tp else ("batch", None, None)
    q, k, v = _qkv(_bf(x[:, 0]), p, cfg, pol, roles=hroles[:2])  # [B, H, hd]
    q = rope(q[:, None], pos, cfg.rope_theta)[:, 0]
    k = rope(k[:, None], pos, cfg.rope_theta)[:, 0]
    kc, vc = cache["k"].to_local(), cache["v"].to_local()
    slot_pos = cache["slot_pos"].to_local()  # whole on every rank
    w_len = cache["k"].shape[1]
    _, off = pol.local_box(tuple(cache["k"].shape), *roles)
    windowed = mixer in ("swa", "local")
    ql = pol.local(q, *hroles)
    kn, vn = pol.local(k, *hroles).to(kc.dtype), pol.local(v, *hroles).to(vc.dtype)
    if windowed:
        slot, keep = (pos % w_len).long().reshape(1), torch.ones_like(pos, dtype=torch.bool)
    else:
        slot, keep = pos.clamp(max=w_len - 1).long().reshape(1), pos < w_len
    _write_row(kc, vc, kn, vn, slot, keep, off[1])
    written = torch.where(keep, pos, slot_pos.index_select(0, slot)[0])
    slot_pos.index_copy_(0, slot, written.reshape(1))
    slot_lo = pos - (cfg.window or cfg.local_window or w_len) if windowed else -1
    sp = slot_pos[off[1]:off[1] + kc.shape[1]]
    kv = kc.transpose(1, 2), vc.transpose(1, 2)
    if heads_tp or pol.tp_size == 1:
        o = ops.decode_attention(ql, *kv, slot_pos=sp, slot_lo=slot_lo)
    else:
        o, lse = ops.decode_attention(ql, *kv, slot_pos=sp, slot_lo=slot_lo, return_lse=True)
        o = _combine_over_tp(o, lse, pol)
    o = pol.from_local(o, (b, hq, hd), *hroles)
    # the output reduced over tp, as the prefill's block ends (a partial sum
    # left pending would make DTensor run the MLP's products on every tp
    # rank whole rather than reduce it)
    return pol.shard(_bf(o.reshape(b, 1, hq * hd)) @ _bf(p["wo"]), "batch", None, None), cache


def attention_decode(
    x: torch.Tensor,
    p: dict,
    cache: dict,
    pos: torch.Tensor | int,
    cfg: ArchConfig,
    mixer: str,
    pol: ShardingPolicy = _NO_MESH,
):
    """One-token attention against the cache.

    x: [B, 1, D]; cache: {"k","v": [B, W, Hkv, hd], "slot_pos": i32[W]};
    pos: a 0-d int32 tensor on x's device (an int is put there).  The new
    K/V row and its ``slot_pos`` are written IN PLACE (the cache is views
    into the model's stacked cache; the reference returns a new one) at a
    slot computed on the device, and the attention reads ``[B, Hkv, W,
    hd]`` views of the cache.

    * ``full``: slot = pos; a write past the cache (``pos >= W``) is a
      no-op, as in the reference: the slot is clamped to ``W - 1`` and
      that one row is written back as it was.  A slot is valid when
      ``slot_pos >= 0`` (``slot_lo = -1``): the kernel reads ``slot_pos``
      itself, so no length is computed per layer and step.
    * ``swa`` / ``local``: a ring buffer, slot = ``pos % W``.  A slot is
      valid when ``slot_pos >= 0`` and ``slot_pos > pos - window``
      (``repro/models/layers.py:260-262``); after a prefill whose length
      is not a multiple of the window the valid slots are not a prefix, so
      the kernel is handed ``slot_pos`` and the bound ``pos - window`` as a
      device scalar and applies the rule per slot.

    Under a mesh (``pol``; x a DTensor, the cache's leaves DTensors at
    ``lm.cache_specs``' placements): the reference's cache layout
    (:func:`cache_roles`).  With the KV heads over ``tp`` the kernel runs on
    the rank's heads; with the slots over ``tp`` on the rank's slots and
    their ``slot_pos``, returning its log-sum-exp, and the ranks' rows are
    combined over ``tp``.  The new row lands only on the rank that holds
    its slot, by a device-side index and mask.

    Returns (out, cache).
    """
    pos = device_position(pos, x.device)
    if pol.mesh is not None:
        return _attention_decode_sharded(x, p, cache, pos, cfg, mixer, pol)
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(_bf(x[:, 0]), p, cfg)
    q = rope(q[:, None], pos, cfg.rope_theta)[:, 0]
    k = rope(k[:, None], pos, cfg.rope_theta)[:, 0]
    k_cache, v_cache, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    w_len = k_cache.shape[1]
    windowed = mixer in ("swa", "local")
    k, v, written = k.to(k_cache.dtype), v.to(v_cache.dtype), pos
    if windowed:
        slot = (pos % w_len).long().reshape(1)
    else:
        slot = pos.clamp(max=w_len - 1).long().reshape(1)
        keep = pos < w_len  # past the cache the row is written back unchanged
        k = torch.where(keep, k, k_cache.index_select(1, slot)[:, 0])
        v = torch.where(keep, v, v_cache.index_select(1, slot)[:, 0])
        written = torch.where(keep, pos, slot_pos.index_select(0, slot)[0])
    k_cache.index_copy_(1, slot, k[:, None])
    v_cache.index_copy_(1, slot, v[:, None])
    slot_pos.index_copy_(0, slot, written.reshape(1))
    kv = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    slot_lo = pos - (cfg.window or cfg.local_window or w_len) if windowed else -1
    o = ops.decode_attention(q, *kv, slot_pos=slot_pos, slot_lo=slot_lo)
    out = _bf(o.reshape(b, 1, hq * hd)) @ _bf(p["wo"])
    return out, cache


def swiglu_mlp(x: torch.Tensor, p: dict, *, pol: ShardingPolicy = _NO_MESH) -> torch.Tensor:
    """SwiGLU: (silu(x·Wg) ⊙ x·Wi)·Wo, hidden sharded over tp."""
    xb = _bf(x)
    g = pol.shard(xb @ _bf(p["wg"]), "batch", None, "tp")
    h = pol.shard(xb @ _bf(p["wi"]), "batch", None, "tp")
    a = F.silu(g.float()).to(COMPUTE_DTYPE) * h
    return pol.shard(a @ _bf(p["wo"]), "batch", None, None)


def _topk_iterative(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k as k rounds of argmax and mask, the reference's order among
    equal values: ``argmax`` takes the first maximum, where ``torch.topk``'s
    order among ties differs.  Returns (values, int32 indices), each
    ``[..., k]``.  The reference's mask ``cur - one_hot(i) · 1e9`` is a
    ``scatter_add`` of -1e9 at ``i`` here: the same floats (``a - 1e9 ==
    a + (-1e9)``, ``a - 0 == a``) in one kernel a round, with no host
    read, so a CUDA graph can capture it."""
    vals, idxs = [], []
    cur = probs
    mask = torch.full((*probs.shape[:-1], 1), -1e9, dtype=probs.dtype, device=probs.device)
    for _ in range(k):
        i = torch.argmax(cur, dim=-1, keepdim=True)
        vals.append(torch.gather(cur, -1, i))
        idxs.append(i)
        cur = cur.scatter_add(-1, i, mask)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1).to(torch.int32)


MOE_CHUNK = 4096  # dispatch group length of a long sequence (the reference's)


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: ArchConfig,
              capacity_factor: float = 1.25, *, pol: ShardingPolicy = _NO_MESH) -> dict:
    """The router of :func:`moe_block` over one dispatch group a batch row.
    x: [B, S, D].  Returns ``gate_w`` float32 ``[B, S, k]`` (renormalised,
    the sum clipped at 1e-9), ``gate_i`` int32 ``[B, S, k]``, ``pos``
    int64 ``[B, S, k]`` (the (token, slot)'s place in its expert's buffer,
    counted along the row's flattened ``S·k`` order), ``keep`` bool
    ``[B, S, k]`` (``pos < cap``) and ``cap``.  Under a mesh the router
    logits and the top-k are pinned to batch sharding, as the reference's
    are (``repro/models/layers.py:341-349``)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = pol.shard(x.float() @ router.float(), "batch", None, None)
    gate_w, gate_i = _topk_iterative(torch.softmax(logits, dim=-1), k)
    gate_w = pol.shard(gate_w, "batch", None, None)
    gate_i = pol.shard(gate_i, "batch", None, None)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    cap = int(s * k * capacity_factor / e) + 1
    flat = gate_i.reshape(b, s * k).long()
    seen = (flat[..., None] == torch.arange(e, device=x.device)).cumsum(1)
    pos = torch.gather(seen, -1, flat[..., None])[..., 0] - 1
    pos = pos.reshape(b, s, k)
    return {"gate_w": gate_w, "gate_i": gate_i, "pos": pos, "keep": pos < cap, "cap": cap}


def moe_block(x: torch.Tensor, p: dict, cfg: ArchConfig, *,
              capacity_factor: float = 1.25, pol: ShardingPolicy = _NO_MESH) -> torch.Tensor:
    """Top-k MoE with capacity-based dispatch (``repro/models/layers.py:308``).
    x: [B, S, D] → [B, S, D].

    Each batch row is a dispatch group; a sequence longer than 4,096 tokens
    and a multiple of it is cut into 4,096-token groups.  Routing in
    float32 (:func:`moe_route`): a (token, slot) past its expert's capacity
    is dropped.  The reference's one-hot einsums become indexing, the same
    function without its ``[B, S, E, C]`` products: the kept rows are
    scattered into an ``[E, B·C, D]`` buffer (dropped ones into a spare row
    that is cut off), the experts run as batched products over E (silu in
    float32 between bf16 products), and each token gathers its slots' rows
    back, weighted by the bf16 gate weights, summed in float32.  The
    sharding modes of the reference (EP, TP) compute the same function on
    one card.  Nothing is read back to the host and every shape follows
    from the input's, so a decode step with experts can be captured in a
    CUDA graph; the routing indices carry no gradient, the gate weights do
    (the reference's ``stop_gradient`` on its masks).

    Under a mesh (``pol``), the reference's two modes: EP when ``tp``
    divides E (the experts and their buffers over the ep axes, the batch
    over the rest), else TP (each expert's hidden dim over ``tp``).  The
    dispatch (``index_add`` of every row into the buffer) and the combine
    (each token's gather from it) index across the batch, so their inputs
    are replicated over the mesh just before them (``pol.shard`` to no
    role); the experts' products run sharded."""
    b, s, d = x.shape
    chunk = min(s, MOE_CHUNK)
    if s > chunk and s % chunk == 0:
        y = moe_block(x.reshape(b * (s // chunk), chunk, d), p, cfg,
                      capacity_factor=capacity_factor, pol=pol)
        return y.reshape(b, s, d)
    e, k = cfg.n_experts, cfg.top_k
    ep = pol.tp_size > 1 and e % pol.tp_size == 0
    r = moe_route(x, p["router"], cfg, capacity_factor, pol=pol)
    cap = r["cap"]
    rows = torch.arange(b, device=x.device)[:, None, None]
    dest = torch.where(r["keep"], (r["gate_i"].long() * b + rows) * cap + r["pos"], e * b * cap)
    dest = pol.shard(dest.reshape(-1), None)  # replicated: indexes every batch row
    src = pol.shard(_bf(x)[:, :, None].expand(b, s, k, d).reshape(-1, d), None, None)
    xe = torch.zeros((e * b * cap + 1, d), dtype=src.dtype, device=x.device)
    xe = xe.index_add(0, dest, src)[:-1].view(e, b, cap, d)  # kept rows land once each
    if ep:
        xe = pol.shard(xe, "ep", "batch_minus_ep", None, None)
    xe = xe.view(e, b * cap, d)
    h = torch.bmm(xe, _bf(p["w_in"]))
    g = torch.bmm(xe, _bf(p["w_gate"]))
    if not ep:
        h = pol.shard(h.view(e, b, cap, -1), None, "batch", None, "tp").view(h.shape)
        g = pol.shard(g.view(e, b, cap, -1), None, "batch", None, "tp").view(g.shape)
    a = F.silu(g.float()).to(COMPUTE_DTYPE) * h
    ye = torch.bmm(a, _bf(p["w_out"])).view(e, b, cap, d)
    if ep:
        ye = pol.shard(ye, "ep", "batch_minus_ep", None, None)
    ye = pol.shard(ye, None, None, None, None).reshape(e * b * cap, d)  # the combine's gather
    picked = ye[dest.clamp(max=e * b * cap - 1)].view(b, s, k, d)
    w = torch.where(r["keep"], _bf(r["gate_w"]).float(), 0.0)
    out = (picked.float() * w[..., None]).sum(2).to(ye.dtype)
    return pol.shard(out, "batch", None, None)


# ---------------------------------------------------------------------------
# Causal depthwise conv (mamba2 / rglru branches)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: [B, S, C]; w: [K, C].  The taps are
    summed in float32 in order ``i = 0..K-1``, then cast to x's dtype."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + pad[:, i : i + s].float() * w[i].float()
    return out.to(x.dtype)


def conv1d_step(
    x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x_t: [B, C]; conv_state: [B, K-1, C] (history).
    Returns (y [B, C] in x_t's dtype, the new history [B, K-1, C])."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)  # [B, K, C]
    y = torch.zeros(x_t.shape, dtype=torch.float32, device=x_t.device)
    for i in range(w.shape[0]):
        y = y + window[:, i].float() * w[i].float()
    return y.to(x_t.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # F.softplus returns x itself above 20 where JAX computes logaddexp(x, 0);
    # they differ by log1p(exp(-x)) < 2.1e-9 there, below the float32
    # resolution of a value >= 20 (1.9e-6).
    return F.softplus(x)


def _ssm_gates(dt_raw: torch.Tensor, p: dict):
    """Δ = softplus(dt + bias); a = exp(−Δ·exp(A_log)).  dt_raw: [..., H]."""
    delta = _softplus(dt_raw.float() + p["dt_bias"].float())
    a = torch.exp(-delta * torch.exp(p["A_log"].float()))
    return delta, a


def ssd_chunked(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
) -> torch.Tensor:
    """The training route's Mamba-2 scan: the chunked SSD of
    ``_ssd_chunked_jnp`` (``repro/kernels/ops.py:136``) in float32, in torch
    ops that autograd differentiates.  x ``[B, S, H, P]``, a ``[B, S, H]``,
    b/c ``[B, S, G, N]``; ``chunk = min(chunk, S)`` must divide S
    (``ValueError`` otherwise, where the reference's reshape fails).

    Within a chunk ``((C Bᵀ) ⊙ causal decay) X``, across chunks the
    ``[N, P]`` states carried in order.  All heads at once (the reference
    maps over heads to bound its ``[B, nc, L, L]`` decay matrices; at a
    microbatch of a training step the ``[B, nc, H, L, L]`` block is a few
    hundred MB and is freed layer by layer); the decay is masked before its
    ``exp``, so no ``inf`` reaches the backward."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    if chunk <= 0 or s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc = s // chunk
    xc = x.float().reshape(bs, nc, chunk, h, p)
    bh = b.float().reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)  # [B,nc,L,H,N]
    ch = c.float().reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cum = torch.cumsum(torch.log(a.float().reshape(bs, nc, chunk, h)), dim=2)  # [B,nc,L,H]
    tpos = torch.arange(chunk, device=x.device)
    causal = tpos[:, None] >= tpos[None, :]  # [L, L]
    cum_t = cum.transpose(2, 3)  # [B,nc,H,L]
    diff = torch.where(causal, cum_t[..., :, None] - cum_t[..., None, :], -torch.inf)
    cb = torch.einsum("bkthn,bkshn->bkhts", ch, bh)  # [B,nc,H,L,L]
    y_intra = torch.einsum("bkhts,bkshp->bkthp", cb * torch.exp(diff), xc)
    decay_end = torch.exp(cum[:, :, -1:] - cum)  # [B,nc,L,H]
    states = torch.einsum("bkthn,bkth,bkthp->bkhnp", bh, decay_end, xc)  # [B,nc,H,N,P]
    chunk_decay = torch.exp(cum[:, :, -1])  # [B,nc,H]
    carry = torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
    h_prev = []
    for k in range(nc):
        h_prev.append(carry)
        carry = chunk_decay[:, k, :, None, None] * carry + states[:, k]
    y_inter = torch.einsum("bkthn,bkhnp,bkth->bkthp", ch, torch.stack(h_prev, dim=1),
                           torch.exp(cum))
    return (y_intra + y_inter).reshape(bs, s, h, p).to(x.dtype)


def _ssd_shards(scan, xh, a, bmat, cmat, pol: ShardingPolicy):
    """``scan(x, a, b, c)`` — the prefill's SSD kernel or the training
    route's :func:`ssd_chunked` — → ``(y, final state or None)``.  Under a
    mesh on this rank's heads (``[B, S, H, P]`` over ``tp`` on H) with their
    B/C groups (all of them when there is one group, else the rank's share,
    which needs ``tp`` to divide the groups), on plain tensors: autograd
    goes through ``to_local`` / ``from_local``, and DTensor does not
    propagate shardings op by op through the scan's chunk loop (on the
    2 × 16 × 16 mesh that took minutes a layer)."""
    if pol.mesh is None:
        y = scan(xh, a, bmat, cmat)
        return y if isinstance(y, tuple) else (y, None)
    g = bmat.shape[2]
    if g > 1 and g % pol.tp_size:
        raise NotImplementedError(f"{g} SSD groups over a tp of {pol.tp_size}")
    groles = ("batch", None, "tp" if g > 1 else None, None)  # one group: whole on each rank
    b_l, c_l = (pol.local(t, *groles, grad_partial=True).contiguous() for t in (bmat, cmat))
    y = scan(pol.local(xh, "batch", None, "tp", None).contiguous(),
             pol.local(a, "batch", None, "tp").contiguous(), b_l, c_l)
    y, state = y if isinstance(y, tuple) else (y, None)
    y = pol.from_local(y, tuple(xh.shape), "batch", None, "tp", None)
    if state is not None:
        b, _, h, p = xh.shape
        state = pol.from_local(state, (b, h, bmat.shape[3], p), "batch", "tp", None, None)
    return y, state


def mamba2_block(
    x: torch.Tensor, p: dict, cfg: ArchConfig, *, ssd_chunk: int = 128, return_state: bool = False,
    train: bool = False, pol: ShardingPolicy = _NO_MESH,
):
    """Mamba-2 mixer (prefill, or training with ``train``).  x: [B, S, D].
    The SSD scan is :func:`repro_torch.kernels.ops.ssd` (training:
    :func:`ssd_chunked`) with ``chunk = min(ssd_chunk, S)``, which must
    divide S (the reference's quirk: S above 128 and not a multiple of it
    raises).  With ``return_state`` (prefill only), also the decode state
    {"ssm": [B, H, N, P] f32, "conv": {x, b, c: [B, K-1, ·]}}, the SSD
    scan's final state.  Under a mesh the scan runs on the rank's heads."""
    if train and return_state:
        raise ValueError("the training route returns no decode state")
    b, s, _ = x.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    xb = _bf(x)
    z = pol.shard(xb @ _bf(p["wz"]), "batch", None, "tp")  # [B, S, di]
    x_raw = pol.shard(xb @ _bf(p["wx"]), "batch", None, "tp")
    b_raw = xb @ _bf(p["wb"])  # [B, S, G*N]
    c_raw = xb @ _bf(p["wc"])
    dt = xb @ _bf(p["wdt"])  # [B, S, H]
    xr = F.silu(causal_conv1d(x_raw, p["conv_x"]).float())
    bc = F.silu(causal_conv1d(b_raw, p["conv_b"]).float())
    cc = F.silu(causal_conv1d(c_raw, p["conv_c"]).float())
    delta, a = _ssm_gates(dt, p)  # [B, S, H]
    xh = xr.view(b, s, nh, hp) * delta[..., None]  # Δ-scaled input
    bmat, cmat = bc.view(b, s, g, n), cc.view(b, s, g, n)
    if train:
        scan = functools.partial(ssd_chunked, chunk=ssd_chunk)
    else:
        scan = functools.partial(ops.ssd, chunk=min(ssd_chunk, s), return_state=return_state)
    y, state = _ssd_shards(scan, xh, a, bmat, cmat, pol)
    y = y + xr.view(b, s, nh, hp) * p["d_skip"].float()[:, None]
    y = y.reshape(b, s, di)
    # gated RMSNorm then output projection
    y = rms_norm(y.to(COMPUTE_DTYPE), p["norm"]) * F.silu(z.float()).to(COMPUTE_DTYPE)
    out = pol.shard(_bf(y) @ _bf(p["wo"]), "batch", None, None)
    if not return_state:
        return out
    k = cfg.conv_kernel
    conv = {"x": x_raw[:, -(k - 1):], "b": b_raw[:, -(k - 1):], "c": c_raw[:, -(k - 1):]}
    return out, {"ssm": state, "conv": conv}


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``dst`` (a cache leaf under a mesh)
    takes ``src`` redistributed to its placements, written through its
    local shard."""
    if is_dtensor(dst):
        dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())
    else:
        dst.copy_(src)


def mamba2_decode(x: torch.Tensor, p: dict, cache: dict, cfg: ArchConfig,
                  pol: ShardingPolicy = _NO_MESH):
    """One-token Mamba-2 step.  x: [B, 1, D]; cache: {"ssm": [B, H, N, P],
    "conv": {x, b, c: [B, K-1, ·]}}, updated in place.  Returns (out,
    cache).  Under a mesh the state keeps the cache's layout (heads and
    channels over ``tp``), as the reference's constraints on its cache
    give; DTensor carries the step's ops, and the output is reduced over
    ``tp`` as the prefill block's is."""
    b = x.shape[0]
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    xb = _bf(x[:, 0])
    z = xb @ _bf(p["wz"])
    conv = cache["conv"]
    xr, cx = conv1d_step(xb @ _bf(p["wx"]), conv["x"], p["conv_x"])
    bc, cb = conv1d_step(xb @ _bf(p["wb"]), conv["b"], p["conv_b"])
    cc, ccs = conv1d_step(xb @ _bf(p["wc"]), conv["c"], p["conv_c"])
    dt = xb @ _bf(p["wdt"])
    xr, bc, cc = F.silu(xr.float()), F.silu(bc.float()), F.silu(cc.float())
    delta, a = _ssm_gates(dt, p)  # [B, H]
    xh = xr.view(b, nh, hp) * delta[..., None]
    bmat = bc.view(b, g, n).repeat_interleave(nh // g, dim=1)  # [B, H, N]
    cmat = cc.view(b, g, n).repeat_interleave(nh // g, dim=1)
    if pol.mesh is None:
        h = a[..., None, None] * cache["ssm"] + bmat[..., :, None] * xh[..., None, :]
        y = torch.einsum("bhn,bhnp->bhp", cmat, h)
    else:  # the recurrence on the rank's heads, where the state lies
        hr = ("batch", "tp", None)
        hl = (pol.local(a, "batch", "tp")[..., None, None] * cache["ssm"].to_local()
              + pol.local(bmat, *hr)[..., :, None] * pol.local(xh, *hr)[..., None, :])
        y = pol.from_local(torch.einsum("bhn,bhnp->bhp", pol.local(cmat, *hr), hl),
                           (b, nh, hp), *hr)
        h = pol.from_local(hl, tuple(cache["ssm"].shape), *hr, None)
    y = y + xr.view(b, nh, hp) * p["d_skip"].float()[:, None]
    y = y.reshape(b, di)
    y = rms_norm(y.to(COMPUTE_DTYPE), p["norm"]) * F.silu(z.float()).to(COMPUTE_DTYPE)
    out = pol.shard((_bf(y) @ _bf(p["wo"]))[:, None], "batch", None, None)
    _assign(cache["ssm"], h)
    _assign(conv["x"], cx)
    _assign(conv["b"], cb)
    _assign(conv["c"], ccs)
    return out, cache


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma) block
# ---------------------------------------------------------------------------

_LRU_C = 8.0


def _rglru_gates(u: torch.Tensor, p: dict):
    """Input gate i_t = σ(u·W_i); recurrence gate r_t = σ(u·W_r);
    a_t = exp(−c·softplus(Λ)·r_t);  b_t = √(1−a²)·i_t·u."""
    ub = _bf(u)
    gate_i = torch.sigmoid((ub @ _bf(p["w_gate_i"])).float())
    gate_r = torch.sigmoid((ub @ _bf(p["w_gate_r"])).float())
    a = torch.exp(-_LRU_C * _softplus(p["lam"].float()) * gate_r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gate_i * u.float()
    return a, b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def rglru_trace(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The training route's RG-LRU recurrence: ``h_t = a_t ⊙ h_{t-1} + b_t``
    from ``h_0 = 0`` in float32, step by step as ``rglru_ref``
    (``repro/kernels/ref.py:117``), the trace ``[B, S, D]`` stacked once in
    a's dtype, so autograd differentiates it."""
    af, bf = a.float(), b.float()
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def _rglru_shards(a: torch.Tensor, b: torch.Tensor, pol: ShardingPolicy,
                  train: bool) -> torch.Tensor:
    """The RG-LRU recurrence — the prefill's kernel, or with ``train`` the
    training route's :func:`rglru_trace` — under a mesh on this rank's
    channels, on plain tensors (autograd through ``to_local`` /
    ``from_local``).  On meta tensors (the dry-run's count: shapes only)
    either is the closed form :func:`~repro_torch.kernels.ref.rglru_closed_form`,
    a few ops in place of S steps; the kernel's is announced to the counter
    as its plain version (:mod:`repro_torch.kernels._meta`)."""
    scan = rglru_trace if train else ops.rglru
    if a.device.type == "meta":
        scan = rglru_closed_form if train else (
            lambda x, y: _meta.run("rglru_scan", rglru_closed_form, (x, y), x, y))
    if pol.mesh is None:
        return scan(a, b)
    roles = ("batch", None, "tp")
    h = scan(pol.local(a, *roles).contiguous(), pol.local(b, *roles).contiguous())
    return pol.from_local(h, tuple(a.shape), *roles)


def rglru_block(x: torch.Tensor, p: dict, cfg: ArchConfig, *, return_state: bool = False,
                train: bool = False, pol: ShardingPolicy = _NO_MESH):
    """Griffin recurrent block: W_out(GeLU(W_g x) ⊙ RGLRU(conv(W_x x))).
    x: [B, S, D].  The recurrence is :func:`repro_torch.kernels.ops.rglru`
    (training, with ``train``: :func:`rglru_trace`).  With ``return_state``
    (prefill only), also the decode state {"h": [B, W] f32, "conv":
    [B, K-1, W]}.  Under a mesh the recurrence runs on the rank's channels."""
    if train and return_state:
        raise ValueError("the training route returns no decode state")
    xb = _bf(x)
    gate_branch = _gelu((xb @ _bf(p["wg"])).float())
    u_raw = pol.shard(xb @ _bf(p["wx"]), "batch", None, "tp")
    a, bb = _rglru_gates(causal_conv1d(u_raw, p["conv"]), p)
    h = _rglru_shards(a, bb, pol, train)  # [B, S, W] f32 trace
    out = pol.shard(_bf(h * gate_branch) @ _bf(p["wo"]), "batch", None, None)
    if not return_state:
        return out
    return out, {"h": h[:, -1].float(), "conv": u_raw[:, -(cfg.conv_kernel - 1):]}


def rglru_decode(x: torch.Tensor, p: dict, cache: dict, cfg: ArchConfig,
                 pol: ShardingPolicy = _NO_MESH):
    """One-token RG-LRU step.  cache: {"h": [B, W], "conv": [B, K-1, W]},
    updated in place (under a mesh at the cache's layout, channels over
    ``tp``).  Returns (out, cache)."""
    xb = _bf(x[:, 0])
    gate_branch = _gelu((xb @ _bf(p["wg"])).float())
    u, conv_state = conv1d_step(xb @ _bf(p["wx"]), cache["conv"], p["conv"])
    a, bb = _rglru_gates(u, p)
    h = a * cache["h"] + bb
    out = pol.shard((_bf(h * gate_branch) @ _bf(p["wo"]))[:, None], "batch", None, None)
    _assign(cache["h"], h)
    _assign(cache["conv"], conv_state)
    return out, cache
