"""Model building blocks of the port: norms, RoPE, GQA attention (prefill
and decode, full or windowed), the SwiGLU MLP, and the recurrent mixers —
Mamba-2 (SSD) and RG-LRU blocks with their causal depthwise convs —
functions over parameter dicts, parameterized by
:class:`repro_torch.configs.ArchConfig`.

Port of ``repro/models/layers.py`` for text models without experts.  The
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
There is no sharding on one card.  MoE waits for its own slice (ROADMAP.md §1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

__all__ = [
    "rms_norm",
    "rope",
    "device_position",
    "attention_block",
    "attention_decode",
    "swiglu_mlp",
    "causal_conv1d",
    "conv1d_step",
    "mamba2_block",
    "mamba2_decode",
    "rglru_block",
    "rglru_decode",
]

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


def _qkv(xb: torch.Tensor, p: dict, cfg: ArchConfig):
    """q/k/v projections of ``xb`` [..., D] → [..., H, hd] (bias, qk-norm)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = xb.shape[:-1]
    q = (xb @ _bf(p["wq"])).view(*lead, hq, hd)
    k = (xb @ _bf(p["wk"])).view(*lead, hkv, hd)
    v = (xb @ _bf(p["wv"])).view(*lead, hkv, hd)
    if cfg.qkv_bias:
        q = q + _bf(p["bq"]).view(hq, hd)
        k = k + _bf(p["bk"]).view(hkv, hd)
        v = v + _bf(p["bv"]).view(hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def attention_block(
    x: torch.Tensor,
    p: dict,
    cfg: ArchConfig,
    mixer: str,
    *,
    positions: torch.Tensor | None = None,
    return_kv: bool = False,
):
    """GQA attention over a full sequence (prefill).  x: [B, S, D].

    The attention itself is :func:`repro_torch.kernels.ops.attention` on
    ``[B, H, S, hd]`` views of the projections (nothing is copied for the
    kernel); its output comes back with the same strides.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(_bf(x), p, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=True, window=_window(cfg, mixer))
    of = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    out = _bf(of) @ _bf(p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(
    x: torch.Tensor,
    p: dict,
    cache: dict,
    pos: torch.Tensor | int,
    cfg: ArchConfig,
    mixer: str,
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

    Returns (out, cache).
    """
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    pos = device_position(pos, x.device)
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


def swiglu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU: (silu(x·Wg) ⊙ x·Wi)·Wo."""
    xb = _bf(x)
    g = xb @ _bf(p["wg"])
    h = xb @ _bf(p["wi"])
    a = F.silu(g.float()).to(COMPUTE_DTYPE) * h
    return a @ _bf(p["wo"])


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


def mamba2_block(
    x: torch.Tensor, p: dict, cfg: ArchConfig, *, ssd_chunk: int = 128, return_state: bool = False
):
    """Mamba-2 mixer (prefill).  x: [B, S, D].  The SSD scan is
    :func:`repro_torch.kernels.ops.ssd` with ``chunk = min(ssd_chunk, S)``,
    which must divide S (the reference's quirk: S above 128 and not a
    multiple of it raises).  With ``return_state``, also the decode state
    {"ssm": [B, H, N, P] f32, "conv": {x, b, c: [B, K-1, ·]}}, the SSD
    scan's final state."""
    b, s, _ = x.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    xb = _bf(x)
    z = xb @ _bf(p["wz"])  # [B, S, di]
    x_raw = xb @ _bf(p["wx"])
    b_raw = xb @ _bf(p["wb"])  # [B, S, G*N]
    c_raw = xb @ _bf(p["wc"])
    dt = xb @ _bf(p["wdt"])  # [B, S, H]
    xr = F.silu(causal_conv1d(x_raw, p["conv_x"]).float())
    bc = F.silu(causal_conv1d(b_raw, p["conv_b"]).float())
    cc = F.silu(causal_conv1d(c_raw, p["conv_c"]).float())
    delta, a = _ssm_gates(dt, p)  # [B, S, H]
    xh = xr.view(b, s, nh, hp) * delta[..., None]  # Δ-scaled input
    bmat, cmat = bc.view(b, s, g, n), cc.view(b, s, g, n)
    y = ops.ssd(xh, a, bmat, cmat, chunk=min(ssd_chunk, s), return_state=return_state)
    y, state = y if return_state else (y, None)
    y = y + xr.view(b, s, nh, hp) * p["d_skip"].float()[:, None]
    y = y.reshape(b, s, di)
    # gated RMSNorm then output projection
    y = rms_norm(y.to(COMPUTE_DTYPE), p["norm"]) * F.silu(z.float()).to(COMPUTE_DTYPE)
    out = _bf(y) @ _bf(p["wo"])
    if not return_state:
        return out
    k = cfg.conv_kernel
    conv = {"x": x_raw[:, -(k - 1):], "b": b_raw[:, -(k - 1):], "c": c_raw[:, -(k - 1):]}
    return out, {"ssm": state, "conv": conv}


def mamba2_decode(x: torch.Tensor, p: dict, cache: dict, cfg: ArchConfig):
    """One-token Mamba-2 step.  x: [B, 1, D]; cache: {"ssm": [B, H, N, P],
    "conv": {x, b, c: [B, K-1, ·]}}, updated in place.  Returns (out,
    cache)."""
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
    h = a[..., None, None] * cache["ssm"] + bmat[..., :, None] * xh[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", cmat, h)
    y = y + xr.view(b, nh, hp) * p["d_skip"].float()[:, None]
    y = y.reshape(b, di)
    y = rms_norm(y.to(COMPUTE_DTYPE), p["norm"]) * F.silu(z.float()).to(COMPUTE_DTYPE)
    out = (_bf(y) @ _bf(p["wo"]))[:, None]
    cache["ssm"].copy_(h)
    conv["x"].copy_(cx)
    conv["b"].copy_(cb)
    conv["c"].copy_(ccs)
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


def rglru_block(x: torch.Tensor, p: dict, cfg: ArchConfig, *, return_state: bool = False):
    """Griffin recurrent block: W_out(GeLU(W_g x) ⊙ RGLRU(conv(W_x x))).
    x: [B, S, D].  The recurrence is :func:`repro_torch.kernels.ops.rglru`.
    With ``return_state``, also the decode state {"h": [B, W] f32, "conv":
    [B, K-1, W]}."""
    xb = _bf(x)
    gate_branch = _gelu((xb @ _bf(p["wg"])).float())
    u_raw = xb @ _bf(p["wx"])
    a, bb = _rglru_gates(causal_conv1d(u_raw, p["conv"]), p)
    h = ops.rglru(a, bb)  # [B, S, W] f32 trace
    out = _bf(h * gate_branch) @ _bf(p["wo"])
    if not return_state:
        return out
    return out, {"h": h[:, -1].float(), "conv": u_raw[:, -(cfg.conv_kernel - 1):]}


def rglru_decode(x: torch.Tensor, p: dict, cache: dict, cfg: ArchConfig):
    """One-token RG-LRU step.  cache: {"h": [B, W], "conv": [B, K-1, W]},
    updated in place.  Returns (out, cache)."""
    xb = _bf(x[:, 0])
    gate_branch = _gelu((xb @ _bf(p["wg"])).float())
    u, conv_state = conv1d_step(xb @ _bf(p["wx"]), cache["conv"], p["conv"])
    a, bb = _rglru_gates(u, p)
    h = a * cache["h"] + bb
    out = (_bf(h * gate_branch) @ _bf(p["wo"]))[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
