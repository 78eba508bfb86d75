"""Model building blocks of the port: norms, RoPE, GQA attention (prefill
and decode) and the SwiGLU MLP — functions over parameter dicts,
parameterized by :class:`repro_torch.configs.ArchConfig`.

Port of ``repro/models/layers.py`` for dense, attention-only text models.
Attention goes through :mod:`repro_torch.kernels.ops`: on the card the
hand-written kernels (``flash_attention`` for prefill, ``decode_attention``
for decode), on the CPU their plain versions.  Matmuls run in
:data:`COMPUTE_DTYPE` (bf16), read at call time as in the reference;
softmax and normalizers in fp32.  There is no sharding on one card.
MoE, Mamba-2 and RG-LRU blocks wait for their own slices (ROADMAP.md §1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops

__all__ = [
    "rms_norm",
    "rope",
    "attention_block",
    "attention_decode",
    "swiglu_mlp",
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
    position as an int (decode)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if isinstance(positions, int):
        angles = (freqs * positions)[None]  # [1, half]
    else:
        angles = positions.float()[..., None] * freqs  # [S, half]
    cos = torch.cos(angles)[..., None, :]  # [S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


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
    pos: int,
    cfg: ArchConfig,
    mixer: str,
):
    """One-token attention against the cache, for ``full`` mixers.

    x: [B, 1, D]; cache: {"k","v": [B, W, Hkv, hd], "slot_pos": i32[W]},
    slot = pos.  The new K/V row and its ``slot_pos`` are written IN PLACE
    (the cache is views into the model's stacked cache; the reference
    returns a new one); a write past the cache (``pos >= W``) is a no-op,
    as in the reference.  ``slot_pos`` of a full mixer is always the prefix
    ``[0, n)``, so the attention reads the first ``n = min(pos + 1, W)``
    slots, counted on the device: ``decode_attention``'s ``seq_lens``,
    over ``[B, Hkv, W, hd]`` views of the cache.  Returns (out, cache).
    """
    if mixer != "full":
        raise NotImplementedError(
            f"{mixer!r} decode (ring-buffer cache) waits for the recurrentgemma "
            "slice (ROADMAP.md §1)"
        )
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(_bf(x[:, 0]), p, cfg)
    q = rope(q[:, None], pos, cfg.rope_theta)[:, 0]
    k = rope(k[:, None], pos, cfg.rope_theta)[:, 0]
    k_cache, v_cache, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    if pos < k_cache.shape[1]:
        k_cache[:, pos] = k.to(k_cache.dtype)
        v_cache[:, pos] = v.to(v_cache.dtype)
        slot_pos[pos] = pos
    seq_lens = (slot_pos >= 0).sum(dtype=torch.int32).expand(b)
    o = ops.decode_attention(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2),
                             seq_lens=seq_lens)
    out = _bf(o.reshape(b, 1, hq * hd)) @ _bf(p["wo"])
    return out, cache


def swiglu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU: (silu(x·Wg) ⊙ x·Wi)·Wo."""
    xb = _bf(x)
    g = xb @ _bf(p["wg"])
    h = xb @ _bf(p["wi"])
    a = F.silu(g.float()).to(COMPUTE_DTYPE) * h
    return a @ _bf(p["wo"])
