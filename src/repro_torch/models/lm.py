"""LM assembly of the port: the layer stack as segments of repeated units,
parameter construction, forward, prefill and decode steps.

Port of ``repro/models/lm.py`` for dense, attention-only text models (every
layer ``full``, no experts).  The parameter tree is the reference's —
``embed/tok``, ``final_norm``, ``seg{i}/ln1_{j}``, ``seg{i}/m{j}/wq`` ...,
each leaf stacked over the segment's repeats — so a converted checkpoint
maps one to one (:func:`repro_torch.convert.lm_params`).  A Python loop
over layers takes the place of ``lax.scan``; there is no sharding on one
card.  Other mixers, experts and other modalities raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

__all__ = [
    "PDef",
    "check_supported",
    "segments",
    "padded_vocab",
    "param_defs",
    "init_params",
    "embed_inputs",
    "forward",
    "lm_logits",
    "init_cache",
    "decode_step",
    "prefill",
]

VOCAB_PAD = 2048


def padded_vocab(cfg: ArchConfig) -> int:
    return int(math.ceil(cfg.vocab_size / VOCAB_PAD) * VOCAB_PAD)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice of the port does
    not serve: other modalities, MoE, and any mixer but ``full``."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.modality} models wait for their slice (ROADMAP.md §1, M8)")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE (moe_block) waits for its slice (ROADMAP.md §1, M8)")
    other = sorted(set(cfg.layer_pattern) - {"full"})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: mixers {other} wait for their slices (ROADMAP.md §1: "
            "ssm with K5, rglru/local with K6, swa with the ring-buffer decode)")


# ---------------------------------------------------------------------------
# Segment grouping
# ---------------------------------------------------------------------------


def segments(cfg: ArchConfig) -> list[tuple[tuple[str, ...], int]]:
    """Group the layer pattern into (unit, repeats) segments.

    At each position, choose the unit length u ∈ {1..4} whose repetition
    covers the most layers (ties → shortest unit)."""
    pat = cfg.layer_pattern
    out: list[tuple[tuple[str, ...], int]] = []
    i = 0
    while i < len(pat):
        best_u, best_cover = 1, 0
        for u in range(1, 5):
            unit = pat[i : i + u]
            if len(unit) < u:
                break
            r = 1
            while pat[i + r * u : i + (r + 1) * u] == unit:
                r += 1
            cover = u * r
            if cover > best_cover:
                best_cover, best_u = cover, u
        unit = pat[i : i + best_u]
        repeats = best_cover // best_u
        out.append((tuple(unit), repeats))
        i += best_cover
    return out


# ---------------------------------------------------------------------------
# Parameter definitions (shape + init)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PDef:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros
    scale: float = 0.02

    @property
    def dtype(self) -> torch.dtype:
        """Matrix params live in bf16, norm scales in fp32 (the reference's
        mixed precision)."""
        if self.init == "normal" and len(self.shape) >= 2:
            return torch.bfloat16
        return torch.float32


def _attn_defs(cfg: ArchConfig, r: int) -> dict[str, PDef]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {
        "wq": PDef((r, d, hq * hd)),
        "wk": PDef((r, d, hkv * hd)),
        "wv": PDef((r, d, hkv * hd)),
        "wo": PDef((r, hq * hd, d), scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        out |= {
            "bq": PDef((r, hq * hd), init="zeros"),
            "bk": PDef((r, hkv * hd), init="zeros"),
            "bv": PDef((r, hkv * hd), init="zeros"),
        }
    if cfg.qk_norm:
        out |= {
            "q_norm": PDef((r, hd), init="zeros"),
            "k_norm": PDef((r, hd), init="zeros"),
        }
    return out


def _mlp_defs(cfg: ArchConfig, r: int) -> dict[str, PDef]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": PDef((r, d, f)),
        "wg": PDef((r, d, f)),
        "wo": PDef((r, f, d), scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _has_mlp(cfg: ArchConfig) -> bool:
    return cfg.d_ff > 0


def param_defs(cfg: ArchConfig) -> dict[str, Any]:
    """Nested dict of PDef mirroring the param tree."""
    check_supported(cfg)
    d = cfg.d_model
    defs: dict[str, Any] = {
        "embed": {"tok": PDef((padded_vocab(cfg), d), scale=1.0)},
        "final_norm": PDef((d,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = PDef((d, padded_vocab(cfg)))
    for i, (unit, r) in enumerate(segments(cfg)):
        seg: dict[str, Any] = {}
        for j, _mixer in enumerate(unit):
            seg[f"ln1_{j}"] = PDef((r, d), init="zeros")
            seg[f"m{j}"] = _attn_defs(cfg, r)
            if _has_mlp(cfg):
                seg[f"ln2_{j}"] = PDef((r, d), init="zeros")
                seg[f"mlp{j}"] = _mlp_defs(cfg, r)
        defs[f"seg{i}"] = seg
    return defs


def init_params(
    cfg: ArchConfig, seed: int = 0, *, device: str | torch.device | None = None
) -> dict:
    """Random parameters made on ``device`` (default the card) from one
    ``torch.Generator`` seeded with ``seed``, leaves in sorted-key order.
    The streams differ from ``jax.random``'s: tests that compare with the
    reference convert its parameters instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def build(node):
        if isinstance(node, PDef):
            if node.init == "zeros":
                return torch.zeros(node.shape, dtype=node.dtype, device=dev)
            out = torch.empty(node.shape, dtype=node.dtype, device=dev)
            return out.normal_(0.0, node.scale, generator=gen)
        return {k: build(node[k]) for k in sorted(node)}

    return build(param_defs(cfg))


def _layer(tree: dict, li: int) -> dict:
    """Views of layer ``li`` of a segment's stacked tree."""
    return {k: _layer(v, li) if isinstance(v, dict) else v[li] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Token embedding → [B, S, D] residual stream."""
    x = params["embed"]["tok"][batch["tokens"]]
    return x.to(L.COMPUTE_DTYPE)


def _mlp_apply(h: torch.Tensor, lp: dict, j: int) -> torch.Tensor:
    return L.swiglu_mlp(L.rms_norm(h, lp[f"ln2_{j}"]), lp[f"mlp{j}"])


def forward(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Residual stream through all layers.  x: [B, S, D] → [B, S, D]."""
    check_supported(cfg)
    for i, (unit, r) in enumerate(segments(cfg)):
        for li in range(r):
            lp = _layer(params[f"seg{i}"], li)
            for j, mixer in enumerate(unit):
                x = x + L.attention_block(L.rms_norm(x, lp[f"ln1_{j}"]), lp[f"m{j}"], cfg, mixer)
                if _has_mlp(cfg):
                    x = x + _mlp_apply(x, lp, j)
    return L.rms_norm(x, params["final_norm"])


def lm_logits(params: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final-norm hidden → vocab logits [B, S, Vp] (padded vocab -1e30)."""
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["unembed"]
    logits = (L._bf(h) @ L._bf(w)).float()
    if padded_vocab(cfg) != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _empty_cache(cfg: ArchConfig, r: int, batch: int, w: int, device) -> dict:
    shape = (r, batch, w, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=device),
        "v": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=device),
        "slot_pos": torch.full((r, w), -1, dtype=torch.int32, device=device),
    }


def init_cache(
    cfg: ArchConfig, batch: int, max_len: int, *, device: str | torch.device | None = None
) -> list[dict]:
    """Zero/empty decode caches, one entry per segment."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [
        {str(j): _empty_cache(cfg, r, batch, max_len, dev) for j in range(len(unit))}
        for unit, r in segments(cfg)
    ]


def decode_step(
    params: dict, caches: list[dict], batch: dict, pos: int, cfg: ArchConfig
):
    """One decode step at position ``pos`` (an int).  batch["tokens"]: [B, 1].

    Each layer writes its new K/V row into ``caches`` in place (see
    :func:`repro_torch.models.layers.attention_decode`).  Returns
    (logits [B, Vp], caches)."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)  # [B, 1, D]
    for i, (unit, r) in enumerate(segments(cfg)):
        for li in range(r):
            lp = _layer(params[f"seg{i}"], li)
            for j, mixer in enumerate(unit):
                cache_l = {k: c[li] for k, c in caches[i][str(j)].items()}
                y, _ = L.attention_decode(L.rms_norm(x, lp[f"ln1_{j}"]), lp[f"m{j}"],
                                          cache_l, pos, cfg, mixer)
                x = x + y
                if _has_mlp(cfg):
                    x = x + _mlp_apply(x, lp, j)
    logits = lm_logits(params, L.rms_norm(x, params["final_norm"]), cfg)
    return logits[:, -1], caches


def prefill(params: dict, batch: dict, cfg: ArchConfig, *, max_len: int | None = None):
    """Full-sequence forward returning last-position logits + caches.

    ``max_len`` sizes the KV caches for continued decode (≥ S; default S):
    slots ``[S, max_len)`` start empty (``slot_pos`` -1, K/V zero).
    Returns (logits [B, Vp], caches)."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    if max_len is not None and max_len < s:
        raise ValueError(f"max_len {max_len} < sequence {s}")
    w = max_len or s
    caches = []
    for i, (unit, r) in enumerate(segments(cfg)):
        seg_c = {str(j): _empty_cache(cfg, r, b, w, x.device) for j in range(len(unit))}
        for c in seg_c.values():
            c["slot_pos"][:, :s] = torch.arange(s, dtype=torch.int32, device=x.device)
        for li in range(r):
            lp = _layer(params[f"seg{i}"], li)
            for j, mixer in enumerate(unit):
                y, (k, v) = L.attention_block(L.rms_norm(x, lp[f"ln1_{j}"]), lp[f"m{j}"],
                                              cfg, mixer, return_kv=True)
                seg_c[str(j)]["k"][li, :, :s] = k
                seg_c[str(j)]["v"][li, :, :s] = v
                x = x + y
                if _has_mlp(cfg):
                    x = x + _mlp_apply(x, lp, j)
        caches.append(seg_c)
    logits = lm_logits(params, L.rms_norm(x[:, -1:], params["final_norm"]), cfg)
    return logits[:, 0], caches
