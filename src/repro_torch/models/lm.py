"""LM assembly of the port: the layer stack as segments of repeated units,
parameter construction, forward, loss, prefill and decode steps.

Port of ``repro/models/lm.py`` for text models without experts: every
mixer (``full``, ``swa``, ``local``, ``ssm``, ``rglru``), so dense
attention models, mamba2-1.3b and recurrentgemma-9b.  The parameter tree is
the reference's — ``embed/tok``, ``final_norm``, ``seg{i}/ln1_{j}``,
``seg{i}/m{j}/wq`` ..., each leaf stacked over the segment's repeats — so a
converted checkpoint maps one to one (:func:`repro_torch.convert.lm_params`).
A Python loop over layers takes the place of ``lax.scan``; there is no
sharding on one card.  Experts and other modalities raise
``NotImplementedError`` naming the ROADMAP item that brings them.

Training (:func:`loss_fn`, :func:`forward` with ``train=True``) runs every
layer under ``torch.utils.checkpoint.checkpoint`` — the counterpart of the
reference's ``jax.checkpoint`` around its scanned body: only each layer's
input is kept for the backward — and takes the mixers' training route
(:mod:`repro_torch.models.layers`), which launches no hand-written kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

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
    "abstract_params",
    "embed_inputs",
    "forward",
    "lm_logits",
    "loss_fn",
    "init_cache",
    "decode_step",
    "prefill",
]

VOCAB_PAD = 2048
ATTENTION = ("full", "swa", "local")


def padded_vocab(cfg: ArchConfig) -> int:
    return int(math.ceil(cfg.vocab_size / VOCAB_PAD) * VOCAB_PAD)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve yet:
    other modalities and MoE."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.modality} models wait for their slice (ROADMAP.md §1, M8)")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE (moe_block) waits for its slice (ROADMAP.md §1, M8)")


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
    init: str = "normal"  # normal | zeros | ssm_a | ssm_dt | lru_lam
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


def _ssm_defs(cfg: ArchConfig, r: int) -> dict[str, PDef]:
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh, k = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    return {
        "wz": PDef((r, d, di)),
        "wx": PDef((r, d, di)),
        "wb": PDef((r, d, g * n)),
        "wc": PDef((r, d, g * n)),
        "wdt": PDef((r, d, nh)),
        "conv_x": PDef((r, k, di), scale=1.0 / math.sqrt(k)),
        "conv_b": PDef((r, k, g * n), scale=1.0 / math.sqrt(k)),
        "conv_c": PDef((r, k, g * n), scale=1.0 / math.sqrt(k)),
        "A_log": PDef((r, nh), init="ssm_a"),
        "dt_bias": PDef((r, nh), init="ssm_dt"),
        "d_skip": PDef((r, nh), init="zeros"),
        "norm": PDef((r, di), init="zeros"),
        "wo": PDef((r, di, d), scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _rglru_defs(cfg: ArchConfig, r: int) -> dict[str, PDef]:
    d, k = cfg.d_model, cfg.conv_kernel
    w = cfg.lru_width or d
    return {
        "wg": PDef((r, d, w)),
        "wx": PDef((r, d, w)),
        "conv": PDef((r, k, w), scale=1.0 / math.sqrt(k)),
        "w_gate_i": PDef((r, w, w), scale=1.0 / math.sqrt(w)),
        "w_gate_r": PDef((r, w, w), scale=1.0 / math.sqrt(w)),
        "lam": PDef((r, w), init="lru_lam"),
        "wo": PDef((r, w, d), scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


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
        for j, mixer in enumerate(unit):
            seg[f"ln1_{j}"] = PDef((r, d), init="zeros")
            if mixer in ATTENTION:
                seg[f"m{j}"] = _attn_defs(cfg, r)
            elif mixer == "ssm":
                seg[f"m{j}"] = _ssm_defs(cfg, r)
            elif mixer == "rglru":
                seg[f"m{j}"] = _rglru_defs(cfg, r)
            else:
                raise ValueError(mixer)
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

    def uniform(node, lo, hi):
        return torch.empty(node.shape, dtype=node.dtype, device=dev).uniform_(lo, hi, generator=gen)

    def build(node):
        if isinstance(node, PDef):
            if node.init == "zeros":
                return torch.zeros(node.shape, dtype=node.dtype, device=dev)
            if node.init == "ssm_a":  # A ∈ [1, 16] → A_log
                return torch.log(uniform(node, 1.0, 16.0))
            if node.init == "ssm_dt":  # softplus(dt_bias) ∈ [1e-3, 0.1]
                dt = torch.exp(uniform(node, math.log(1e-3), math.log(0.1)))
                return dt + torch.log(-torch.expm1(-dt))  # inverse softplus
            if node.init == "lru_lam":  # a^c ∈ [0.9, 0.999] at σ(r) = 0.5ish
                target = -torch.log(uniform(node, 0.9, 0.999)) * 2.0 / L._LRU_C
                return torch.log(torch.expm1(torch.clamp(target, min=1e-6)))
            out = torch.empty(node.shape, dtype=node.dtype, device=dev)
            return out.normal_(0.0, node.scale, generator=gen)
        return {k: build(node[k]) for k in sorted(node)}

    return build(param_defs(cfg))


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as tensors on the ``meta`` device (shape and
    dtype, no storage): the counterpart of the reference's
    ``ShapeDtypeStruct`` tree without a mesh (one card has no sharding)."""

    def build(node):
        if isinstance(node, PDef):
            return torch.empty(node.shape, dtype=node.dtype, device="meta")
        return {k: build(node[k]) for k in sorted(node)}

    return build(param_defs(cfg))


def _layer(tree: dict, li: int) -> dict:
    """Views of layer ``li`` of a segment's stacked tree."""
    return {k: _layer(v, li) if isinstance(v, dict) else v[li] for k, v in tree.items()}


def _unbound(tree: dict, r: int) -> list[dict]:
    """Every layer's views of a segment's stacked tree, from one
    ``unbind`` per leaf: its backward stacks the r layers' gradients once,
    where a view per layer (``v[li]``) would add r full-size ``[r, ...]``
    gradients."""
    out: list[dict] = [{} for _ in range(r)]
    for k, v in tree.items():
        parts = _unbound(v, r) if isinstance(v, dict) else torch.unbind(v, 0)
        for li in range(r):
            out[li][k] = parts[li]
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Token embedding → [B, S, D] residual stream."""
    x = params["embed"]["tok"][batch["tokens"]]
    return x.to(L.COMPUTE_DTYPE)


def _mlp_apply(h: torch.Tensor, lp: dict, j: int) -> torch.Tensor:
    return L.swiglu_mlp(L.rms_norm(h, lp[f"ln2_{j}"]), lp[f"mlp{j}"])


def _mixer_apply(y: torch.Tensor, p: dict, mixer: str, cfg: ArchConfig,
                 train: bool = False) -> torch.Tensor:
    if mixer in ATTENTION:
        return L.attention_block(y, p, cfg, mixer, train=train)
    if mixer == "ssm":
        return L.mamba2_block(y, p, cfg, train=train)
    if mixer == "rglru":
        return L.rglru_block(y, p, cfg, train=train)
    raise ValueError(mixer)


def _unit_apply(x: torch.Tensor, lp: dict, unit: tuple[str, ...], cfg: ArchConfig,
                train: bool) -> torch.Tensor:
    """One layer of a segment: each mixer of the unit, then its MLP."""
    for j, mixer in enumerate(unit):
        x = x + _mixer_apply(L.rms_norm(x, lp[f"ln1_{j}"]), lp[f"m{j}"], mixer, cfg, train)
        if _has_mlp(cfg):
            x = x + _mlp_apply(x, lp, j)
    return x


def forward(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
            train: bool = False) -> torch.Tensor:
    """Residual stream through all layers.  x: [B, S, D] → [B, S, D].

    ``train`` takes the mixers' training route and recomputes each layer
    in the backward from its input (``checkpoint(..., use_reentrant=False)``)."""
    check_supported(cfg)
    for i, (unit, r) in enumerate(segments(cfg)):
        for lp in _unbound(params[f"seg{i}"], r):
            if train:
                x = checkpoint(_unit_apply, x, lp, unit, cfg, True, use_reentrant=False)
            else:
                x = _unit_apply(x, lp, unit, cfg, False)
    return L.rms_norm(x, params["final_norm"])


def lm_logits(params: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Final-norm hidden → vocab logits [B, S, Vp] (padded vocab -1e30)."""
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["unembed"]
    logits = (L._bf(h) @ L._bf(w)).float()
    if padded_vocab(cfg) != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def loss_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch (labels pre-shifted
    upstream), on the training route: the mean of ``logsumexp(logits) −
    logits[label]`` over [B, S], logits in float32 with the padded
    vocabulary at -1e30.  ``batch``: ``tokens`` and ``labels`` [B, S]
    integer tensors (int32 from the data pipeline)."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    h = forward(params, x, cfg, train=True)
    logits = lm_logits(params, h, cfg)
    labels = batch["labels"]
    if cfg.modality == "vlm":
        # loss over the text region only (vision prefix has no labels)
        logits = logits[:, -labels.shape[1] :]
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def _cache_len(cfg: ArchConfig, mixer: str, max_len: int) -> int:
    if mixer == "swa":
        return min(cfg.window or max_len, max_len)
    if mixer == "local":
        return min(cfg.local_window or max_len, max_len)
    return max_len


def _empty_cache(cfg: ArchConfig, mixer: str, r: int, batch: int, max_len: int,
                 device) -> dict:
    """Zero / empty decode cache of one unit position, stacked over r."""
    dt = L.COMPUTE_DTYPE

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    k1 = cfg.conv_kernel - 1
    if mixer in ATTENTION:
        w = _cache_len(cfg, mixer, max_len)
        return {"k": zeros(r, batch, w, cfg.n_kv_heads, cfg.head_dim),
                "v": zeros(r, batch, w, cfg.n_kv_heads, cfg.head_dim),
                "slot_pos": torch.full((r, w), -1, dtype=torch.int32, device=device)}
    if mixer == "ssm":
        gn = cfg.ssm_groups * cfg.ssm_state
        return {"ssm": zeros(r, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim,
                             dtype=torch.float32),
                "conv": {"x": zeros(r, batch, k1, cfg.d_inner), "b": zeros(r, batch, k1, gn),
                         "c": zeros(r, batch, k1, gn)}}
    if mixer == "rglru":
        w = cfg.lru_width or cfg.d_model
        return {"h": zeros(r, batch, w, dtype=torch.float32), "conv": zeros(r, batch, k1, w)}
    raise ValueError(mixer)


def init_cache(
    cfg: ArchConfig, batch: int, max_len: int, *, device: str | torch.device | None = None
) -> list[dict]:
    """Zero/empty decode caches, one entry per segment: for attention K/V
    ``[R, B, W, Hkv, hd]`` (W = max_len, or the window for swa / local) and
    ``slot_pos`` ``[R, W]`` (-1 = empty); for ssm the ``[R, B, H, N, P]``
    state and the conv histories; for rglru ``h`` ``[R, B, W]`` and the
    conv history."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [
        {str(j): _empty_cache(cfg, mixer, r, batch, max_len, dev) for j, mixer in enumerate(unit)}
        for unit, r in segments(cfg)
    ]


def _put(dst, src) -> None:
    """Copy a layer's state (nested dicts of tensors) into its cache slots."""
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k])
    else:
        dst.copy_(src)


def decode_step(
    params: dict, caches: list[dict], batch: dict, pos: torch.Tensor | int, cfg: ArchConfig
):
    """One decode step at position ``pos``: a 0-d int tensor on the
    tokens' device, as the reference's traced ``pos`` (an int is copied
    there; both give the same logits and caches bit for bit).
    batch["tokens"]: [B, 1].

    Each layer updates its cache in place (see
    :mod:`repro_torch.models.layers`); nothing here reads a device value
    on the host, so the step can be captured in a CUDA graph and replayed
    with the position and tokens changed in place.  Returns (logits
    [B, Vp], caches)."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)  # [B, 1, D]
    pos = L.device_position(pos, x.device)
    for i, (unit, r) in enumerate(segments(cfg)):
        for li in range(r):
            lp = _layer(params[f"seg{i}"], li)
            for j, mixer in enumerate(unit):
                cache_l = _layer(caches[i][str(j)], li)
                y = L.rms_norm(x, lp[f"ln1_{j}"])
                if mixer in ATTENTION:
                    y, _ = L.attention_decode(y, lp[f"m{j}"], cache_l, pos, cfg, mixer)
                elif mixer == "ssm":
                    y, _ = L.mamba2_decode(y, lp[f"m{j}"], cache_l, cfg)
                elif mixer == "rglru":
                    y, _ = L.rglru_decode(y, lp[f"m{j}"], cache_l, cfg)
                x = x + y
                if _has_mlp(cfg):
                    x = x + _mlp_apply(x, lp, j)
    logits = lm_logits(params, L.rms_norm(x, params["final_norm"]), cfg)
    return logits[:, -1], caches


def prefill(params: dict, batch: dict, cfg: ArchConfig, *, max_len: int | None = None):
    """Full-sequence forward returning last-position logits + caches.

    ``max_len`` sizes the full-attention KV caches for continued decode
    (≥ S; default S): slots ``[S, max_len)`` start empty (``slot_pos`` -1,
    K/V zero).  A windowed (swa / local) cache holds ``w = min(window,
    max_len)`` slots: when ``w <= S`` the last ``w`` rows, slot ``i``
    holding position ``S - w + i`` (ring-aligned only when S is a multiple
    of w — the reference's rule, kept); otherwise all S rows and headroom.
    ssm and rglru layers hand over their final recurrent state and conv
    history.  Returns (logits [B, Vp], caches)."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    if max_len is not None and max_len < s:
        raise ValueError(f"max_len {max_len} < sequence {s}")
    caches = []
    for i, (unit, r) in enumerate(segments(cfg)):
        seg_c = {str(j): _empty_cache(cfg, mixer, r, b, max_len or s, x.device)
                 for j, mixer in enumerate(unit)}
        for li in range(r):
            lp = _layer(params[f"seg{i}"], li)
            for j, mixer in enumerate(unit):
                y = L.rms_norm(x, lp[f"ln1_{j}"])
                c = _layer(seg_c[str(j)], li)
                if mixer in ATTENTION:
                    y, (k, v) = L.attention_block(y, lp[f"m{j}"], cfg, mixer, return_kv=True)
                    w = c["k"].shape[1]
                    n = min(w, s)  # rows kept: the last w, or all S with headroom
                    c["k"][:, :n] = k[:, s - n:]
                    c["v"][:, :n] = v[:, s - n:]
                    c["slot_pos"][:n] = torch.arange(s - n, s, dtype=torch.int32,
                                                     device=x.device)
                elif mixer == "ssm":
                    y, st = L.mamba2_block(y, lp[f"m{j}"], cfg, return_state=True)
                    _put(c, st)
                elif mixer == "rglru":
                    y, st = L.rglru_block(y, lp[f"m{j}"], cfg, return_state=True)
                    _put(c, st)
                x = x + y
                if _has_mlp(cfg):
                    x = x + _mlp_apply(x, lp, j)
        caches.append(seg_c)
    logits = lm_logits(params, L.rms_norm(x[:, -1:], params["final_norm"]), cfg)
    return logits[:, 0], caches
