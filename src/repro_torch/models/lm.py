"""LM assembly of the port: the layer stack as segments of repeated units,
parameter construction, forward, loss, prefill and decode steps.

Port of ``repro/models/lm.py`` for every config of the zoo: every mixer
(``full``, ``swa``, ``local``, ``ssm``, ``rglru``), the dense SwiGLU MLP or
the mixture of experts (:func:`repro_torch.models.layers.moe_block`), and
the three front ends: text tokens, ``vlm`` (precomputed patch embeddings
``vision_embed`` projected by ``embed/vision_proj`` and put before the
text) and multi-codebook ``audio`` (``tokens [B, S, ncb]``, embeddings
summed, one head a codebook).  The parameter tree is the reference's —
``embed/tok``, ``final_norm``, ``seg{i}/ln1_{j}``, ``seg{i}/m{j}/wq`` ...,
each leaf stacked over the segment's repeats — so a converted checkpoint
maps one to one (:func:`repro_torch.convert.lm_params`).  A Python loop
over layers takes the place of ``lax.scan``.

Sharding (:mod:`repro_torch.sharding`): each :class:`PDef` carries the
reference's roles, :func:`param_specs` / :func:`cache_specs` resolve them
under a policy, :func:`distribute_params` lays the parameters out as
DTensors on the policy's ``DeviceMesh``, and ``embed_inputs``, ``forward``,
``lm_logits``, ``loss_fn``, ``init_cache``, ``prefill`` and ``decode_step``
take the policy (``pol``, default no mesh) and constrain the activations
where the reference's ``pol.shard`` does.  On the serving route the caches
are DTensors at :func:`cache_specs`' placements and every kernel runs on
the rank's local shards (:mod:`repro_torch.models.layers`).

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
from torch.distributed.tensor import distribute_tensor
from torch.utils.checkpoint import checkpoint

from repro_torch import random
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.sharding.policies import ShardingPolicy, is_dtensor

__all__ = [
    "PDef",
    "segments",
    "padded_vocab",
    "param_defs",
    "init_params",
    "abstract_params",
    "param_specs",
    "distribute_params",
    "distribute_batch",
    "embed_inputs",
    "forward",
    "lm_logits",
    "loss_fn",
    "init_cache",
    "cache_specs",
    "decode_step",
    "prefill",
]

VOCAB_PAD = 2048
ATTENTION = ("full", "swa", "local")


def padded_vocab(cfg: ArchConfig) -> int:
    return int(math.ceil(cfg.vocab_size / VOCAB_PAD) * VOCAB_PAD)


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
    roles: tuple[str | None, ...]  # one sharding role a dim (ShardingPolicy.resolve)
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
        "wq": PDef((r, d, hq * hd), (None, "fsdp", "tp")),
        "wk": PDef((r, d, hkv * hd), (None, "fsdp", "tp")),
        "wv": PDef((r, d, hkv * hd), (None, "fsdp", "tp")),
        "wo": PDef((r, hq * hd, d), (None, "tp", "fsdp"), scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        out |= {
            "bq": PDef((r, hq * hd), (None, "tp"), init="zeros"),
            "bk": PDef((r, hkv * hd), (None, "tp"), init="zeros"),
            "bv": PDef((r, hkv * hd), (None, "tp"), init="zeros"),
        }
    if cfg.qk_norm:
        out |= {
            "q_norm": PDef((r, hd), (None, None), init="zeros"),
            "k_norm": PDef((r, hd), (None, None), init="zeros"),
        }
    return out


def _ssm_defs(cfg: ArchConfig, r: int) -> dict[str, PDef]:
    d, di = cfg.d_model, cfg.d_inner
    g, n, nh, k = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    return {
        "wz": PDef((r, d, di), (None, "fsdp", "tp")),
        "wx": PDef((r, d, di), (None, "fsdp", "tp")),
        "wb": PDef((r, d, g * n), (None, "fsdp", None)),
        "wc": PDef((r, d, g * n), (None, "fsdp", None)),
        "wdt": PDef((r, d, nh), (None, "fsdp", "tp")),
        "conv_x": PDef((r, k, di), (None, None, "tp"), scale=1.0 / math.sqrt(k)),
        "conv_b": PDef((r, k, g * n), (None, None, None), scale=1.0 / math.sqrt(k)),
        "conv_c": PDef((r, k, g * n), (None, None, None), scale=1.0 / math.sqrt(k)),
        "A_log": PDef((r, nh), (None, "tp"), init="ssm_a"),
        "dt_bias": PDef((r, nh), (None, "tp"), init="ssm_dt"),
        "d_skip": PDef((r, nh), (None, "tp"), init="zeros"),
        "norm": PDef((r, di), (None, "tp"), init="zeros"),
        "wo": PDef((r, di, d), (None, "tp", "fsdp"), scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _rglru_defs(cfg: ArchConfig, r: int) -> dict[str, PDef]:
    d, k = cfg.d_model, cfg.conv_kernel
    w = cfg.lru_width or d
    return {
        "wg": PDef((r, d, w), (None, "fsdp", "tp")),
        "wx": PDef((r, d, w), (None, "fsdp", "tp")),
        "conv": PDef((r, k, w), (None, None, "tp"), scale=1.0 / math.sqrt(k)),
        "w_gate_i": PDef((r, w, w), (None, "fsdp", "tp"), scale=1.0 / math.sqrt(w)),
        "w_gate_r": PDef((r, w, w), (None, "fsdp", "tp"), scale=1.0 / math.sqrt(w)),
        "lam": PDef((r, w), (None, "tp"), init="lru_lam"),
        "wo": PDef((r, w, d), (None, "tp", "fsdp"), scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _mlp_defs(cfg: ArchConfig, r: int) -> dict[str, PDef]:
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    if cfg.n_experts:
        e = cfg.n_experts
        if cfg.n_experts < 16:
            # few big experts: TP inside each expert (the reference's mixtral mode)
            return {
                "router": PDef((r, d, e), (None, "fsdp", None)),
                "w_in": PDef((r, e, d, f), (None, None, "fsdp", "tp")),
                "w_gate": PDef((r, e, d, f), (None, None, "fsdp", "tp")),
                "w_out": PDef((r, e, f, d), (None, None, "tp", "fsdp"), scale=out_scale),
            }
        return {
            "router": PDef((r, d, e), (None, "fsdp", None)),
            "w_in": PDef((r, e, d, f), (None, "ep", "fsdp", None)),
            "w_gate": PDef((r, e, d, f), (None, "ep", "fsdp", None)),
            "w_out": PDef((r, e, f, d), (None, "ep", None, "fsdp"), scale=out_scale),
        }
    return {
        "wi": PDef((r, d, f), (None, "fsdp", "tp")),
        "wg": PDef((r, d, f), (None, "fsdp", "tp")),
        "wo": PDef((r, f, d), (None, "tp", "fsdp"), scale=out_scale),
    }


def _has_mlp(cfg: ArchConfig) -> bool:
    return cfg.d_ff > 0 or cfg.n_experts > 0


def _multi_codebook(cfg: ArchConfig) -> bool:
    return cfg.modality == "audio" and cfg.n_codebooks > 1


def param_defs(cfg: ArchConfig) -> dict[str, Any]:
    """Nested dict of PDef mirroring the param tree."""
    d, vp = cfg.d_model, padded_vocab(cfg)
    defs: dict[str, Any] = {
        "embed": {"tok": PDef((vp, d), ("tp", None), scale=1.0)},
        "final_norm": PDef((d,), (None,), init="zeros"),
    }
    if cfg.modality == "vlm":
        defs["embed"]["vision_proj"] = PDef((d, d), ("fsdp", "tp"), scale=1.0 / math.sqrt(d))
    if _multi_codebook(cfg):
        defs["embed"]["codebooks"] = PDef((cfg.n_codebooks - 1, vp, d), (None, "tp", None),
                                          scale=1.0)
        defs["unembed_codebooks"] = PDef((cfg.n_codebooks - 1, d, vp), (None, None, "tp"))
    if not cfg.tie_embeddings:
        defs["unembed"] = PDef((d, vp), (None, "tp"))
    for i, (unit, r) in enumerate(segments(cfg)):
        seg: dict[str, Any] = {}
        for j, mixer in enumerate(unit):
            seg[f"ln1_{j}"] = PDef((r, d), (None, None), init="zeros")
            if mixer in ATTENTION:
                seg[f"m{j}"] = _attn_defs(cfg, r)
            elif mixer == "ssm":
                seg[f"m{j}"] = _ssm_defs(cfg, r)
            elif mixer == "rglru":
                seg[f"m{j}"] = _rglru_defs(cfg, r)
            else:
                raise ValueError(mixer)
            if _has_mlp(cfg):
                seg[f"ln2_{j}"] = PDef((r, d), (None, None), init="zeros")
                seg[f"mlp{j}"] = _mlp_defs(cfg, r)
        defs[f"seg{i}"] = seg
    return defs


def _leaf_defs(defs: Any) -> list[PDef]:
    """The leaves of a def tree in the reference's ``jax.tree.flatten``
    order: keys sorted at every level, a ``PDef`` a leaf."""
    if isinstance(defs, PDef):
        return [defs]
    return [pd for k in sorted(defs) for pd in _leaf_defs(defs[k])]


def init_params(
    cfg: ArchConfig, seed: int = 0, *, device: str | torch.device | None = None
) -> dict:
    """Random parameters made on ``device`` (default the card) from
    ``PRNGKey(seed)``, as the reference's ``init_params(cfg, PRNGKey(seed))``
    (``repro/models/lm.py:253``): one key per leaf from ``split(key,
    n_leaves)`` in the reference's leaf order, and each leaf drawn from its
    key (:mod:`repro_torch.random`; on the card one ``threefry`` launch a
    drawn leaf).  ``exp`` and ``log`` are the reference's (``random.exp``,
    ``random.log``); ``expm1`` is PyTorch's, within an ulp of XLA's."""
    dev = resolve_device(device)
    defs = param_defs(cfg)
    keys = iter(random.split(random.PRNGKey(seed, device=dev), len(_leaf_defs(defs))))

    def leaf(node: PDef, key: torch.Tensor) -> torch.Tensor:
        def uniform(lo, hi):
            return random.uniform(key, node.shape, node.dtype, lo, hi)

        if node.init == "zeros":
            return torch.zeros(node.shape, dtype=node.dtype, device=dev)
        if node.init == "ssm_a":  # A ∈ [1, 16] → A_log
            return random.log(uniform(1.0, 16.0))
        if node.init == "ssm_dt":  # softplus(dt_bias) ∈ [1e-3, 0.1]
            dt = random.exp(uniform(math.log(1e-3), math.log(0.1)))
            return dt + random.log(-torch.expm1(-dt))  # inverse softplus
        if node.init == "lru_lam":  # a^c ∈ [0.9, 0.999] at σ(r) = 0.5ish
            target = -random.log(uniform(0.9, 0.999)) * 2.0 / L._LRU_C
            return random.log(torch.expm1(torch.clamp(target, min=1e-6)))
        # the reference's ``scale * normal``: the scale rounded to the leaf's dtype
        scale = torch.tensor(node.scale, dtype=torch.float32).to(node.dtype)
        return random.normal(key, node.shape, node.dtype).mul_(scale)

    def build(node):
        if isinstance(node, PDef):
            return leaf(node, next(keys))
        return {k: build(node[k]) for k in sorted(node)}

    return build(defs)


def _tree_of(defs: Any, fn) -> Any:
    """``fn(PDef)`` at every leaf of a def tree, keys sorted at every level."""
    if isinstance(defs, PDef):
        return fn(defs)
    return {k: _tree_of(defs[k], fn) for k in sorted(defs)}


def param_specs(cfg: ArchConfig, pol: ShardingPolicy) -> dict:
    """PartitionSpec tree matching init_params' structure."""
    return _tree_of(param_defs(cfg), lambda pd: pol.spec(*pd.roles))


def abstract_params(cfg: ArchConfig, pol: ShardingPolicy = ShardingPolicy()) -> dict:
    """The parameter tree as tensors on the ``meta`` device (shape and
    dtype, no storage): the counterpart of the reference's
    ``ShapeDtypeStruct`` tree.  Under a mesh each leaf is a meta DTensor
    with its spec's placements (its local shape is the shard's)."""

    def build(pd: PDef):
        t = torch.empty(pd.shape, dtype=pd.dtype, device="meta")
        if pol.mesh is None:
            return t
        return distribute_tensor(t, pol.mesh, pol.placements(pol.spec(*pd.roles)),
                                 src_data_rank=None)

    return _tree_of(param_defs(cfg), build)


def distribute_params(params: dict, cfg: ArchConfig, pol: ShardingPolicy) -> dict:
    """Each leaf distributed over the policy's mesh by its spec
    (``distribute_tensor``: every rank passes the same full leaf and keeps
    its shard, nothing sent; a leaf on another device type is moved to the
    mesh's); without a mesh, ``params`` itself.  A shard may share storage
    with its leaf (a replicated one, or a contiguous chunk), so an in-place
    update of the distributed tree (AdamW's) writes into ``params``: pass a
    copy to keep them."""
    if pol.mesh is None:
        return params

    def put(x, spec):
        if isinstance(x, dict):
            return {k: put(v, spec[k]) for k, v in x.items()}
        return distribute_tensor(x.detach(), pol.mesh, pol.placements(spec), src_data_rank=None)

    return put(params, param_specs(cfg, pol))


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


def distribute_batch(batch: dict, pol: ShardingPolicy) -> dict:
    """A batch as the policy lays it out: every leaf split over the batch
    axes along dim 0, replicated on the others.  Every rank passes the same
    global batch (``SyntheticLM`` of one seed); a DTensor leaf, or any leaf
    without a mesh, is kept as it is."""
    if pol.mesh is None:
        return batch

    def put(x):
        if is_dtensor(x):
            return x
        spec = pol.spec("batch", *(None,) * (x.ndim - 1))
        return distribute_tensor(x, pol.mesh, pol.placements(spec), src_data_rank=None)

    return {k: put(v) for k, v in batch.items()}


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table``: an index on one device, ``F.embedding``
    on a DTensor (a vocab sharded over ``tp`` gives a partial sum that the
    caller's ``pol.shard`` reduces)."""
    if is_dtensor(table):
        return torch.nn.functional.embedding(ids, table)
    return table[ids]


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig,
                 pol: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """Token embedding (and the front end's) → [B, S, D] residual stream.

    ``audio``: ``tokens [B, S, ncb]``, codebook 0 through ``embed/tok``,
    codebook c through ``embed/codebooks[c - 1]``, summed in the
    embeddings' dtype in codebook order.  ``vlm``: with ``vision_embed``
    ``[B, Nv, D]`` in the batch, its float32 projection by
    ``embed/vision_proj`` comes before the text, so the text starts at
    position Nv (a decode step carries text tokens only).  Under a mesh
    the batch is laid out by :func:`distribute_batch` and the result is
    sharded over the batch axes."""
    batch = distribute_batch(batch, pol)
    emb = params["embed"]
    toks = batch["tokens"]
    with pol.constants():
        if _multi_codebook(cfg):
            x = _lookup(emb["tok"], toks[..., 0])
            for cb in range(cfg.n_codebooks - 1):
                x = x + _lookup(emb["codebooks"][cb], toks[..., cb + 1])
        else:
            x = _lookup(emb["tok"], toks)
        if cfg.modality == "vlm" and "vision_embed" in batch:
            ve = batch["vision_embed"].float() @ emb["vision_proj"].float()
            ve, x = pol.shard(ve, "batch", None, None), pol.shard(x, "batch", None, None)
            x = torch.cat([ve.to(x.dtype), x], dim=1)
        return pol.shard(x.to(L.COMPUTE_DTYPE), "batch", None, None)


def _mlp_apply(h: torch.Tensor, lp: dict, j: int, cfg: ArchConfig,
               pol: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    y = L.rms_norm(h, lp[f"ln2_{j}"])
    if cfg.n_experts:
        return L.moe_block(y, lp[f"mlp{j}"], cfg, pol=pol)
    return L.swiglu_mlp(y, lp[f"mlp{j}"], pol=pol)


def _mixer_apply(y: torch.Tensor, p: dict, mixer: str, cfg: ArchConfig,
                 train: bool = False, pol: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    if mixer in ATTENTION:
        return L.attention_block(y, p, cfg, mixer, train=train, pol=pol)
    if mixer == "ssm":
        return L.mamba2_block(y, p, cfg, train=train, pol=pol)
    if mixer == "rglru":
        return L.rglru_block(y, p, cfg, train=train, pol=pol)
    raise ValueError(mixer)


def _unit_apply(x: torch.Tensor, lp: dict, unit: tuple[str, ...], cfg: ArchConfig,
                train: bool, pol: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """One layer of a segment: each mixer of the unit, then its MLP (its
    input and output sharded over the batch axes, as the reference's scanned
    body constrains them).  Under a mesh the constants a layer makes count
    as replicated, in the forward and in the backward's recompute alike."""
    with pol.constants():
        x = pol.shard(x, "batch", None, None)
        for j, mixer in enumerate(unit):
            y = L.rms_norm(x, lp[f"ln1_{j}"])
            x = x + _mixer_apply(y, lp[f"m{j}"], mixer, cfg, train, pol)
            if _has_mlp(cfg):
                x = x + _mlp_apply(x, lp, j, cfg, pol)
        return pol.shard(x, "batch", None, None)


def forward(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
            train: bool = False, pol: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """Residual stream through all layers.  x: [B, S, D] → [B, S, D].

    ``train`` takes the mixers' training route and recomputes each layer
    in the backward from its input (``checkpoint(..., use_reentrant=False)``;
    ``preserve_rng_state=False``: a layer draws nothing from torch's
    generators, the port's draws being threefry keys, and saving the CUDA
    generator's state could not be captured in a CUDA graph of the step).
    ``pol``: the layers' sharding constraints (no-ops without a mesh)."""
    for i, (unit, r) in enumerate(segments(cfg)):
        for lp in _unbound(params[f"seg{i}"], r):
            if train:
                x = checkpoint(_unit_apply, x, lp, unit, cfg, True, pol, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _unit_apply(x, lp, unit, cfg, False, pol)
    return L.rms_norm(x, params["final_norm"])


def lm_logits(params: dict, h: torch.Tensor, cfg: ArchConfig,
              pol: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """Final-norm hidden → vocab logits [B, S, Vp], or [B, S, ncb, Vp] for
    multi-codebook audio (codebook 0 through ``unembed``, codebook c
    through ``unembed_codebooks[c - 1]``); the padded vocabulary at -1e30.
    Under a mesh, sharded over the batch axes and the vocab over ``tp``."""
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["unembed"]
    with pol.constants():
        logits = (L._bf(h) @ L._bf(w)).float()
        if _multi_codebook(cfg):
            extra = (L._bf(h)[:, None] @ L._bf(params["unembed_codebooks"])).float()  # [B,k,S,Vp]
            logits = torch.cat([logits[:, None], extra], dim=1).movedim(1, 2)
        vp = padded_vocab(cfg)
        if vp != cfg.vocab_size:
            if pol.mesh is None:
                logits[..., cfg.vocab_size:] = -1e30
            else:  # the reference's select: DTensor has no rule for a slice's fill_
                valid = torch.arange(vp, device=logits.device) < cfg.vocab_size
                logits = torch.where(valid, logits, -1e30)
        if logits.ndim == 3:
            return pol.shard(logits, "batch", None, "tp")
        return pol.shard(logits, "batch", None, None, "tp")


def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            pol: ShardingPolicy = ShardingPolicy()) -> torch.Tensor:
    """Mean next-token cross-entropy over the batch (labels pre-shifted
    upstream), on the training route: the mean of ``logsumexp(logits) −
    logits[label]`` over [B, S] (audio: [B, S, ncb]), logits in float32
    with the padded vocabulary at -1e30.  ``batch``: ``tokens`` and
    ``labels`` integer tensors (int32 from the data pipeline), [B, S] or
    [B, S, ncb]; for vlm also ``vision_embed``, whose positions carry no
    label (the loss is over the text region).  Under a mesh the result is
    a replicated 0-d DTensor."""
    batch = distribute_batch(batch, pol)
    x = embed_inputs(params, batch, cfg, pol)
    h = forward(params, x, cfg, train=True, pol=pol)
    logits = lm_logits(params, h, cfg, pol)
    labels = batch["labels"]
    if cfg.modality == "vlm":
        # loss over the text region only (vision prefix has no labels)
        logits = logits[:, -labels.shape[1] :]
    if pol.mesh is not None:
        # the whole vocab row on each rank first: DTensor's rule for the
        # label gather on a tp-sharded vocab (a masked partial sum) fails
        # once its result is indexed ([..., 0] below)
        logits = pol.shard(logits, "batch", *(None,) * (logits.ndim - 1))
    lse = torch.logsumexp(logits, dim=-1)
    if pol.mesh is None:
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        # the label's logit as a masked sum (the same value: one term):
        # the gather's backward makes its zeros at the global shape on
        # every rank (DTensor replicates ``new_zeros``), 210 GB a
        # microbatch of phi4's train_4k on the production mesh
        hit = labels.long()[..., None] == torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(hit, logits, 0.0).sum(-1)
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
    cfg: ArchConfig, batch: int, max_len: int, *, pol: ShardingPolicy = ShardingPolicy(),
    device: str | torch.device | None = None,
) -> list[dict]:
    """Zero/empty decode caches, one entry per segment: for attention K/V
    ``[R, B, W, Hkv, hd]`` (W = max_len, or the window for swa / local) and
    ``slot_pos`` ``[R, W]`` (-1 = empty); for ssm the ``[R, B, H, N, P]``
    state and the conv histories; for rglru ``h`` ``[R, B, W]`` and the
    conv history.  Under a mesh each leaf is a DTensor at
    :func:`cache_specs`' placements, each rank making only its own shard;
    ``device="meta"`` makes shapes only (the dry-run's cache)."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    caches = [
        {str(j): _empty_cache(cfg, mixer, r, batch, max_len,
                              dev if pol.mesh is None else "meta")
         for j, mixer in enumerate(unit)}
        for unit, r in segments(cfg)
    ]
    if pol.mesh is None:
        return caches

    def put(node, spec):
        if isinstance(node, dict):
            return {k: put(node[k], spec[k]) for k in node}
        local, _ = pol.local_box(tuple(node.shape), spec=spec)
        fill = -1 if node.dtype == torch.int32 else 0  # slot_pos: empty
        t = torch.full(local, fill, dtype=node.dtype, device=dev)
        return pol.from_local(t, tuple(node.shape), spec=spec)

    return [put(c, sp) for c, sp in zip(caches, cache_specs(cfg, pol))]


def cache_specs(cfg: ArchConfig, pol: ShardingPolicy) -> list[dict]:
    """PartitionSpec tree matching init_cache's structure (the reference's
    layout: K/V heads over ``tp`` when they divide, else the cache's
    sequence dim; recurrent states over ``tp`` on their channels).  Under
    a mesh ``init_cache`` and ``prefill`` lay the caches out at these
    placements, and ``decode_step`` keeps them there."""
    out = []
    for unit, _ in segments(cfg):
        seg: dict[str, Any] = {}
        for j, mixer in enumerate(unit):
            if mixer in ATTENTION:
                heads_tp = pol.tp_size > 1 and cfg.n_kv_heads % pol.tp_size == 0
                kv = (pol.spec(None, "batch", None, "tp", None) if heads_tp
                      else pol.spec(None, "batch", "tp", None, None))
                seg[str(j)] = {"k": kv, "v": kv, "slot_pos": pol.spec(None, None)}
            elif mixer == "ssm":
                seg[str(j)] = {"ssm": pol.spec(None, "batch", "tp", None, None),
                               "conv": {"x": pol.spec(None, "batch", None, "tp"),
                                        "b": pol.spec(None, "batch", None, None),
                                        "c": pol.spec(None, "batch", None, None)}}
            elif mixer == "rglru":
                seg[str(j)] = {"h": pol.spec(None, "batch", "tp"),
                               "conv": pol.spec(None, "batch", None, "tp")}
        out.append(seg)
    return out


def _put(dst, src) -> None:
    """Copy a layer's state (nested dicts of tensors) into its cache slots
    (a DTensor slot takes the state at its placements)."""
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k])
    else:
        L._assign(dst, src)


def _put_kv(c: dict, k: torch.Tensor, v: torch.Tensor, s: int, pol: ShardingPolicy,
            cfg: ArchConfig) -> None:
    """A prefill's K/V ``[B, S, Hkv, hd]`` into its cache of W slots: slot
    ``i < n = min(W, S)`` holds row ``S - n + i``.  Under a mesh each rank
    writes its shard of the cache (``layers.cache_roles``) from the rows it
    holds."""
    if pol.mesh is None:
        kc, vc, sp, lo = c["k"], c["v"], c["slot_pos"], 0
    else:
        roles = L.cache_roles(cfg, pol)
        _, off = pol.local_box(tuple(c["k"].shape), *roles)
        rows = ("batch", None, roles[2], None)  # every row, the cache's heads
        k, v = pol.local(k, *rows), pol.local(v, *rows)
        kc, vc, sp, lo = c["k"].to_local(), c["v"].to_local(), c["slot_pos"].to_local(), off[1]
    n = min(c["k"].shape[1], s)
    m = max(0, min(n - lo, kc.shape[1]))
    kc[:, :m] = k[:, s - n + lo:s - n + lo + m]
    vc[:, :m] = v[:, s - n + lo:s - n + lo + m]
    sp[:n] = torch.arange(s - n, s, dtype=torch.int32, device=sp.device)


def decode_step(
    params: dict, caches: list[dict], batch: dict, pos: torch.Tensor | int, cfg: ArchConfig,
    *, pol: ShardingPolicy = ShardingPolicy(),
):
    """One decode step at position ``pos``: a 0-d int tensor on the
    tokens' device, as the reference's traced ``pos`` (an int is copied
    there; both give the same logits and caches bit for bit).
    batch["tokens"]: [B, 1].

    Each layer updates its cache in place (see
    :mod:`repro_torch.models.layers`); nothing here reads a device value
    on the host, so the step can be captured in a CUDA graph and replayed
    with the position and tokens changed in place.  Audio: tokens
    ``[B, 1, ncb]``.  vlm: text tokens, at positions after the vision
    prefix.  Returns (logits [B, Vp] (audio [B, ncb, Vp]), caches).

    Under a mesh (``pol``; params from :func:`distribute_params`, caches
    from :func:`init_cache` or :func:`prefill` with the same policy) the
    residual stream is sharded over the batch axes at each layer and the
    logits come back sharded as :func:`lm_logits` lays them out."""
    x = embed_inputs(params, batch, cfg, pol)  # [B, 1, D]
    pos = L.device_position(pos, x.device)
    with pol.constants():
        for i, (unit, r) in enumerate(segments(cfg)):
            for li in range(r):
                lp = _layer(params[f"seg{i}"], li)
                x = pol.shard(x, "batch", None, None)
                for j, mixer in enumerate(unit):
                    cache_l = _layer(caches[i][str(j)], li)
                    y = L.rms_norm(x, lp[f"ln1_{j}"])
                    if mixer in ATTENTION:
                        y, _ = L.attention_decode(y, lp[f"m{j}"], cache_l, pos, cfg, mixer, pol)
                    elif mixer == "ssm":
                        y, _ = L.mamba2_decode(y, lp[f"m{j}"], cache_l, cfg, pol)
                    elif mixer == "rglru":
                        y, _ = L.rglru_decode(y, lp[f"m{j}"], cache_l, cfg, pol)
                    x = x + y
                    if _has_mlp(cfg):
                        x = x + _mlp_apply(x, lp, j, cfg, pol)
        logits = lm_logits(params, L.rms_norm(x, params["final_norm"]), cfg, pol)
    return logits[:, -1], caches


def prefill(params: dict, batch: dict, cfg: ArchConfig, *, max_len: int | None = None,
            pol: ShardingPolicy = ShardingPolicy()):
    """Full-sequence forward returning last-position logits + caches.

    ``max_len`` sizes the full-attention KV caches for continued decode
    (≥ S; default S): slots ``[S, max_len)`` start empty (``slot_pos`` -1,
    K/V zero).  A windowed (swa / local) cache holds ``w = min(window,
    max_len)`` slots: when ``w <= S`` the last ``w`` rows, slot ``i``
    holding position ``S - w + i`` (ring-aligned only when S is a multiple
    of w — the reference's rule, kept); otherwise all S rows and headroom.
    ssm and rglru layers hand over their final recurrent state and conv
    history.  The batch is :func:`embed_inputs`' (a vlm prefix counts in
    S).  Returns (logits [B, Vp] (audio [B, ncb, Vp]), caches).

    Under a mesh (``pol``) the reference's layout (``repro/models/lm.py:
    545-608``): the residual stream sharded over the batch axes at each
    layer, the kernels on each rank's shards, the caches DTensors at
    :func:`cache_specs`' placements (:func:`init_cache`), the logits as
    :func:`lm_logits` lays them out."""
    x = embed_inputs(params, batch, cfg, pol)
    b, s, _ = x.shape
    if max_len is not None and max_len < s:
        raise ValueError(f"max_len {max_len} < sequence {s}")
    caches = init_cache(cfg, b, max_len or s, pol=pol, device=x.device)
    with pol.constants():
        for i, (unit, r) in enumerate(segments(cfg)):
            seg_c = caches[i]
            for li in range(r):
                lp = _layer(params[f"seg{i}"], li)
                x = pol.shard(x, "batch", None, None)
                for j, mixer in enumerate(unit):
                    y = L.rms_norm(x, lp[f"ln1_{j}"])
                    c = _layer(seg_c[str(j)], li)
                    if mixer in ATTENTION:
                        y, (k, v) = L.attention_block(y, lp[f"m{j}"], cfg, mixer,
                                                      return_kv=True, pol=pol)
                        _put_kv(c, k, v, s, pol, cfg)
                    elif mixer == "ssm":
                        y, st = L.mamba2_block(y, lp[f"m{j}"], cfg, return_state=True, pol=pol)
                        _put(c, st)
                    elif mixer == "rglru":
                        y, st = L.rglru_block(y, lp[f"m{j}"], cfg, return_state=True, pol=pol)
                        _put(c, st)
                    x = x + y
                    if _has_mlp(cfg):
                        x = x + _mlp_apply(x, lp, j, cfg, pol)
        x = pol.shard(x, "batch", None, None)
        logits = lm_logits(params, L.rms_norm(x[:, -1:], params["final_norm"]), cfg, pol)
    return logits[:, 0], caches
