"""The work a cell's traffic needs: operations and bytes, from shapes and
from the traffic alone.

Every count here is of what the inputs need, whatever implements it: each
input byte read once, each output byte written once, only real prompt
tokens and generated tokens (never the engine's padding).  ``valid_pairs``
and ``bound`` are copies of ``chip_smoke.py``'s ``_valid_pairs`` and
``_bound``; ``lm_weights`` follows its ``_model_flops`` (weights that
multiply each position; a tied embedding counts once, as the unembedding).
"""
from __future__ import annotations

import numpy as np

from cellbench import peaks


def valid_pairs(sq: int, sk: int, causal: bool, window, q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps: the work this input needs.  Query
    row ``r`` holds position ``q_offset + r``; it keeps the keys ``(p -
    window, p]`` (causal) or ``(p - window, sk)`` of the ``sk`` keys."""
    qp = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(qp, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound(nbytes: float, flops: float, rate: float = peaks.HBM_BYTES,
          peak: float = peaks.F32_FLOPS) -> tuple[float, str]:
    """The least milliseconds of ``nbytes`` at ``rate`` and ``flops`` at
    ``peak``, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / rate * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- the SNN step ---------------------------------------------------------------


def k1_bytes(fired_per_block: np.ndarray, tiles_per_source: np.ndarray, block: int,
             neurons: int) -> float:
    """Bytes the synaptic accumulation needs over some steps: for each
    fired neuron, its row (``block`` float32 weights) in every stored tile
    of its block; each step's current (``neurons`` float32) written once.
    ``fired_per_block`` ``[steps, n_blocks]``: fired neurons by block."""
    rows = float((fired_per_block * tiles_per_source[None, :]).sum())
    return rows * block * 4 + fired_per_block.shape[0] * neurons * 4


def k1_flops(fired_per_block: np.ndarray, tiles_per_source: np.ndarray, block: int) -> float:
    """One addition per weight of every fired row read (see :func:`k1_bytes`)."""
    return float((fired_per_block * tiles_per_source[None, :]).sum()) * block


def sim_step(fired_per_block: np.ndarray, tiles_per_source: np.ndarray, block: int,
             neurons: int, exchange_bytes: float) -> dict:
    """The work of the SNN steps given (see :func:`k1_bytes`): the
    accumulation, the neuron update (potential and refractory clock read
    and written, drive read, spikes written: 24 bytes and 10 operations a
    neuron), and the exchanged bytes; ``least_ms``, the larger of the
    operations at the float32 peak and the bytes at the memory rate."""
    steps = fired_per_block.shape[0]
    nbytes = (k1_bytes(fired_per_block, tiles_per_source, block, neurons)
              + steps * (24.0 * neurons + exchange_bytes))
    flops = k1_flops(fired_per_block, tiles_per_source, block) + steps * 10.0 * neurons
    least, by = bound(nbytes, flops)
    return {"bytes": nbytes, "flops": flops, "least_ms": least, "by": by}


# -- the LM ---------------------------------------------------------------------


def lm_weights(cfg: dict) -> dict:
    """Weights of a dense GQA decoder by role, from the configuration
    (``hidden_size``, ``intermediate_size``, heads, ``head_dim``, layers,
    ``vocab_size``): ``layers`` multiply every position; ``unembed`` the
    positions whose logits are taken (tied: the embedding itself)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    per_layer = d * (hq + 2 * hkv) * hd + hq * hd * d + 3 * d * f
    return {"layers": per_layer * cfg["num_hidden_layers"],
            "unembed": cfg["vocab_size"] * d}


def prefill(cfg: dict, n: int) -> dict:
    """One request's prefill over its ``n`` real prompt tokens, logits at
    the last: FLOPs (2 a weight a token, 4 · head_dim a head for each
    causal pair of every layer), bytes (every weight once, bf16; the K/V
    of the ``n`` tokens written), and the attention's own part (K3's
    work: the pairs' FLOPs, q, K, V and the output once)."""
    w = lm_weights(cfg)
    hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    layers = cfg["num_hidden_layers"]
    pairs = valid_pairs(n, n, True, None)
    attn_flops = 4.0 * hd * hq * pairs * layers
    kv_bytes = 2.0 * n * hkv * hd * 2 * layers
    flops = 2.0 * (w["layers"] * n + w["unembed"]) + attn_flops
    nbytes = 2.0 * (w["layers"] + w["unembed"]) + kv_bytes
    attn_bytes = 2.0 * n * (2 * hq + 2 * hkv) * hd * layers
    return {"flops": flops, "bytes": nbytes, "attn_flops": attn_flops, "attn_bytes": attn_bytes}


def decode(cfg: dict, contexts) -> dict:
    """One decode step of the slots whose requests are live, each
    attending to ``contexts[i]`` real tokens (its prompt and what it
    generated so far, the new one included): FLOPs (2 a weight a slot, 4 ·
    head_dim a head a context token a layer), bytes (every weight once,
    the K/V of every context token once), and the attention's own part
    (K4's: those K/V bytes, q and the output)."""
    w = lm_weights(cfg)
    hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    layers = cfg["num_hidden_layers"]
    ctx = float(np.sum(contexts))
    slots = len(contexts)
    attn_flops = 4.0 * hd * hq * ctx * layers
    kv_bytes = 2.0 * ctx * hkv * hd * 2 * layers
    flops = 2.0 * (w["layers"] + w["unembed"]) * slots + attn_flops
    nbytes = 2.0 * (w["layers"] + w["unembed"]) + kv_bytes
    attn_bytes = kv_bytes + 2.0 * slots * 2 * hq * hd * layers
    return {"flops": flops, "bytes": nbytes, "attn_flops": attn_flops, "attn_bytes": attn_bytes}


def least_s(flops: float, nbytes: float) -> float:
    """Seconds of one bf16 call at the chip's peaks: the larger bound."""
    return bound(nbytes, flops, peaks.HBM_BYTES, peaks.BF16_FLOPS)[0] / 1e3
