"""Weights of the LM cells, made on the device from the seed.

Each weight is one large draw: float32 normals from a generator of its own
(the seed and the weight's name), scaled, and rounded once to the type it
is served in (bf16 for matrices, float32 for the norms).  Every layer's
copy of a weight is one stacked tensor ``[layers, ...]``.  The standard
deviations come from the configuration's ``init`` (``std``, ``embed_std``,
``norm_std``): the matrices at ``std`` (the out-projections at ``std /
sqrt(2 · layers)``, as the port's ``lm.init_params``), and two departures
from that init chosen so that random weights make a model whose greedy
tokens depend on its layers:

* the tied embedding at ``embed_std`` (0.02), not 1: at 1 the current
  token's own embedding dominates its logits (about 1,900 against at most
  250 for the others at a width of 3,072), so greedy decoding repeats the
  prompt's last token whatever the layers compute;
* each norm's weight ``1 + norm_std · N(0, 1)``, not 1, so that a norm
  that dropped its weight would show.
"""
from __future__ import annotations

import math

import numpy as np
import torch

def specs(cfg: dict) -> dict[str, tuple[tuple[int, ...], float, torch.dtype]]:
    """Name -> (shape, standard deviation, served type) of every weight of
    a dense GQA decoder with SwiGLU MLPs and a tied embedding.  The norms'
    entries are the offsets from 1."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    n = cfg["num_hidden_layers"]
    init = cfg["init"]
    std, norm = init["std"], init["norm_std"]
    out_std = std / math.sqrt(2 * n)
    bf, f32 = torch.bfloat16, torch.float32
    return {
        "embed": ((v, d), init["embed_std"], bf),
        "final_norm": ((d,), norm, f32),
        "attn_norm": ((n, d), norm, f32),
        "wq": ((n, d, hq * hd), std, bf),
        "wk": ((n, d, hkv * hd), std, bf),
        "wv": ((n, d, hkv * hd), std, bf),
        "wo": ((n, hq * hd, d), out_std, bf),
        "mlp_norm": ((n, d), norm, f32),
        "w_gate": ((n, d, f), std, bf),
        "w_up": ((n, d, f), std, bf),
        "w_down": ((n, f, d), out_std, bf),
    }


def _generator(device, seed: int, name: str) -> torch.Generator:
    words = [int(seed), *name.encode()]
    s = int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def make(cfg: dict, seed: int, device, names=None) -> dict[str, torch.Tensor]:
    """Every weight (or those ``names``) of :func:`specs`, on ``device``."""
    out = {}
    for name, (shape, std, dtype) in specs(cfg).items():
        if names is not None and name not in names:
            continue
        x = torch.randn(shape, generator=_generator(device, seed, name), device=device,
                        dtype=torch.float32)
        out[name] = x.mul_(std).to(dtype)
        del x
    return out


def fingerprint(weights: dict[str, torch.Tensor]) -> dict[str, float]:
    """Float64 sums of each weight's values and of their magnitudes: equal
    draws give equal fingerprints."""
    return {k: (float(w.sum(dtype=torch.float64)), float(w.abs().sum(dtype=torch.float64)))
            for k, w in weights.items()}
