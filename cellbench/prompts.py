"""Prompts of the serving cells, made from the seed.

Every call of a cell serves the same set of prompt lengths: the quantiles
``(i + 0.5) / n`` of a lognormal of the given median and sigma, rounded and
clipped to ``[lo, hi]``, in an order drawn from the seed and the call's
index.  So the work of a call does not hang on the seed, and its longest
prompt is always the clipped top.  The tokens are uniform over the
vocabulary, drawn from the seed and the call's index.
"""
from __future__ import annotations

from statistics import NormalDist

import numpy as np


def lengths(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """The ``n`` prompt lengths of one call, in increasing order."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def call(seed: int, index: int, n: int, median: float, sigma: float, lo: int, hi: int,
         vocab: int) -> list[list[int]]:
    """The prompts of call ``index``: the lengths of :func:`lengths` in an
    order drawn from the seed, each filled with uniform token ids."""
    rng = np.random.default_rng([seed, 3, index])
    order = rng.permutation(lengths(n, median, sigma, lo, hi))
    return [rng.integers(0, vocab, int(k)).tolist() for k in order]
