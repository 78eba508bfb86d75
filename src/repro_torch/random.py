"""JAX's random numbers on tensors: threefry2x32 keys and the draws made
from them, bit for bit or within an ulp of ``jax.random``.

Port of the part of ``jax.random`` the reference draws from, as JAX
computes it with ``jax_threefry_partitionable`` on (its default): the
threefry2x32 hash (``jax/_src/prng.py: _threefry2x32_lowering``), the seed
(``threefry_seed``), ``split`` (``_threefry_split_foldlike``: the hash of
each new key's index) and ``random_bits`` (``bits1 ^ bits2`` of the hash
of each element's flat index, ``_threefry_random_bits_partitionable``),
then the maps from bits to ``uniform`` (``jax/_src/random.py: _uniform``),
``normal`` (``_normal_real``: ``sqrt 2 · erf_inv(u)``), ``gumbel`` (mode
"low") and ``categorical`` (the Gumbel max, with replacement).

A key is an ``int64`` tensor ``[..., 2]`` holding two ``uint32`` words on
an explicit device; its leading dimensions are a batch of keys, one per
row (a rank-stacked SNN state holds ``[n_dev, 2]``), and every function
draws ``key.shape[:-1] + shape`` values, row ``r`` from key ``r``, as
``jax.vmap`` over the keys would.  The plain version does its 32-bit
arithmetic in ``int64`` masked to 32 bits (PyTorch on the CPU has no
``+`` or shifts for ``uint32``).  ``erf_inv`` is XLA's single-precision
polynomial (M. Giles, "Approximating the erfinv function", the branches
on ``w = -log1p(-x²) < 5``), not ``torch.erfinv``, whose results differ
from it by up to tens of ulp; bfloat16 draws round to bfloat16 where
JAX's bfloat16 arithmetic does.

The tensor's device decides, as in :mod:`repro_torch.kernels.ops`: keys on
the CPU take the plain version here; keys on a CUDA device launch the
hand-written ``threefry`` kernel (:mod:`repro_torch.kernels.threefry`,
``csrc/random.cu``) or raise.  No draw on the card goes through
``torch.Generator`` or a library generator.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

__all__ = [
    "PRNGKey", "split", "split_normal", "random_bits", "uniform", "normal", "gumbel",
    "categorical", "bounds", "exp", "log", "log1p", "erf_inv", "threefry2x32", "draw_ref",
    "split_ref",
]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's erf_inv for float32 (Giles): the coefficients of the w < 5 and
# w >= 5 branches, highest power first
ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)

#: the draws the kernel makes, by the code ``csrc/random.cu`` takes
KINDS = {"bits": 0, "uniform": 1, "normal": 2, "gumbel": 3}
DTYPES = (torch.float32, torch.bfloat16)


def PRNGKey(seed: int, *, device: str | torch.device = "cpu") -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` makes (32-bit JAX: the seed's
    low 32 bits, after a zero word), on ``device``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 hash of the counter pairs ``(x0, x1)`` under the
    key ``(k0, k1)``: ``int64`` tensors holding ``uint32`` values, which
    broadcast; returns the two hashed words.  20 rounds in 5 groups of 4
    with a key injection after each group."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0.add_(x1).bitwise_and_(MASK)
            x1 = ((x1 << r) & MASK).bitwise_or_(x1 >> (32 - r)).bitwise_xor_(x0)
        x0 = x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1 = x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0, x1


def _hash_rows(keys: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The hash of counters ``0 .. n-1`` (the flat index, high word first)
    under each key row: two ``[R, n]`` tensors."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    k0, k1 = keys[:, :1], keys[:, 1:]
    return threefry2x32(k0, k1, (idx >> 32).expand(len(keys), n).clone(),
                        (idx & MASK).expand(len(keys), n).clone())


def _f32(x: float) -> float:
    return float(np.float32(x))


# XLA's CPU logarithm (Cephes' ``logf``): log(1 + x) on the mantissa
# shifted to [sqrt(1/2), sqrt(2)), lowest coefficient last
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# XLA's log1p for |x| < sqrt(2) - 1 (Cephes' rational approximation)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _fma(a, b, c) -> torch.Tensor:
    """``a · b + c`` rounded once to float32, as a fused multiply-add (the
    product of two float32 values is exact in float64)."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    return (a * b + c).float()


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` on the CPU, the Cephes polynomial with its
    multiply-adds fused, as the reference computes ``jnp.log``."""
    x = x.float()
    bad, zero, inf = ~(x > 0.0), x == 0.0, x == math.inf
    xb = torch.clamp_min(x, float(torch.finfo(torch.float32).tiny)).view(torch.int32)
    e = ((xb >> 23) - 126).float()  # x = m · 2^e, m in [0.5, 1)
    m = ((xb & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _f32(0.707106781186547524)
    m = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.float()
    m2 = m * m
    m3 = m2 * m
    p = [_f32(c) for c in _LOG_P]
    y = _fma(_fma(m, p[0], p[1]), m, p[2])
    y1 = _fma(_fma(m, p[3], p[4]), m, p[5])
    y2 = _fma(_fma(m, p[6], p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, _f32(_LOG_Q1) * e)
    out = ((m - 0.5 * m2) + y) + _f32(_LOG_Q2) * e
    out = torch.where(bad, math.nan, out)
    return torch.where(zero, -math.inf, torch.where(inf, math.inf, out))


# XLA's CPU exponential (Cephes' ``expf``): e^x = e^r · 2^n, n = round(x / ln 2)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` on the CPU, the Cephes polynomial with its
    multiply-adds fused, as the reference computes ``jnp.exp``."""
    x = torch.clamp(x.float(), _f32(-87.8), _f32(88.8))
    n = torch.floor(_fma(x, _f32(1.44269504088896341), 0.5))
    r = _fma(n, _f32(2.12194440e-4), x - _LOG_Q2 * n)  # x - n·ln 2 in two parts
    p = [_f32(c) for c in _EXP_P]
    y = _fma(r, p[0], p[1])
    for c in p[2:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    return y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _f32(c))
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` on the CPU: a rational approximation for
    ``|x| < sqrt(2) - 1``, ``log(1 + x)`` beyond."""
    x2 = x * x
    small = (x * x2) * (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN))
    small = x + _fma(x2, -0.5, small)
    return torch.where(x.abs() < _f32(math.sqrt(2.0) - 1.0), small, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (``x`` float32; ±1 gives ±inf)."""
    w = log1p(-(x * x)).neg_()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    lt, ge = ERF_INV_LT5, ERF_INV_GE5
    p = torch.where(small, _f32(lt[0]), _f32(ge[0]))
    for a, b in zip(lt[1:], ge[1:]):
        p = _fma(p, w, torch.where(small, _f32(a), _f32(b)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def bounds(kind: str, dtype: torch.dtype, minval: float = 0.0,
           maxval: float = 1.0) -> tuple[float, float]:
    """The low end and the width of the uniform a draw of ``kind`` maps, as
    the reference computes them: each bound rounded to ``dtype`` and the
    width ``maxval - minval`` in ``dtype`` (normal: ``[nextafter(-1, 0),
    1)``; gumbel: ``[tiny, 1)``)."""
    if kind == "normal":
        minval, maxval = -1.0 + float(torch.finfo(dtype).eps) / 2, 1.0
    elif kind == "gumbel":
        minval, maxval = float(torch.finfo(dtype).tiny), 1.0
    lo = torch.tensor(minval, dtype=torch.float64).to(torch.float32).to(dtype)
    hi = torch.tensor(maxval, dtype=torch.float64).to(torch.float32).to(dtype)
    return float(lo), float(hi - lo)


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x if dtype == torch.float32 else x.to(dtype)


def _from_bits(bits: torch.Tensor, kind: str, dtype: torch.dtype, lo: float,
               diff: float) -> torch.Tensor:
    """The plain map from ``bits1 ^ bits2`` (int64) to a draw of ``kind``
    on the uniform ``[lo, lo + diff)`` (:func:`bounds`)."""
    if kind == "bits":
        return bits
    if dtype == torch.float32:  # 23 random mantissa bits under the exponent of 1.0
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        u = torch.clamp_min(_fma(f, diff, lo), lo)
    else:  # bfloat16: 8 random bits, 7 of them the mantissa; bfloat16 arithmetic
        f = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16) - 1.0
        u = torch.clamp_min(f * diff + lo, lo)
    if kind == "normal":
        sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32).to(dtype)
        return sqrt2.to(bits.device) * _round(erf_inv(u.float()), dtype)
    if kind == "gumbel":
        return _round(log(_round(log(u), dtype).neg_()), dtype).neg_()
    return u


def _check(kind: str, key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The key rows ``[R, 2]`` of ``key``, after checking key and dtype."""
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(f"a key is an int64 tensor [..., 2], got {key.dtype} {tuple(key.shape)}")
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"keys on {key.device}: cpu or cuda")
    if kind != "bits" and dtype not in DTYPES:
        raise ValueError(f"{kind}: dtype must be float32 or bfloat16, got {dtype}")
    return key.reshape(-1, 2).contiguous()


@contextlib.contextmanager
def _one_thread(device: torch.device):
    """On the CPU, one intra-op thread for the plain version: its hundreds
    of elementwise passes, each split across the threads, stall on every
    split when several processes share the cores (a reduced model's
    ``init_params`` then takes hundreds of times as long)."""
    if device.type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def draw_ref(keys: torch.Tensor, n: int, kind: int, dtype: torch.dtype, lo: float = 0.0,
             diff: float = 1.0, *, split_first: bool = False):
    """The plain version of the ``threefry`` kernel
    (:func:`repro_torch.kernels.threefry.draw`, the same arguments), in
    PyTorch on the keys' device: ``[R, n]`` draws of ``kind`` (:data:`KINDS`)
    from the uniform ``[lo, lo + diff)``, row ``r`` from key row ``r``; with
    ``split_first``, ``(new_keys, draws)`` from each key's subkey."""
    name = next(k for k, v in KINDS.items() if v == kind)
    new = None
    with _one_thread(keys.device):
        if split_first:
            pair = split_ref(keys, 2)
            new, keys = pair[:, 0].contiguous(), pair[:, 1].contiguous()
        b0, b1 = _hash_rows(keys, n)
        out = _from_bits(b0 ^ b1, name, dtype, lo, diff)
    return (new, out) if split_first else out


def split_ref(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The plain version of :func:`repro_torch.kernels.threefry.split`:
    ``[R, n, 2]``, new key ``i`` of row ``r`` the hash of ``(0, i)``."""
    with _one_thread(keys.device):
        b0, b1 = _hash_rows(keys, n)
        return torch.stack([b0, b1], dim=-1)


def _draw(kind: str, key: torch.Tensor, shape, dtype=torch.float32, minval: float = 0.0,
          maxval: float = 1.0, *, split_first: bool = False):
    """``key.shape[:-1] + shape`` draws of ``kind``, row ``r`` from key row
    ``r`` (with ``split_first``, from its subkey, and the new keys are
    returned first): the kernel on a CUDA key, the plain version on a CPU
    key."""
    keys = _check(kind, key, dtype)
    shape = tuple(int(s) for s in shape)
    out_shape, n = (*key.shape[:-1], *shape), math.prod(shape)
    lo, diff = bounds(kind, dtype, minval, maxval) if kind != "bits" else (0.0, 0.0)
    if key.device.type == "cuda":
        from repro_torch.kernels.threefry import draw
    else:
        draw = draw_ref
    got = draw(keys, n, KINDS[kind], dtype, lo, diff, split_first=split_first)
    if split_first:
        return got[0].reshape(key.shape), got[1].reshape(out_shape)
    return got.reshape(out_shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``key.shape[:-1] + (num, 2)``, new key
    ``i`` the hash of the counter pair ``(0, i)``."""
    keys = _check("bits", key, torch.int64)
    if key.device.type == "cuda":
        from repro_torch.kernels.threefry import split as split_rows
    else:
        split_rows = split_ref
    return split_rows(keys, num).reshape(*key.shape[:-1], num, 2)


def split_normal(key: torch.Tensor, shape, dtype: torch.dtype = torch.float32):
    """``key, sub = split(key); normal(sub, shape, dtype)``, the step of a
    noisy neuron model (``repro/snn/neuron.py:80-84``), for each key of a
    batch: returns ``(key, draws)``.  On the card one launch makes both, so
    a replayed step advances its key with no read on the host."""
    return _draw("normal", key, shape, dtype, split_first=True)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``jax.random.bits``: ``bit_width`` (16 or 32) random bits per element
    as ``int64`` values (``bits1 ^ bits2``, truncated)."""
    if bit_width not in (16, 32):
        raise ValueError(f"bit_width must be 16 or 32, got {bit_width}")
    bits = _draw("bits", key, shape)
    return bits if bit_width == 32 else bits & ((1 << bit_width) - 1)


def uniform(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: ``[minval, maxval)`` from the mantissa bits,
    ``max(minval, f · (maxval - minval) + minval)``."""
    return _draw("uniform", key, shape, dtype, minval, maxval)


def normal(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt 2 · erf_inv(u)``, ``u`` uniform on
    ``[nextafter(-1, 0), 1)``."""
    return _draw("normal", key, shape, dtype)


def gumbel(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): ``-log(-log(u))``, ``u`` uniform
    on ``[tiny, 1)``."""
    return _draw("gumbel", key, shape, dtype)


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: the index of the largest
    ``gumbel + logits`` along ``axis`` (the first on a tie), from one key."""
    if key.shape != (2,):
        raise ValueError(f"categorical takes one key [2], got {tuple(key.shape)}")
    g = gumbel(key, logits.shape, logits.dtype)
    return torch.argmax(g + logits, dim=axis)
