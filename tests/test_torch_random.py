"""The port's random numbers (:mod:`repro_torch.random`) against
``jax.random`` on the CPU: the same seeds, made with numpy, through both.

Keys and bits are held bit for bit; float32 normals and gumbels within 2 ulp
(normals also at least 90 % bit-equal), bfloat16 normals within one bfloat16
ulp, uniforms bit for bit, categorical draws index for index.  The reference
runs with ``jax_threefry_partitionable`` on, its default, which the port
follows; the test asserts it rather than setting it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random

SEEDS = [int(s) for s in np.random.default_rng(26).integers(0, 2**32, 3)]
SHAPES = [(), (1,), (5,), (3, 7), (2, 3, 4)]


def _ulp(got: np.ndarray, want: np.ndarray, dtype=np.float32) -> np.ndarray:
    """|got - want| in units of ``want``'s last place in ``dtype``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "bfloat16":  # 8 significant bits
        step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    else:
        step = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return np.abs(got - want) / step


def _key(seed: int):
    return jax.random.PRNGKey(seed), random.PRNGKey(seed)


def test_threefry_is_partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 3, 2**31, 2**32 + 5, -7, *SEEDS])
def test_prng_key(seed):
    np.testing.assert_array_equal(random.PRNGKey(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 128])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, n):
    jk, tk = _key(seed)
    want = np.asarray(jax.random.split(jk, n))
    got = random.split(tk, n)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch of keys splits row by row, as jax.vmap(split) does
    rows = random.split(random.split(tk, 3), n)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(
                                      jax.random.split(jk, 3))))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("width", [32, 16])
def test_random_bits(width, shape):
    jk, tk = _key(SEEDS[0])
    want = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32 if width == 32 else jnp.uint16))
    got = random.random_bits(tk, width, shape)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1.0, 16.0), (np.log(1e-3), np.log(0.1)),
                                    (0.9, 0.999), (-3.0, 5.0)], ids=str)
def test_uniform(bounds, dtype):
    jk, tk = _key(SEEDS[1])
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(jk, (4096,), getattr(jnp, dtype), lo, hi), np.float32)
    got = random.uniform(tk, (4096,), getattr(torch, dtype), lo, hi).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_float32(seed):
    """2^16 draws within 2 ulp of the reference, at least 90 % bit-equal
    (XLA's erf_inv polynomial, not torch.erfinv)."""
    jk, tk = _key(seed)
    want = np.asarray(jax.random.normal(jk, (1 << 16,), jnp.float32))
    got = random.normal(tk, (1 << 16,)).numpy()
    assert _ulp(got, want).max() <= 2
    assert (got == want).mean() >= 0.90


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_bfloat16(seed):
    jk, tk = _key(seed)
    want = np.asarray(jax.random.normal(jk, (1 << 16,), jnp.bfloat16), np.float32)
    got = random.normal(tk, (1 << 16,), torch.bfloat16).float().numpy()
    assert _ulp(got, want, "bfloat16").max() <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel(seed, dtype):
    jk, tk = _key(seed)
    want = np.asarray(jax.random.gumbel(jk, (1 << 14,), getattr(jnp, dtype)), np.float32)
    got = random.gumbel(tk, (1 << 14,), getattr(torch, dtype)).float().numpy()
    assert _ulp(got, want, dtype if dtype == "bfloat16" else np.float32).max() <= (
        1 if dtype == "bfloat16" else 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical(seed):
    """The Gumbel max over logits of 4 rows of 1,000 and of 1 row of a
    peaked 32,000-token vocabulary: the reference's indices."""
    rng = np.random.default_rng(seed % 2**31)
    jk, tk = _key(seed)
    for logits in (rng.normal(size=(4, 1000)).astype(np.float32),
                   (rng.normal(size=(1, 32000)) * 4.0).astype(np.float32)):
        want = np.asarray(jax.random.categorical(jk, logits))
        got = random.categorical(tk, torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        jk, tk = jax.random.split(jk)[0], random.split(tk)[0]


def test_normal_map_on_every_uniform_value():
    """The map from a float32 uniform to a normal, ``sqrt 2 · erf_inv(u)``,
    on each of the 2^23 values the uniform can take: within 2 ulp of XLA's
    everywhere and at least 99.9 % bit-equal."""
    mant = np.arange(1 << 23, dtype=np.uint32)
    f = torch.from_numpy((mant | np.uint32(0x3F800000)).view(np.float32)) - 1.0
    lo, diff = random.bounds("normal", torch.float32)
    u = torch.clamp_min((f.double() * diff + lo).float(), lo)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=torch.float32)
    with random._one_thread(u.device):
        got = (sqrt2 * random.erf_inv(u)).numpy()
    want = np.asarray(jax.jit(lambda x: jnp.float32(np.sqrt(2.0)) * jax.lax.erf_inv(x))(u.numpy()))
    assert _ulp(got, want).max() <= 2
    assert (got == want).mean() >= 0.999


def test_split_normal_is_split_then_normal():
    """``split_normal`` (one launch on the card) is ``key, sub = split(key);
    normal(sub)``, row by row for a batch of keys."""
    keys = random.split(random.PRNGKey(SEEDS[2]), 8)
    new, z = random.split_normal(keys, (33,))
    pair = random.split(keys)
    assert torch.equal(new, pair[:, 0])
    assert torch.equal(z, random.normal(pair[:, 1], (33,)))
    want = jax.vmap(lambda k: jax.random.normal(jax.random.split(k)[1], (33,)))(
        jax.random.split(jax.random.PRNGKey(SEEDS[2]), 8))
    assert _ulp(z.numpy(), np.asarray(want)).max() <= 2


def test_math_is_xla_cpu():
    """``log``, ``log1p``, ``exp`` and ``erf_inv`` are XLA's CPU versions
    (the polynomials the reference's draws and weights go through): bit
    for bit on 2^16 inputs each, over the ranges the draws use."""
    rng = np.random.default_rng(5)
    cases = [
        (random.log, jnp.log, rng.uniform(1e-6, 20.0, 1 << 16)),
        (random.log1p, jnp.log1p, -rng.uniform(0.0, 1.0, 1 << 16) ** 2),
        (random.exp, jnp.exp, rng.uniform(-10.0, 10.0, 1 << 16)),
        (random.erf_inv, jax.lax.erf_inv, rng.uniform(-0.99, 0.99, 1 << 16)),
    ]
    for ours, xla, x in cases:
        x = x.astype(np.float32)
        got = ours(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.jit(xla)(x))
        assert (got == want).mean() == 1.0, ours.__name__


def test_refusals():
    with pytest.raises(ValueError, match="int64 tensor"):
        random.normal(torch.zeros(2, dtype=torch.int32), (3,))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        random.normal(random.PRNGKey(0), (3,), torch.float64)
    with pytest.raises(ValueError, match="one key"):
        random.categorical(random.split(random.PRNGKey(0)), torch.zeros(3))
    with pytest.raises(ValueError, match="bit_width"):
        random.random_bits(random.PRNGKey(0), 64, (2,))
