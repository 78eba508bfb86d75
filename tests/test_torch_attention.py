"""The port's attention on the CPU: the plain versions
(``repro_torch.kernels.ref``) against the JAX kernels (Pallas, interpret
mode, as the reference's own tests run them) and the JAX plain versions,
on the sweeps of ``tests/test_kernels.py:23-61``; and the dispatch
(``repro_torch.kernels.ops``) on strided views.  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``.

Tolerances are the reference's (``tests/test_kernels.py:19-20``):
``rtol = atol = 3e-3`` in float32, ``2e-2`` in bfloat16 (the kernels round
the probabilities to the value dtype, the plain versions do not).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.decode_attention import decode_attention as jax_decode_attention
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.ref import attention_ref, decode_attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 8, 1, 128, 128, 32, True, None),  # MQA
    (2, 4, 4, 256, 256, 64, False, None),  # bidirectional MHA
    (1, 4, 2, 256, 256, 64, True, 96),  # sliding window
    (1, 2, 2, 384, 384, 16, True, 128),  # non-pow2 seq
]
DECODE_CASES = [(2, 4, 2, 1024, 64, False), (3, 8, 2, 512, 32, True), (1, 2, 1, 2048, 128, True)]


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=3e-3, atol=3e-3)


def _inputs(rng, dtype: str, *shapes):
    """Normal draws rounded to ``dtype`` once, as numpy float32 (exact in
    both packages) and as the port's tensors."""
    jd, td = DTYPES[dtype]
    arrs = [np.array(jnp.asarray(rng.normal(size=s), jd), np.float32) for s in shapes]
    return arrs, [torch.from_numpy(a).to(td) for a in arrs]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window", FLASH_CASES)
def test_attention_ref_matches_jax(b, hq, hkv, sq, sk, d, causal, window, dtype):
    rng = np.random.default_rng(sq + d + hq)
    (q, k, v), (tq, tk, tv) = _inputs(rng, dtype, (b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))
    jd = DTYPES[dtype][0]
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    out = attention_ref(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (b, hq, sq, d)
    kern = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(_np(out), _np(kern), **_tol(dtype))
    np.testing.assert_allclose(
        _np(out), _np(R.attention_ref(jq, jk, jv, causal=causal, window=window)),
        **_tol(dtype))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,d,ragged", DECODE_CASES)
def test_decode_attention_ref_matches_jax(b, hq, hkv, s, d, ragged, dtype):
    rng = np.random.default_rng(s + d)
    (q, k, v), (tq, tk, tv) = _inputs(rng, dtype, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d))
    sl = rng.integers(1, s + 1, size=b).astype(np.int32) if ragged else None
    jd = DTYPES[dtype][0]
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    jsl = None if sl is None else jnp.asarray(sl)
    out = decode_attention_ref(tq, tk, tv,
                               seq_lens=None if sl is None else torch.from_numpy(sl))
    assert out.dtype == DTYPES[dtype][1] and out.shape == (b, hq, d)
    kern = jax_decode_attention(jq, jk, jv, seq_lens=jsl, block_k=256, interpret=True)
    np.testing.assert_allclose(_np(out), _np(kern), **_tol(dtype))
    np.testing.assert_allclose(
        _np(out), _np(R.decode_attention_ref(jq, jk, jv, seq_lens=jsl)), **_tol(dtype))


def test_fully_masked_rows_are_zero():
    """The reference's rule (``repro/kernels/ref.py:50-52``): a row with no
    valid key gives 0.  Non-causal, window 2, 8 queries against 4 keys:
    rows 5-7 attend to keys past the last one."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, 4, 16)).astype(np.float32))
    out = attention_ref(q, k, k, causal=False, window=2)  # rows i >= 5 see no key
    assert torch.equal(out[:, :, 5:], torch.zeros_like(out[:, :, 5:]))
    assert out[:, :, :5].abs().sum() > 0


def test_ops_take_strided_views():
    """The model hands ``ops`` transposed views of ``[B, S, H, D]`` tensors
    and of its ``[B, W, Hkv, D]`` cache: the same result as contiguous
    inputs, on the plain path (a CPU tensor launches no kernel)."""
    rng = np.random.default_rng(6)
    b, s, hq, hkv, d = 2, 40, 6, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
               for h in (hq, hkv, hkv))
    before = dict(LAUNCHES)
    views = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    dense = ops.attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal=True)
    torch.testing.assert_close(views, dense, rtol=0, atol=0)
    sl = torch.tensor([17, 40], dtype=torch.int32)
    views = ops.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2), seq_lens=sl)
    dense = ops.decode_attention(q[:, 0].contiguous(), k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous(), seq_lens=sl)
    torch.testing.assert_close(views, dense, rtol=0, atol=0)
    # rows past seq_lens do not matter
    k2 = k.clone()
    k2[0, 17:] = 1e4
    again = ops.decode_attention(q[:, 0], k2.transpose(1, 2), v.transpose(1, 2), seq_lens=sl)
    torch.testing.assert_close(again, views, rtol=0, atol=0)
    assert LAUNCHES == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [1, 37, 96])
def test_decode_validity_paths_agree(n, dtype):
    """One validity path into K4: a full mixer hands it ``slot_pos`` with
    ``slot_lo = -1``.  On a prefix-valid cache (slots ``[0, n)`` hold
    positions, the rest -1) that equals ``seq_lens = n``, whatever the
    empty rows hold."""
    rng = np.random.default_rng(n)
    b, hq, hkv, s, d = 2, 6, 2, 96, 32
    _, (q, k, v) = _inputs(rng, dtype, (b, hq, d), (b, hkv, s, d), (b, hkv, s, d))
    k[:, :, n:] = 1e4  # empty slots: never attended
    slot_pos = torch.where(torch.arange(s) < n, torch.arange(s), -1).to(torch.int32)
    by_len = decode_attention_ref(q, k, v, seq_lens=torch.full((b,), n, dtype=torch.int32))
    by_slot = decode_attention_ref(q, k, v, slot_pos=slot_pos, slot_lo=-1)
    torch.testing.assert_close(by_slot, by_len, rtol=0, atol=0)
    assert torch.equal(ops.decode_attention(q, k, v, slot_pos=slot_pos), by_len)



# -- the arguments the sharded serving route needs -----------------------------


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None), (False, 7)])
@pytest.mark.parametrize("offset", [0, 37, 64])
def test_attention_ref_q_offset_rows_equal_the_whole_run(causal, window, offset):
    """``attention_ref(q_offset=o)`` on q rows ``[o, S)`` against the whole
    K/V is the whole run's rows ``[o, S)`` (a rank's rows of a sequence
    split over ``tp``): float32, 1e-6."""
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((2, h, 128, 32), generator=gen) for h in (4, 2, 2))
    whole = attention_ref(q, k, v, causal=causal, window=window)
    rows = attention_ref(q[:, :, offset:], k, v, causal=causal, window=window, q_offset=offset)
    torch.testing.assert_close(rows, whole[:, :, offset:], rtol=1e-6, atol=1e-6)
    via_ops = ops.attention(q[:, :, offset:], k, v, causal=causal, window=window,
                            q_offset=offset)
    assert torch.equal(via_ops, rows)


@pytest.mark.parametrize("cuts", [(0, 40, 100), (0, 30, 70, 100)])
@pytest.mark.parametrize("windowed", [False, True])
def test_combine_partials_equals_the_whole_decode(cuts, windowed):
    """K4's plain version with ``return_lse`` on 2 and 3 slices of the
    cache's slots, combined by ``combine_partials``, is the whole decode
    attention (float32, 1e-6); the middle slice holds no valid slot (its
    ``slot_pos`` is -1, or below the window's bound), so it returns
    ``o = 0`` and ``lse = -inf`` and weighs nothing."""
    from repro_torch.kernels.ref import combine_partials

    gen = torch.Generator().manual_seed(12)
    b, hq, hkv, w, d = 3, 8, 2, cuts[-1], 32
    q = torch.randn((b, hq, d), generator=gen)
    k, v = (torch.randn((b, hkv, w, d), generator=gen) for _ in "kv")
    slot_pos = torch.arange(w, dtype=torch.int32)
    lo = -1
    if windowed:
        slot_lo = cuts[2] - 1  # the window keeps positions from cuts[2] on
        slot_pos[:cuts[1]] = torch.arange(cuts[1], dtype=torch.int32) + cuts[-1]  # ring: newest
        lo = slot_lo
    slot_pos[cuts[1]:cuts[2]] = -1 if not windowed else lo - 5
    whole = decode_attention_ref(q, k, v, slot_pos=slot_pos, slot_lo=lo)
    os, lses = [], []
    for a, e in zip(cuts, cuts[1:]):
        o, lse = decode_attention_ref(q, k[:, :, a:e], v[:, :, a:e], slot_pos=slot_pos[a:e],
                                      slot_lo=lo, return_lse=True)
        os.append(o)
        lses.append(lse)
    assert torch.equal(os[1], torch.zeros_like(os[1]))
    assert torch.isneginf(lses[1]).all()
    got = combine_partials(torch.stack(os), torch.stack(lses))
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
    _, lse_whole = decode_attention_ref(q, k, v, slot_pos=slot_pos, slot_lo=lo, return_lse=True)
    torch.testing.assert_close(torch.logsumexp(torch.stack(lses), 0), lse_whole, rtol=1e-6,
                               atol=1e-6)
