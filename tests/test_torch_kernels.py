"""The port's spike-accumulation kernels on the CPU: the plain versions
against the JAX kernels (Pallas, interpret mode, as the reference's own
tests run them) and the dense product.  The CUDA kernels are held against
these plain versions on the card by ``tests/test_torch_cuda.py``.

Tolerance ``rtol = atol = 1e-5``, as the reference states for the block
kernel (``tests/test_snn_sparse.py:357``); ``atol=1e-4`` for the dense
kernel's random-normal cases, as at ``tests/test_kernels.py:121``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spike_accum import spike_accum as jax_spike_accum
from repro.kernels.spike_accum import spike_accum_blocks as jax_spike_accum_blocks
from repro.snn import BlockSynapses as JaxBlockSynapses
from repro_torch.kernels import ops
from repro_torch.kernels.ref import spike_accum_blocks_ref, spike_accum_ref
from tests.test_snn_sparse import _clustered_w

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _jax_blocks(sb, src, blk):
    return np.asarray(jax_spike_accum_blocks(
        jnp.asarray(sb), jnp.asarray(src), jnp.asarray(blk), interpret=True))


def test_blocks_ref_matches_jax_kernel_and_dense():
    rng = np.random.default_rng(0)
    w = _clustered_w(512, 4, seed=4)
    syn = JaxBlockSynapses.from_dense(w, 4)
    src_pad, blk_pad = syn.padded()
    b = syn.block_size
    s = (rng.random(512) < 0.05).astype(np.float32)
    sb = s.reshape(4, b)
    per_rank = []
    for d in range(4):
        dense = s @ w[:, d * b : (d + 1) * b]
        out = spike_accum_blocks_ref(_t(sb), _t(src_pad[d]), _t(blk_pad[d])).numpy()
        np.testing.assert_allclose(out, dense, **TOL)
        np.testing.assert_allclose(out, _jax_blocks(sb, src_pad[d], blk_pad[d]), **TOL)
        per_rank.append(out)
    # rank-stacked: one call for every rank
    stacked = spike_accum_blocks_ref(
        _t(np.broadcast_to(sb, (4, 4, b))), _t(src_pad), _t(blk_pad)).numpy()
    np.testing.assert_allclose(stacked, np.stack(per_rank), **TOL)


def _case(name):
    rng = np.random.default_rng(7)
    b, bj = 16, 24
    blk = rng.normal(size=(3, b, bj)).astype(np.float32)
    src = np.array([0, 2, 3])
    fired = (rng.random((4, b)) < 0.3).astype(np.float32)
    if name == "silent":
        return np.zeros((4, b), np.float32), src, blk
    if name == "k0":
        return fired, np.zeros(0, np.int64), np.zeros((0, b, bj), np.float32)
    if name == "zero_padding_tiles":
        pad = np.zeros((2, b, bj), np.float32)
        return fired, np.array([0, 2, 3, 0, 0]), np.concatenate([blk, pad])
    if name == "weighted":
        return fired * rng.random((4, b)).astype(np.float32) * 3.0, src, blk
    raise ValueError(name)


@pytest.mark.parametrize("name", ["silent", "k0", "zero_padding_tiles", "weighted"])
def test_blocks_ref_cases_match_jax_kernel(name):
    sb, src, blk = _case(name)
    out = ops.spike_currents_blocks(_t(sb), _t(src), _t(blk)).numpy()
    np.testing.assert_allclose(out, _jax_blocks(sb, src, blk), **TOL)
    dense = np.einsum("kb,kbj->j", sb[src], blk) if src.size else np.zeros(blk.shape[2])
    np.testing.assert_allclose(out, dense, **TOL)
    if name in ("silent", "k0"):
        np.testing.assert_array_equal(out, np.zeros(blk.shape[2], np.float32))


@pytest.mark.parametrize(
    "m_blocks,n_blocks,rate,seed",
    [(1, 1, 0.0, 0), (2, 3, 0.05, 1), (6, 2, 0.3, 2), (3, 4, 0.01, 3), (4, 1, 1.0, 4)],
)
def test_dense_ref_matches_jax_kernel(m_blocks, n_blocks, rate, seed):
    """Any firing pattern, from all-silent (every block skipped) to dense."""
    rng = np.random.default_rng(seed)
    m, n = 128 * m_blocks, 128 * n_blocks
    s = (rng.random(m) < rate).astype(np.float32)
    w = rng.normal(size=(m, n)).astype(np.float32)
    jx = np.asarray(jax_spike_accum(jnp.asarray(s), jnp.asarray(w),
                                    block_i=128, block_j=128, interpret=True))
    out = ops.spike_currents(_t(s), _t(w)).numpy()
    np.testing.assert_allclose(out, jx, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(spike_accum_ref(_t(s), _t(w)).numpy(), s @ w,
                               rtol=1e-5, atol=1e-4)


def test_dense_ref_weighted_spikes():
    rng = np.random.default_rng(3)
    s = rng.random(256).astype(np.float32) * (rng.random(256) < 0.1)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    jx = np.asarray(jax_spike_accum(jnp.asarray(s), jnp.asarray(w),
                                    block_i=128, block_j=128, interpret=True))
    np.testing.assert_allclose(ops.spike_currents(_t(s), _t(w)).numpy(), jx, **TOL)


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import spike_accum as k

    with pytest.raises(ValueError, match="CUDA"):
        k.spike_accum(torch.zeros(4), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        k.spike_accum_blocks(torch.zeros(2, 4), torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, 4, 4))


def test_plain_versions_compute_in_float64_on_float64_inputs():
    """The float64 yardstick the card's kernels are held to at large sizes
    is the plain versions themselves, run on float64 copies."""
    rng = np.random.default_rng(6)
    s = (rng.random((3, 4, 8)) < 0.5).astype(np.float64)
    src = np.array([[0, 2], [1, 1], [3, 0]], np.int32)
    blk = rng.normal(size=(3, 2, 8, 5))
    got = spike_accum_blocks_ref(torch.from_numpy(s), torch.from_numpy(src),
                                 torch.from_numpy(blk))
    assert got.dtype == torch.float64
    want = np.einsum("dkb,dkbj->dj", s[np.arange(3)[:, None], src], blk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    dense = spike_accum_ref(torch.from_numpy(s[0, 0]), torch.from_numpy(blk[0, 0]))
    assert dense.dtype == torch.float64
    # bool / float32 inputs still compute in float32
    assert spike_accum_ref(torch.ones(8, dtype=torch.bool), torch.ones(8, 5)).dtype == torch.float32
