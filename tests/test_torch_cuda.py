"""The port's CUDA kernels on the card: each held against its plain PyTorch
version, and the distributed engine driven through them.  Imports neither
``jax`` nor ``repro``, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the kernels have no CPU mode).
Tolerance ``rtol=1e-5, atol=1e-4``: the kernels sum in another order than
the einsum / matmul of the plain versions.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _spikes(kind, shape, gen, dev):
    u = torch.rand(shape, generator=gen, device=dev)
    if kind == "weighted":
        return u * (torch.rand(shape, generator=gen, device=dev) < 0.1)
    return (u < kind).float()


@pytest.mark.parametrize("kind", [0.0, 0.01, 0.3, 1.0, "weighted"])
def test_blocks_kernel_matches_plain(dev, kind):
    from repro_torch.kernels import spike_accum as k
    from repro_torch.kernels.ref import spike_accum_blocks_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    n_dev, n_blocks, b, kt, bj = 4, 6, 300, 5, 384  # b not a multiple of 32
    sb = _spikes(kind, (n_dev, n_blocks, b), gen, dev)
    src = torch.randint(0, n_blocks, (n_dev, kt), generator=gen, device=dev,
                        dtype=torch.int32)
    blk = torch.randn((n_dev, kt, b, bj), generator=gen, device=dev)
    before = k.LAUNCHES["spike_accum_blocks"]
    out, again = k.spike_accum_blocks(sb, src, blk), k.spike_accum_blocks(sb, src, blk)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # fixed order, no atomics
    torch.testing.assert_close(out, spike_accum_blocks_ref(sb, src, blk), **TOL)
    # per-rank signature, int64 indices
    torch.testing.assert_close(k.spike_accum_blocks(sb[1], src[1].long(), blk[1]), out[1])
    assert k.LAUNCHES["spike_accum_blocks"] == before + 3


def test_blocks_kernel_edge_cases(dev):
    from repro_torch.kernels import spike_accum as k

    gen = torch.Generator(device=dev).manual_seed(1)
    sb = _spikes(0.3, (4, 16), gen, dev)
    blk = torch.randn((3, 16, 24), generator=gen, device=dev)
    src = torch.tensor([0, 2, 3], dtype=torch.int32, device=dev)
    before = k.LAUNCHES["spike_accum_blocks"]
    empty = k.spike_accum_blocks(sb, src[:0], blk[:0])  # K = 0: zeros, no launch
    assert torch.equal(empty, torch.zeros(24, device=dev))
    assert k.LAUNCHES["spike_accum_blocks"] == before
    pad = torch.cat([blk, torch.zeros((2, 16, 24), device=dev)])
    src_pad = torch.tensor([0, 2, 3, 0, 0], dtype=torch.int32, device=dev)
    assert torch.equal(k.spike_accum_blocks(sb, src_pad, pad),
                       k.spike_accum_blocks(sb, src, blk))  # padding adds exactly 0
    assert torch.equal(k.spike_accum_blocks(torch.zeros_like(sb), src, blk),
                       torch.zeros(24, device=dev))


@pytest.mark.parametrize("kind", [0.0, 0.01, 0.3, "weighted"])
@pytest.mark.parametrize("m,n", [(4096, 512), (1000, 200)])
def test_dense_kernel_matches_plain(dev, kind, m, n):
    from repro_torch.kernels import spike_accum as k
    from repro_torch.kernels.ref import spike_accum_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    s = _spikes(kind, (m,), gen, dev)
    w = torch.randn((m, n), generator=gen, device=dev)
    out = k.spike_accum(s, w)
    torch.cuda.synchronize()
    assert torch.equal(out, k.spike_accum(s, w))
    torch.testing.assert_close(out, spike_accum_ref(s, w), **TOL)


def test_kernels_agree_bit_for_bit(dev):
    """On the same synapses the block kernel (tiles sorted by source) and
    the dense kernel sum the same rows in the same order."""
    from repro_torch import convert
    from repro_torch.kernels import spike_accum as k
    from repro_torch.snn import BlockSynapses

    rng = np.random.default_rng(3)
    w = (rng.random((512, 512)) < 0.05) * rng.normal(size=(512, 512))
    w[:128, 256:384] = 0.0  # a missing tile → a zero padding tile
    syn = BlockSynapses.from_dense(w.astype(np.float32), 4)
    src, blk = convert.padded_tiles(syn, dev)
    s = torch.from_numpy((rng.random(512) < 0.2).astype(np.float32)).to(dev)
    blocks_out = k.spike_accum_blocks(s.reshape(1, 4, 128).expand(4, 4, 128).contiguous(),
                                      src, blk)
    dense_out = k.spike_accum(s, torch.from_numpy(syn.to_dense()).to(dev))
    assert torch.equal(blocks_out.reshape(-1), dense_out)


@pytest.mark.parametrize("exchange", ["sparse", "ragged"])
def test_distributed_engine_on_the_card(dev, exchange):
    """One block-kernel launch per step covers every rank; under a
    per-neuron drive (firing spread over the run) the raster equals the
    single-device engine's with the dense kernel as its hook, every step's
    current equals the dense ``s @ W`` in float64, and the CPU engine
    gives the same raster."""
    from repro_torch.kernels import LAUNCHES, spike_currents
    from repro_torch.snn import (
        BlockSynapses, DistributedSNN, LIFParams, SNNEngine,
    )

    rng = np.random.default_rng(4)
    m, n_blocks, steps = 256, 8, 60
    w = np.zeros((m, m), np.float32)
    b = m // n_blocks
    for d in range(n_blocks):
        for src in (d, (d + 1) % n_blocks):
            tile = (rng.random((b, b)) < 0.3) * rng.gamma(2.0, 2.0, (b, b))
            w[src * b:(src + 1) * b, d * b:(d + 1) * b] = tile
    np.fill_diagonal(w, 0.0)
    drive = rng.uniform(3.0, 8.0, m).astype(np.float32)
    syn = BlockSynapses.from_dense(w, n_blocks)
    eng = DistributedSNN(mesh=(4, 2), params=LIFParams(), exchange=exchange,
                         i_ext=drive, syn=syn, device=dev)
    before = dict(LAUNCHES)
    cur = []
    raster = eng.run(steps, probe=lambda t, i: cur.append(i.clone()))
    assert LAUNCHES["spike_accum_blocks"] - before["spike_accum_blocks"] == steps
    oracle = SNNEngine(w_syn=w, params=LIFParams(), i_ext=drive, device=dev).run(
        steps, current_fn=spike_currents).spikes
    assert LAUNCHES["spike_accum"] - before["spike_accum"] == steps
    active = torch.nonzero(raster.sum(1)).flatten()
    assert active.numel() >= 15 and raster[int(active[0]) + 21:].sum() > 0
    assert torch.equal(raster, oracle)
    prev = torch.cat([torch.zeros_like(raster[:1]), raster[:-1]]).double()
    torch.testing.assert_close(torch.stack(cur).double(),
                               prev @ torch.from_numpy(w).to(dev).double(), **TOL)
    cpu = DistributedSNN(mesh=(4, 2), params=LIFParams(), exchange=exchange,
                         i_ext=drive, syn=syn, device="cpu").run(steps)
    assert torch.equal(raster.cpu(), cpu)
