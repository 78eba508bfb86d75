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
    if kind == "signed":
        # rows 128-255 fire only negative spikes, rows 384-511 positive ones
        # (the Pallas kernels skip a block with no positive spike; the port
        # sums every nonzero spike, as repro/kernels/ref.py does)
        s = torch.zeros(shape, device=dev)
        flat, fired = s.view(-1), (u.view(-1) < 0.5).float()
        flat[128:256] = -fired[128:256]
        flat[384:512] = fired[384:512]
        return s
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


@pytest.mark.parametrize("bj,offset", [(30, 0), (384, 1), (4096, 1)])
def test_blocks_kernel_copies_unaligned_rows(dev, bj, offset):
    """Row segments that are not 16-byte aligned (a width not a multiple of
    4 floats, or tiles starting one float into their storage) are copied 4
    bytes a column; the sums equal the plain version's and, tile by tile in
    source order, the dense kernel's bit for bit."""
    from repro_torch.kernels import spike_accum as k
    from repro_torch.kernels.ref import spike_accum_blocks_ref

    gen = torch.Generator(device=dev).manual_seed(14)
    n_dev, n_blocks, b = 2, 3, 200
    sb = _spikes(0.2, (n_dev, n_blocks, b), gen, dev)
    src = torch.arange(n_blocks, dtype=torch.int32, device=dev).repeat(n_dev, 1)
    store = torch.randn(n_dev * n_blocks * b * bj + offset, generator=gen, device=dev)
    blk = store[offset:].view(n_dev, n_blocks, b, bj)
    assert (blk.data_ptr() % 16 != 0) == bool(offset)
    out = k.spike_accum_blocks(sb, src, blk)
    torch.testing.assert_close(out, spike_accum_blocks_ref(sb, src, blk), **TOL)
    for d in range(n_dev):
        dense = k.spike_accum(sb[d].reshape(-1), blk[d].reshape(n_blocks * b, bj))
        assert torch.equal(out[d], dense)


@pytest.mark.parametrize("kind", [0.0, 0.01, 0.3, "weighted", "signed"])
@pytest.mark.parametrize("m", [1000, 4096, 5000, 32768])
@pytest.mark.parametrize("n", [30, 200, 4096, 32768])
def test_dense_kernel_matches_plain(dev, kind, m, n):
    """W as row slabs of 4,096 (M = 1,000 and 5,000 end in a short one),
    one to 256 column tiles of 128 (N = 30 and 200 end in a short one),
    4-byte copies where N is not a multiple of 4; held to the plain version
    on float64 copies, reruns bit-identical, one launch counted per call."""
    from repro_torch.kernels import spike_accum as k
    from repro_torch.kernels.ref import spike_accum_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    s = _spikes(kind, (m,), gen, dev)
    w = torch.randn((m, n), generator=gen, device=dev)
    before = k.LAUNCHES["spike_accum"]
    out = k.spike_accum(s, w)
    torch.cuda.synchronize()
    assert torch.equal(out, k.spike_accum(s, w))
    assert k.LAUNCHES["spike_accum"] == before + 2
    torch.testing.assert_close(out.double(), spike_accum_ref(s.double(), w.double()), **TOL)


@pytest.mark.parametrize("m", [512, 5120])
def test_kernels_agree_bit_for_bit(dev, m):
    """On the same synapses the block kernel (tiles sorted by source) and
    the dense kernel sum the same rows in the same order; at M = 5,120 the
    dense kernel's second row slab is short (1,024 rows) and its slabs
    (4,096 rows) do not line up with the block kernel's tiles (1,280)."""
    from repro_torch import convert
    from repro_torch.kernels import spike_accum as k
    from repro_torch.snn import BlockSynapses

    rng = np.random.default_rng(3)
    b = m // 4
    w = (rng.random((m, m)) < 0.05) * rng.normal(size=(m, m))
    w[:b, 2 * b:3 * b] = 0.0  # a missing tile → a zero padding tile
    syn = BlockSynapses.from_dense(w.astype(np.float32), 4)
    src, blk = convert.padded_tiles(syn, dev)
    s = torch.from_numpy((rng.random(m) < 0.2).astype(np.float32)).to(dev)
    blocks_out = k.spike_accum_blocks(s.reshape(1, 4, b).expand(4, 4, b).contiguous(),
                                      src, blk)
    dense_out = k.spike_accum(s, torch.from_numpy(syn.to_dense()).to(dev))
    assert torch.equal(blocks_out.reshape(-1), dense_out)


@pytest.mark.parametrize("case", ["one_active_block", "weighted", "all_fire", "signed"])
def test_kernels_agree_bit_for_bit_at_full_tiles(dev, case):
    """chip_smoke.py phase 2's spike patterns on its 4,096-row tiles (two
    ranks of 8 tiles, each rank's tiles in source order), and a block of
    negative spikes: the block kernel equals the dense kernel on the rank's
    [32,768, 4,096] synapses bit for bit, and reruns of both are
    bit-identical."""
    from repro_torch.kernels import spike_accum as k

    gen = torch.Generator(device=dev).manual_seed(12)
    n_dev, n_blocks, b = 2, 8, 4096
    blocks = torch.randn((n_dev, n_blocks, b, b), generator=gen, device=dev)
    blocks[:, :, :, ::7] = 0.0  # zero weights are skipped by both
    src = torch.arange(n_blocks, dtype=torch.int32, device=dev).repeat(n_dev, 1)
    shape = (n_dev, n_blocks, b)
    if case == "one_active_block":
        s = torch.zeros(shape, device=dev)
        s[0, 3] = 1.0
    elif case == "weighted":
        u = torch.rand(shape, generator=gen, device=dev)
        s = u * (torch.rand(shape, generator=gen, device=dev) < 0.05)
    elif case == "signed":
        s = _spikes("signed", shape, gen, dev)
    else:
        s = torch.ones(shape, device=dev)
    out = k.spike_accum_blocks(s, src, blocks)
    assert torch.equal(out, k.spike_accum_blocks(s, src, blocks))
    for d in range(n_dev):
        w = blocks[d].reshape(n_blocks * b, b)
        dense = k.spike_accum(s[d].reshape(-1), w)
        assert torch.equal(out[d], dense)
        assert torch.equal(dense, k.spike_accum(s[d].reshape(-1), w))


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


# -- attention (K3 flash_attention, K4 decode_attention) --------------------

ATTN_TOL = {torch.float32: dict(rtol=3e-3, atol=3e-3), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _assert_bf16_step(out, want):
    """Head-256 bf16 outputs average many keys and are small, so beside
    the reference's 2e-2 they are held to one bf16 step of the reference
    value plus two steps of the rms of its row (K3 rounds P to bf16 before
    P V, as the TPU kernel does, and that error scales with the row)."""
    out, want = out.float(), want.float()
    row = want.double().pow(2).mean(-1, keepdim=True).sqrt().float()
    row = row.clamp_min(torch.finfo(torch.float32).tiny)
    excess = float(((out - want).abs() - 2**-7 * want.abs()).div(row).max()) - 2**-6
    assert excess <= 0, excess


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,d,causal,window",
    [
        (2, 4, 2, 256, 256, 64, True, None),
        (1, 8, 1, 128, 128, 32, True, None),  # MQA
        (2, 4, 4, 256, 256, 64, False, None),  # bidirectional MHA
        (1, 4, 2, 256, 256, 64, True, 96),  # sliding window
        (1, 2, 2, 384, 384, 16, True, 128),  # non-pow2 seq
        (2, 6, 2, 200, 200, 128, True, None),  # ragged tiles, group 3, head 128
        (1, 2, 1, 8, 4, 32, False, 2),  # rows 5-7 see no key -> 0
        (2, 16, 1, 200, 200, 256, True, 96),  # recurrentgemma's MQA, head 256, window
        (1, 4, 2, 130, 130, 256, False, None),  # head 256, bidirectional, ragged tiles
        # the wgmma kernel's edges: head dims 64 / 128 / 256 with groups 1, 3
        # and 16; sq not a multiple of its 128-row q tile, and below it;
        # 4,096 keys under a 2,048 window (interior and boundary tiles, the
        # ring wrapping many times); rows that see no key
        (1, 3, 3, 200, 200, 64, True, None),
        (2, 6, 2, 130, 130, 64, True, 48),
        (1, 16, 1, 100, 100, 64, False, None),
        (1, 2, 2, 300, 300, 128, False, None),
        (1, 16, 1, 130, 130, 128, True, 64),
        (1, 6, 2, 1000, 1000, 128, True, None),
        (1, 2, 2, 64, 64, 256, True, None),
        (1, 6, 2, 257, 257, 256, True, None),
        (1, 16, 1, 4096, 4096, 256, True, 2048),
        (1, 4, 1, 4096, 4096, 64, True, 2048),
        (1, 2, 1, 8, 4, 64, False, 2),  # rows 5-7 see no key -> 0
        (1, 2, 1, 200, 100, 128, False, 40),  # rows past 139 see no key
        # more items than SMs, so each persistent block runs several; q tiles
        # from row 384 on need no KV tile at all (window 10 starts past the
        # 100 keys) and must leave the K/V ring's bookkeeping as it was
        (1, 64, 8, 600, 100, 64, False, 10),
        # the groups of qwen2.5-14b (5), mixtral-8x22b (6, windowed) and
        # yi-34b (7), and deepseek-7b's MHA, at head dim 128
        (2, 10, 2, 300, 300, 128, True, None),
        (1, 12, 2, 333, 333, 128, True, 128),
        (1, 14, 2, 257, 257, 128, True, None),
        (2, 8, 8, 200, 200, 128, True, None),
    ],
)
def test_flash_attention_matches_plain(dev, dtype, b, hq, hkv, sq, sk, d, causal, window):
    """The reference's sweep (``tests/test_kernels.py:23-44``) with its
    tolerances, on transposed ``[B, S, H, D]`` views as the model passes
    them; reruns are bit-identical."""
    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    q, kk, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
                for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    before = k.LAUNCHES["flash_attention"]
    out = k.flash_attention(q, kk, v, causal=causal, window=window)
    again = k.flash_attention(q, kk, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(out, again) and out.stride() == q.stride() and out.dtype == dtype
    want = attention_ref(q, kk, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16 and d == 256:
        _assert_bf16_step(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,hq,hkv,s,d,ragged",
    [(2, 4, 2, 1024, 64, False), (3, 8, 2, 512, 32, True), (1, 2, 1, 2048, 128, True),
     (4, 24, 8, 1088, 128, True),  # phi4-mini's decode shape
     (2, 16, 1, 640, 256, True),  # recurrentgemma's MQA: 16 q heads on one kv head
     (1, 12, 1, 300, 64, False),  # a group of 12 at head 64
     # bf16 serves a kv head's group from one block (up to 32 q heads):
     # groups 3, 12, 16 and 32 at head dims 128 and 256, one past 32, a
     # single valid row ("one")
     (2, 6, 2, 700, 128, True), (1, 12, 1, 513, 128, True), (1, 32, 2, 777, 128, True),
     (2, 32, 1, 300, 128, True), (1, 9, 3, 300, 256, False), (3, 36, 3, 400, 256, True),
     (1, 32, 1, 900, 256, True), (1, 48, 1, 300, 128, True), (2, 16, 1, 640, 256, "one"),
     # groups 5, 6 and 7 (qwen2.5-14b, mixtral-8x22b, yi-34b) and MHA
     # (deepseek-7b) at head dim 128
     (2, 10, 2, 700, 128, True), (1, 12, 2, 513, 128, True), (2, 14, 2, 600, 128, True),
     (2, 8, 8, 640, 128, True)],
)
def test_decode_attention_matches_plain(dev, dtype, b, hq, hkv, s, d, ragged):
    """The reference's sweep (``tests/test_kernels.py:47-61``) on
    ``[B, W, Hkv, D]`` cache views; rows past ``seq_lens`` are not read."""
    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
    kc, vc = (torch.randn((b, s, hkv, d), generator=gen, device=dev).to(dtype) for _ in "kv")
    sl = (torch.ones((b,), device=dev, dtype=torch.int32) if ragged == "one" else
          torch.randint(1, s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
          if ragged else None)
    out = k.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2), seq_lens=sl)
    torch.cuda.synchronize()
    assert torch.equal(out, k.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                               seq_lens=sl))
    want = decode_attention_ref(q, kc.transpose(1, 2), vc.transpose(1, 2), seq_lens=sl)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16 and d == 256:
        _assert_bf16_step(out, want)
    if ragged:
        n = int(sl.min())
        kc[:, n:] = float("nan")  # never read
        again = k.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                                   seq_lens=torch.full_like(sl, n))
        assert torch.isfinite(again).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window,offset", [
    (1, 24, 8, 1024, 128, None, 512),  # phi4-mini's prefill, the second half over tp
    (2, 16, 1, 512, 256, 128, 200),  # recurrentgemma's local layer, an offset inside a tile
    (1, 4, 2, 300, 64, None, 77),  # ragged rows past the last 128-row tile
    (1, 4, 2, 256, 32, 64, 100),  # head 32 (the mma.sync kernel)
])
def test_flash_attention_q_offset_matches_plain(dev, dtype, b, hq, hkv, s, d, window, offset):
    """K3 on q rows ``[offset, S)`` with ``q_offset`` (a rank's rows of a
    sequence split over ``tp``) against the whole K/V: the plain version's
    rows and K3's whole run's rows, within the sweep's tolerances."""
    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(15)
    q, kk, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
                for h in (hq, hkv, hkv))
    rows = q[:, :, offset:]
    before = k.LAUNCHES["flash_attention"]
    out = k.flash_attention(rows, kk, v, causal=True, window=window, q_offset=offset)
    assert k.LAUNCHES["flash_attention"] == before + 1
    want = attention_ref(rows, kk, v, causal=True, window=window, q_offset=offset)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL[dtype])
    whole = k.flash_attention(q, kk, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), whole[:, :, offset:].float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,w,d,ring", [
    (4, 24, 8, 1040, 128, False),  # phi4-mini's decode cache, split in two halves
    (4, 16, 1, 2048, 256, True),  # recurrentgemma's ring, its window bound on the device
])
def test_decode_attention_lse_combines_over_slot_splits(dev, dtype, b, hq, hkv, w, d, ring):
    """K4 with ``return_lse`` on each half of the cache's slots (the
    sharded decode's slots over ``tp``), combined by ``combine_partials``,
    against K4's whole run and the plain version; the log-sum-exps against
    the plain version's; a slice with no valid slot gives ``o = 0`` and
    ``lse = -inf``."""
    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import combine_partials, decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(16)
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
    kc, vc = (torch.randn((b, w, hkv, d), generator=gen, device=dev).to(dtype) for _ in "kv")
    kv = kc.transpose(1, 2), vc.transpose(1, 2)
    pos = w + w // 3
    if ring:  # slot i holds the newest position congruent to i
        sp = torch.tensor([p if p <= pos else p - w for p in range(w, 2 * w)],
                          dtype=torch.int32, device=dev)
        lo = torch.tensor(pos - w // 2, dtype=torch.int32, device=dev)
    else:
        sp = torch.arange(w, dtype=torch.int32, device=dev)
        sp[1000:] = -1  # the headroom past the prompt
        lo = -1
    half = w // 2
    parts = [k.decode_attention(q, kv[0][:, :, a:a + half], kv[1][:, :, a:a + half],
                                slot_pos=sp[a:a + half].contiguous(), slot_lo=lo,
                                return_lse=True) for a in (0, half)]
    got = combine_partials(torch.stack([o for o, _ in parts]), torch.stack([l for _, l in parts]))
    whole = k.decode_attention(q, *kv, slot_pos=sp, slot_lo=lo)
    torch.testing.assert_close(got.float(), whole.float(), **ATTN_TOL[dtype])
    want, lse = decode_attention_ref(q, *kv, slot_pos=sp, slot_lo=lo, return_lse=True)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    for (o, l), a in zip(parts, (0, half)):
        _, wl = decode_attention_ref(q, kv[0][:, :, a:a + half], kv[1][:, :, a:a + half],
                                     slot_pos=sp[a:a + half], slot_lo=lo, return_lse=True)
        torch.testing.assert_close(l, wl, **ATTN_TOL[torch.float32])
    none = torch.full((half,), -1, dtype=torch.int32, device=dev)
    o, l = k.decode_attention(q, kv[0][:, :, :half], kv[1][:, :, :half], slot_pos=none,
                              return_lse=True)
    assert torch.equal(o, torch.zeros_like(o)) and torch.isneginf(l).all()


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention"])
def test_attention_past_2_31_elements_matches_plain_on_rows(dev, kernel):
    """Inputs of more than 2^31 elements (a [B, S, H, D] q of 2.4 G for K3,
    a [B, S, Hkv, D] K and V of 2.2 G each for K4), whose element offsets
    past 2^31 a 32-bit index would wrap: K3's first and last 512 q rows of
    each batch row (the last lie past 2^31 in batch row 1), K4's batch rows
    0, 32 and 63, against the plain version on those rows alone (it cannot
    hold the whole input)."""
    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import attention_ref, decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(17)
    tol = ATTN_TOL[torch.bfloat16]
    if kernel == "flash_attention":
        b, hq, hkv, sq, sk, d = 2, 8, 2, 1 << 20 | 1 << 17, 1024, 128
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev, dtype=torch.bfloat16)
        kk, v = (torch.randn((b, sk, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
                 .transpose(1, 2) for _ in "kv")
        q = q.transpose(1, 2)
        assert q.numel() > 1 << 31
        out = k.flash_attention(q, kk, v, causal=False)
        for i in range(b):
            for lo in (0, sq - 512):
                want = attention_ref(q[i:i + 1, :, lo:lo + 512], kk[i:i + 1], v[i:i + 1],
                                     causal=False)
                got = out[i:i + 1, :, lo:lo + 512]
                torch.testing.assert_close(got.float(), want.float(), **tol)
                _assert_bf16_step(got, want)
    else:
        b, hq, hkv, s, d = 64, 24, 8, 33_000, 128
        q = torch.randn((b, hq, d), generator=gen, device=dev, dtype=torch.bfloat16)
        kk, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
                 .transpose(1, 2) for _ in "kv")
        assert kk.numel() > 1 << 31
        sl = torch.randint(s - 100, s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
        out = k.decode_attention(q, kk, v, seq_lens=sl)
        for i in (0, 32, 63):
            want = decode_attention_ref(q[i:i + 1], kk[i:i + 1], v[i:i + 1], seq_lens=sl[i:i + 1])
            torch.testing.assert_close(out[i:i + 1].float(), want.float(), **tol)
            _assert_bf16_step(out[i:i + 1], want)


def test_kernels_launch_nothing_on_an_empty_batch(dev):
    """A rank's empty shard of the batch: K3, K4, K5 and K6 return outputs
    of the right shapes at once and count no launch."""
    from repro_torch.kernels import LAUNCHES, ops

    before = dict(LAUNCHES)
    bf = torch.bfloat16
    q = torch.zeros((0, 4, 64, 128), dtype=bf, device=dev)
    kv = torch.zeros((0, 2, 64, 128), dtype=bf, device=dev)
    assert ops.attention(q, kv, kv, q_offset=64).shape == q.shape
    o, lse = ops.decode_attention(q[:, :, 0], kv, kv, return_lse=True)
    assert o.shape == (0, 4, 128) and lse.shape == (0, 4)
    x = torch.zeros((0, 128, 4, 64), device=dev)
    a, bc = torch.zeros((0, 128, 4), device=dev), torch.zeros((0, 128, 1, 16), device=dev)
    y, st = ops.ssd(x, a, bc, bc, chunk=128, return_state=True)
    assert y.shape == x.shape and st.shape == (0, 4, 16, 64)
    assert ops.rglru(a, a).shape == a.shape
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(16, 1, 256), (6, 2, 128), (32, 1, 128)])
def test_decode_attention_slot_validity(dev, dtype, hq, hkv, d):
    """A ring buffer whose valid slots are not a prefix (window 64, a
    prefill of 96 tokens, decode at position 96): slot 0 holds position 32,
    outside the window, and slot 32 holds 96.  The kernel applies the
    reference's rule per slot and never reads a rejected row."""
    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(9)
    b, w, pos = 2, 64, 96
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
    kc, vc = (torch.randn((b, w, hkv, d), generator=gen, device=dev).to(dtype) for _ in "kv")
    slot_pos = torch.arange(96 - w, 96, dtype=torch.int32, device=dev)
    slot_pos[pos % w] = pos
    slot_pos[40:44] = -1  # empty slots count for nothing either
    lo = pos - w
    args = (q, kc.transpose(1, 2), vc.transpose(1, 2))
    out = k.decode_attention(*args, slot_pos=slot_pos, slot_lo=lo)
    torch.cuda.synchronize()
    assert torch.equal(out, k.decode_attention(*args, slot_pos=slot_pos, slot_lo=lo))
    want = decode_attention_ref(*args, slot_pos=slot_pos, slot_lo=lo)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        _assert_bf16_step(out, want)
    prefix = decode_attention_ref(*args, seq_lens=torch.full((b,), w, device=dev))
    assert (want.float() - prefix.float()).abs().max() > 1e-2  # the rule matters here
    invalid = (slot_pos < 0) | (slot_pos <= lo)
    kc[:, invalid] = float("nan")
    vc[:, invalid] = float("nan")
    again = k.decode_attention(q, kc.transpose(1, 2), vc.transpose(1, 2),
                               slot_pos=slot_pos, slot_lo=lo)
    assert torch.equal(again, out)


# -- sequence scans (K5 ssd_scan, K6 rglru_scan) -----------------------------

SCAN_TOL = dict(rtol=3e-3, atol=3e-3)  # tests/test_kernels.py:74-76, 101-103


@pytest.mark.parametrize(
    "bs,s,h,g,p,n,chunk",
    [(2, 256, 4, 2, 32, 16, 64), (1, 128, 2, 1, 16, 8, 128), (1, 512, 8, 2, 64, 32, 128),
     (1, 127, 4, 1, 64, 128, 128),  # chunk min(128, 127) = 127: not a power of two
     (2, 288, 4, 2, 32, 16, 96),  # chunk 96
     (1, 256, 2, 1, 64, 128, 128),  # mamba2-1.3b's head: P 64, N 128, L 128
     (1, 64, 2, 1, 128, 16, 128)],  # head dim 128
)
def test_ssd_scan_matches_plain(dev, bs, s, h, g, p, n, chunk):
    """The reference's sweep (``tests/test_kernels.py:64-76``) and chunks
    that are not powers of two, against the plain chunked SSD and the
    direct recurrence in float64; reruns are bit-identical."""
    from repro_torch.kernels import scan as k
    from repro_torch.kernels.ref import ssd_chunked, ssd_ref

    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((bs, s, h, p), generator=gen, device=dev)
    a = 0.85 + 0.149 * torch.rand((bs, s, h), generator=gen, device=dev)
    b, c = (torch.randn((bs, s, g, n), generator=gen, device=dev) for _ in "bc")
    before = k.LAUNCHES["ssd_scan"]
    out, again = k.ssd_scan(x, a, b, c, chunk=chunk), k.ssd_scan(x, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert k.LAUNCHES["ssd_scan"] == before + 2
    assert torch.equal(out, again) and out.dtype == torch.float32
    x64, a64, b64, c64 = (t.double() for t in (x, a, b, c))
    torch.testing.assert_close(out.double(), ssd_chunked(x64, a64, b64, c64, chunk=chunk),
                               **SCAN_TOL)
    torch.testing.assert_close(out.double(), ssd_ref(x64, a64, b64, c64), **SCAN_TOL)


# chip_smoke.py's SSD_CASES: the reference's sweep, chunks of 127 and 96,
# mamba2-1.3b's prefill wave
SSD_CASES = [(2, 256, 4, 2, 32, 16, 64), (1, 128, 2, 1, 16, 8, 128), (1, 512, 8, 2, 64, 32, 128),
             (1, 127, 64, 1, 64, 128, 128), (2, 384, 8, 2, 32, 16, 96),
             (4, 1024, 64, 1, 64, 128, 128)]


@pytest.mark.parametrize("bs,s,h,g,p,n,chunk", SSD_CASES)
def test_ssd_scan_final_state_matches_plain(dev, bs, s, h, g, p, n, chunk):
    """The kernel's final state against the plain chunked SSD's carried
    state in float64; asking for it leaves y bit for bit as it was, and
    reruns agree bit for bit."""
    from repro_torch.kernels import scan as k
    from repro_torch.kernels.ref import ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((bs, s, h, p), generator=gen, device=dev)
    a = 0.85 + 0.149 * torch.rand((bs, s, h), generator=gen, device=dev)
    b, c = (torch.randn((bs, s, g, n), generator=gen, device=dev) for _ in "bc")
    y, state = k.ssd_scan(x, a, b, c, chunk=chunk, return_state=True)
    y2, state2 = k.ssd_scan(x, a, b, c, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    assert state.shape == (bs, h, n, p) and state.dtype == torch.float32
    assert torch.equal(state, state2) and torch.equal(y, y2)
    assert torch.equal(y, k.ssd_scan(x, a, b, c, chunk=chunk))
    y64, want = ssd_chunked(*(t.double() for t in (x, a, b, c)), chunk=chunk, return_state=True)
    torch.testing.assert_close(state.double(), want, **SCAN_TOL)
    torch.testing.assert_close(y.double(), y64, **SCAN_TOL)


@pytest.mark.parametrize("which", ["x", "b", "c"])
def test_ssd_scan_rejects_unaligned_inputs(dev, which):
    """x, B and C are copied 16 bytes at a time: an input starting one float
    into its storage raises before launch, and the card stays usable (the
    same values, aligned, match the plain version)."""
    from repro_torch.kernels import scan as k
    from repro_torch.kernels.ref import ssd_ref

    gen = torch.Generator(device=dev).manual_seed(15)
    shapes = {"x": (1, 64, 2, 16), "b": (1, 64, 1, 32), "c": (1, 64, 1, 32)}
    ins = {key: 0.3 * torch.randn(shape, generator=gen, device=dev)
           for key, shape in shapes.items()}
    a = 0.8 + 0.19 * torch.rand((1, 64, 2), generator=gen, device=dev)
    store = torch.empty(ins[which].numel() + 1, device=dev)
    shifted = store[1:].view(shapes[which])
    shifted.copy_(ins[which])
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        k.ssd_scan(**{**ins, which: shifted}, a=a, chunk=32)
    y = k.ssd_scan(**ins, a=a, chunk=32)
    want = ssd_ref(*(t.double() for t in (ins["x"], a, ins["b"], ins["c"])))
    torch.testing.assert_close(y.double(), want, **SCAN_TOL)


def test_ssd_scan_rejects_state_sizes(dev):
    """The tensor-core design takes N a multiple of 8 up to 128 and raises
    before launch otherwise."""
    from repro_torch.kernels import scan as k

    x = torch.zeros((1, 64, 2, 16), device=dev)
    a = torch.full((1, 64, 2), 0.9, device=dev)
    for n in (12, 136):
        b = torch.zeros((1, 64, 1, n), device=dev)
        with pytest.raises(ValueError, match="state size"):
            k.ssd_scan(x, a, b, b)


def test_launch_geometry_matches_the_sources(dev):
    """The wrappers' shared-memory counts equal the CUDA sources' own."""
    from repro_torch.kernels import scan, spike_accum

    lib = scan._lib()
    for p in scan.SSD_HEAD_DIMS:
        smem = scan.ssd_plan(1, 128, 2, 1, p, 128, 128)["smem"]
        assert [lib.ssd_scan_smem_bytes(w, p) for w in range(3)] == \
            [smem["cb"], smem["state"], smem["scan"]]
    lib = spike_accum._lib()
    for n_dev, k_tiles, bj in ((8, 8, 4096), (1, 3, 24), (4, 64, 384)):
        plan = spike_accum.blocks_plan(n_dev, k_tiles, bj)
        assert lib.spike_accum_ring_smem_bytes(k_tiles) == plan["smem"]
    for m, n in ((32768, 4096), (32768, 32768), (5000, 200), (100_000, 30)):
        plan = spike_accum.dense_plan(m, n)
        assert lib.spike_accum_ring_smem_bytes(plan["k_tiles"]) == plan["smem"]


def test_rglru_plan_matches_the_source(dev):
    """The shared memory ``rglru_plan`` predicts is the CUDA source's own,
    at every channel tile the plan picks."""
    from repro_torch.kernels import scan

    lib = scan._lib()
    plans = [scan.rglru_plan(bs, s, d) for bs, s, d in
             ((1, 1024, 4096), (2, 1000, 4100), (4, 1024, 4096), (1, 1, 33))]
    assert {p["width"] for p in plans} == set(scan.RG_WIDTHS)
    for plan in plans:
        assert lib.rglru_scan_smem_bytes() == plan["smem"]


# the reference's sweep (tests/test_kernels.py:94-103), ragged shapes (S
# not a multiple of a ring stage, D not of a channel tile or of 4), the
# batch-1 prefill recurrentgemma-9b's continuous scheduler runs
RGLRU_SHAPES = [(2, 256, 128), (1, 128, 256), (3, 512, 64), (2, 37, 100), (1, 1024, 4096),
                (1, 1, 33), (2, 1000, 4100)]


@pytest.mark.parametrize("bs,s,d", RGLRU_SHAPES)
def test_rglru_scan_matches_plain(dev, bs, s, d):
    """The reference's sweep (``tests/test_kernels.py:94-103``), ragged
    shapes (S not a multiple of a ring stage, D not of the channel tile;
    D = 33 and 100 are no multiple of 4 and copy 4 bytes at a time) and the
    batch-1 prefill, against the plain recurrence in float64."""
    from repro_torch.kernels import scan as k
    from repro_torch.kernels.ref import rglru_ref

    gen = torch.Generator(device=dev).manual_seed(11)
    a = 0.8 + 0.199 * torch.rand((bs, s, d), generator=gen, device=dev)
    b = torch.randn((bs, s, d), generator=gen, device=dev)
    before = k.LAUNCHES["rglru_scan"]
    out, again = k.rglru_scan(a, b), k.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert k.LAUNCHES["rglru_scan"] == before + 2
    assert torch.equal(out, again)
    torch.testing.assert_close(out.double(), rglru_ref(a.double(), b.double()), **SCAN_TOL)


@pytest.mark.parametrize("bs,s,d", [*RGLRU_SHAPES, (4, 1024, 4096), (4, 512, 4096),
                                     (1, 4096, 4096)])
@pytest.mark.parametrize("case", ["ones", "zero_decay"])
def test_rglru_scan_exact_traces(dev, bs, s, d, case):
    """Traces known exactly: with a = b = 1 every h_t is t + 1 (integers
    below 2^24, so float32 holds them), with a = 0 it is b.  A carry
    dropped or doubled across ring stages, channel tiles or tails fails
    these exactly, not within a tolerance."""
    from repro_torch.kernels import scan as k

    if case == "ones":
        a = b = torch.ones((bs, s, d), device=dev)
        want = torch.arange(1, s + 1, device=dev, dtype=torch.float32)[None, :, None]
        want = want.expand(bs, s, d)
    else:
        a = torch.zeros((bs, s, d), device=dev)
        b = want = torch.randn((bs, s, d), generator=torch.Generator(device=dev).manual_seed(12),
                               device=dev)
    out = k.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("d", [4096, 100])
def test_rglru_scan_unaligned_inputs(dev, d):
    """An input starting one float into its storage (contiguous, off 16
    bytes) is copied 4 bytes at a time and gives the aligned trace bit for
    bit."""
    from repro_torch.kernels import scan as k

    gen = torch.Generator(device=dev).manual_seed(14)
    a = 0.8 + 0.199 * torch.rand((1, 300, d), generator=gen, device=dev)
    b = torch.randn((1, 300, d), generator=gen, device=dev)
    store = torch.empty(a.numel() + 1, device=dev)
    shifted = store[1:].view(a.shape)
    shifted.copy_(a)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    assert torch.equal(k.rglru_scan(shifted, b), k.rglru_scan(a, b))


def test_scan_wrappers_reject_bad_inputs(dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels import scan as k

    x = torch.zeros((1, 96, 2, 16), device=dev)
    a = torch.full((1, 96, 2), 0.9, device=dev)
    b = torch.zeros((1, 96, 1, 8), device=dev)
    with pytest.raises(ValueError, match="bad shapes"):
        k.ssd_scan(x, a[:, :, :1], b, b)
    with pytest.raises(ValueError, match="S must divide chunk"):
        k.ssd_scan(x, a, b, b, chunk=64)
    with pytest.raises(ValueError, match="one CUDA device"):
        k.ssd_scan(x, a.cpu(), b, b)
    with pytest.raises(ValueError, match="float32"):
        k.ssd_scan(x.double(), a, b, b)
    with pytest.raises(ValueError, match="contiguous"):
        k.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), a, b, b)
    with pytest.raises(ValueError, match="S=96 is not a multiple"):
        ops.ssd(x.cpu(), a.cpu(), b.cpu(), b.cpu(), chunk=64)  # the plain path agrees
    with pytest.raises(ValueError, match="!= b"):
        k.rglru_scan(a, a[:, :5])
    with pytest.raises(ValueError, match="one CUDA device"):
        k.rglru_scan(a, a.cpu())


def test_attention_wrappers_reject_bad_inputs(dev):
    from repro_torch.kernels import attention as k

    q = torch.zeros((1, 2, 8, 48), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        k.flash_attention(q, q, q)
    q = torch.zeros((1, 3, 8, 32), device=dev)
    with pytest.raises(ValueError, match="bad shapes"):
        k.flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="one CUDA device"):
        k.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="bfloat16"):
        k.decode_attention(q[:, :, 0], q, q.bfloat16())


def test_kernels_refuse_inputs_that_require_grad(dev):
    """A kernel has no backward: on the card each dispatch raises on an
    input that requires grad (naming the training route) instead of
    returning a tensor cut from the graph; under ``torch.no_grad()`` it
    launches."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import ops

    q = torch.randn((1, 2, 64, 64), device=dev, dtype=torch.bfloat16)
    kv = torch.randn((1, 1, 64, 64), device=dev, dtype=torch.bfloat16)
    x, b = torch.randn((1, 64, 2, 16), device=dev), torch.randn((1, 64, 1, 8), device=dev)
    a = 0.9 + 0.05 * torch.rand((1, 64, 2), device=dev)
    ra, rb = 0.9 + 0.05 * torch.rand((1, 64, 32), device=dev), torch.randn((1, 64, 32), device=dev)
    calls = {
        "flash_attention": lambda t: ops.attention(t, kv, kv),
        "decode_attention": lambda t: ops.decode_attention(t[:, :, 0], kv, kv),
        "ssd_scan": lambda t: ops.ssd(x, a, b, t, chunk=64),
        "rglru_scan": lambda t: ops.rglru(ra, t),
    }
    grad_inputs = {"flash_attention": q, "decode_attention": q, "ssd_scan": b, "rglru_scan": rb}
    for name, call in calls.items():
        t = grad_inputs[name].clone().requires_grad_()
        before = LAUNCHES[name]
        with pytest.raises(RuntimeError, match="training route"):
            call(t)
        assert LAUNCHES[name] == before
        with torch.no_grad():
            call(t)
        torch.cuda.synchronize()
        assert LAUNCHES[name] == before + 1


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b", "recurrentgemma-9b",
                                  "qwen3-moe-30b-a3b", "mixtral-8x22b", "llava-next-mistral-7b",
                                  "musicgen-large", "qwen2.5-14b", "deepseek-7b", "yi-34b"])
def test_train_step_on_the_card(dev, arch):
    """Two train steps of the reduced config on the card launch no kernel
    (the training route) and give the CPU's losses under float32 compute;
    every gradient reaches its parameter.  For every config of
    ``chip_smoke.py``'s check (3), also its loss and gradients on the card
    against the CPU's (``chip_smoke._train_card_vs_cpu``: groups 5-7,
    non-zero zero-initialised leaves, 2 × 128 tokens past the reduced
    windows; float32 and bf16 bounds, and the planted fault outside the
    float32 one)."""
    import chip_smoke
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.train import TrainStepConfig, init_opt_state, make_grad_fn, make_train_step
    from repro_torch.train.optimizer import tree_leaves

    cfg = ARCHS[arch].reduced()
    dl = SyntheticLM(cfg, DataConfig(seq_len=64, global_batch=4))
    saved = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        losses = {}
        for where in (dev, "cpu"):
            params = _to(lm.init_params(cfg, 0, device="cpu"), where)
            step = make_train_step(cfg, TrainStepConfig(n_microbatches=2))
            opt, before = init_opt_state(params), dict(LAUNCHES)
            losses[str(where)] = []
            for s in range(2):
                batch = {k: torch.from_numpy(v).to(where) for k, v in dl(s).items()}
                loss, params, opt, _ = step(params, opt, batch)
                losses[str(where)].append(float(loss))
            assert LAUNCHES == before
            _, grads = make_grad_fn(cfg, 1)(params, batch)
            assert all(bool(g.abs().sum() > 0) for g in tree_leaves(grads))
        np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)
    finally:
        L.COMPUTE_DTYPE = saved
    if arch in chip_smoke.TRAIN_CARD_VS_CPU:
        out = chip_smoke._train_card_vs_cpu(dev, arch, *chip_smoke._reduced_heads(arch))
        assert out["float32"]["leaf_excess"] <= 0 and out["float32"]["loss_excess"] <= 0
        assert out["bfloat16"]["least_cosine"] >= chip_smoke.TRAIN_BF16_COS
        assert out["planted_fault"]["excess"] > 0


def _to(tree, where):
    return {k: _to(v, where) if isinstance(v, dict) else v.to(where) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b", "recurrentgemma-9b",
                                  "qwen3-moe-30b-a3b"])
def test_serve_engine_on_the_card(dev, arch):
    """A small ServeEngine run through the kernels: the card's greedy
    tokens and logits agree with the CPU's plain path under float32
    compute, and each layer launches its kernel once per prefill
    (attention: ``flash_attention``, ssm: ``ssd_scan``, rglru:
    ``rglru_scan``) and attention layers ``decode_attention`` once per
    decode step; no scan runs in decode."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = ARCHS[arch].reduced()
    params = lm.init_params(cfg, 0, device="cpu")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    on_card = to_card(params)
    pat = cfg.layer_pattern
    n_attn = sum(m in ("full", "swa", "local") for m in pat)
    want = {"flash_attention": n_attn, "decode_attention": 6 * n_attn,
            "ssd_scan": pat.count("ssm"), "rglru_scan": pat.count("rglru")}
    saved = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    try:
        prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10]]
        before = dict(LAUNCHES)
        card = ServeEngine(cfg, on_card, ServeConfig(batch_slots=4), device=dev).generate(prompts, 6)
        assert {k: LAUNCHES[k] - before[k] for k in want} == want
        cpu = ServeEngine(cfg, params, ServeConfig(batch_slots=4), device="cpu").generate(prompts, 6)
        assert card == cpu
    finally:
        L.COMPUTE_DTYPE = saved


def _float32_compute():
    from repro_torch.models import layers as L

    saved = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float32
    return L, saved


@pytest.mark.parametrize("s,cf", [(1, 1.25), (4, 1.25), (300, 1.25), (300, 0.5)])
def test_moe_block_on_the_card_matches_the_cpu(dev, s, cf):
    """``moe_block`` at qwen3-moe's expert count (128, top-8) and a narrow
    width, float32 compute: on the card every token picks the CPU's
    experts, keeps the CPU's (token, slot) pairs at their places, and the
    outputs agree to 1e-5 of the largest; a decode-sized input (S = 1)
    keeps every slot."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS["qwen3-moe-30b-a3b"], d_model=256, d_ff=128)
    gen = torch.Generator().manual_seed(s)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": torch.randn(d, e, generator=gen) * 0.1,
         "w_in": torch.randn(e, d, f, generator=gen) * 0.05,
         "w_gate": torch.randn(e, d, f, generator=gen) * 0.05,
         "w_out": torch.randn(e, f, d, generator=gen) * 0.05}
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = torch.randn(4, s, d, generator=gen)
    L, saved = _float32_compute()
    try:
        out = {where: L.moe_block(x.to(where), {k: v.to(where) for k, v in p.items()}, cfg,
                                  capacity_factor=cf).cpu()
               for where in ("cpu", dev)}
        routes = {where: L.moe_route(x.to(where), p["router"].to(where), cfg, cf)
                  for where in ("cpu", dev)}
    finally:
        L.COMPUTE_DTYPE = saved
    cpu, card = routes["cpu"], {k: v.cpu() if isinstance(v, torch.Tensor) else v
                                for k, v in routes[dev].items()}
    for key in ("gate_i", "pos", "keep"):
        assert torch.equal(card[key], cpu[key]), key
    if s == 1:
        assert bool(cpu["keep"].all())
    if cf < 1:
        assert not bool(cpu["keep"].all())
    want = out["cpu"]
    torch.testing.assert_close(out[dev], want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-large"])
def test_front_end_prefill_on_the_card_matches_the_cpu(dev, arch):
    """vlm (patch embeddings before the text) and audio (4 codebooks)
    reduced, float32 compute: prefill and 4 decode steps on the card
    (K3, K4) give the CPU's logits within 1e-3."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    cfg = ARCHS[arch].reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    shape = (2, 36, cfg.n_codebooks) if cfg.modality == "audio" else (2, 36)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :32]}
    nv = 0
    if cfg.modality == "vlm":
        nv = cfg.vision_tokens
        batch["vision_embed"] = torch.randn(2, nv, cfg.d_model, generator=gen)
    L, saved = _float32_compute()
    try:
        logits = {}
        for where in ("cpu", dev):
            before = dict(LAUNCHES)
            p = _to(params, where)
            lg, cache = lm.prefill(p, {k: v.to(where) for k, v in batch.items()}, cfg,
                                   max_len=nv + 36)
            steps = [lg]
            for i in range(4):
                lg, cache = lm.decode_step(p, cache, {"tokens": toks[:, 32 + i: 33 + i].to(where)},
                                           nv + 32 + i, cfg)
                steps.append(lg)
            logits[where] = torch.stack(steps).cpu()
            n = cfg.n_layers if where == dev else 0
            assert LAUNCHES["flash_attention"] - before["flash_attention"] == n
            assert LAUNCHES["decode_attention"] - before["decode_attention"] == 4 * n
    finally:
        L.COMPUTE_DTYPE = saved
    v = cfg.vocab_size
    assert logits[dev].shape[-2:] == ((cfg.n_codebooks, lm.padded_vocab(cfg))
                                      if cfg.modality == "audio" else (2, lm.padded_vocab(cfg)))
    assert float((logits[dev] - logits["cpu"])[..., :v].abs().max()) <= 1e-3


# -- the compiled step: CUDA graphs replayed against eager runs --------------


def _block_network(seed: int, m: int = 256, n_blocks: int = 8):
    """Block-sparse weights (each rank's tile and its neighbour's) and a
    per-neuron drive that spreads the firing over the run."""
    rng = np.random.default_rng(seed)
    w = np.zeros((m, m), np.float32)
    b = m // n_blocks
    for d in range(n_blocks):
        for src in (d, (d + 1) % n_blocks):
            tile = (rng.random((b, b)) < 0.3) * rng.gamma(2.0, 2.0, (b, b))
            w[src * b:(src + 1) * b, d * b:(d + 1) * b] = tile
    np.fill_diagonal(w, 0.0)
    return w, rng.uniform(3.0, 8.0, m).astype(np.float32)


@pytest.mark.parametrize("noise", [0.0, 2.0])
@pytest.mark.parametrize("exchange,scatter", [
    ("flat", "fused"), ("two_level", "fused"), ("sparse", "fused"),
    ("ragged", "fused"), ("ragged", "per_round"),
])
def test_replayed_steps_equal_eager(dev, exchange, scatter, noise):
    """A run replayed from a CUDA graph gives the eager run's raster and
    probed currents bit for bit (with channel noise too: each rank's
    key advances on the device as in eager), the same launches, and the same
    ledger, one entry per step (``exchange_volume`` for sparse / ragged)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.snn import DistributedSNN, LIFParams, LoopbackComm

    w, drive = _block_network(5)
    steps, runs = 40, {}
    for graph in (False, True):
        eng = DistributedSNN(mesh=(4, 2), w_syn=w, params=LIFParams(noise_sigma=noise),
                             exchange=exchange, i_ext=drive, ragged_scatter=scatter,
                             device=dev, graph=graph)
        comm, cur = LoopbackComm(eng.mesh, dev), []
        before = dict(LAUNCHES)
        raster = eng.run(steps, seed=3, comm=comm, probe=lambda t, i: cur.append(i.clone()))
        runs[graph] = (raster, comm.step_bytes, {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
                       torch.stack(cur))
    (r0, b0, l0, c0), (r1, b1, l1, c1) = runs[False], runs[True]
    assert r0.sum() > 0 and torch.equal(r1, r0)
    assert torch.equal(c1, c0)
    assert l1 == l0 and b1 == b0 and len(b1) == steps
    if exchange in ("sparse", "ragged"):
        assert l1["spike_accum_blocks"] == steps
        assert b1 == [eng.exchange_stats()[exchange]] * steps


@pytest.mark.parametrize("noise", [0.0, 2.0])
@pytest.mark.parametrize("hook", ["matmul", "spike_accum"])
def test_replayed_oracle_equals_eager(dev, hook, noise):
    """The single-device engine replayed from a CUDA graph (its current
    hook the ``spike_accum`` kernel or a matmul) gives the eager raster and
    membrane trace bit for bit and launches K2 once per step either way."""
    from repro_torch.kernels import LAUNCHES, spike_currents
    from repro_torch.snn import LIFParams, SNNEngine

    w, drive = _block_network(6)
    steps, runs = 40, {}
    fn = spike_currents if hook == "spike_accum" else None
    for graph in (False, True):
        eng = SNNEngine(w_syn=w, params=LIFParams(noise_sigma=noise), i_ext=drive, device=dev,
                        graph=graph)
        before = LAUNCHES["spike_accum"]
        res = eng.run(steps, seed=2, record_v=True, current_fn=fn)
        runs[graph] = (res, LAUNCHES["spike_accum"] - before)
    (e, n0), (g, n1) = runs[False], runs[True]
    assert e.spikes.sum() > 0 and torch.equal(g.spikes, e.spikes)
    assert torch.equal(g.v_trace, e.v_trace)
    assert n0 == n1 == (steps if fn else 0)
    assert g.capture_s > 0 and e.capture_s == 0


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b", "recurrentgemma-9b",
                                  "qwen3-moe-30b-a3b"])
def test_replayed_decode_equals_eager(dev, arch):
    """bf16 decode replayed from CUDA graphs: both schedulers' greedy
    tokens equal the eager engine's (with refills spliced into the
    captured caches, and a one-slot pool whose cache is overwritten whole),
    with the same launches; teacher-forced steps past the cache's end give
    logits within two bf16 steps of eager's (bit-equal unless cuBLAS picks
    another algorithm under capture)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import _Decode

    cfg = ARCHS[arch].reduced()
    params = lm.init_params(cfg, 0, device=dev)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11], [12, 13], [14, 15, 16]]
    for slots in (4, 1):
        for name in ("generate", "generate_continuous"):
            out = {}
            for graph in (False, True):
                eng = ServeEngine(cfg, params, ServeConfig(batch_slots=slots), device=dev,
                                  graph=graph)
                before = dict(LAUNCHES)
                toks = getattr(eng, name)(prompts, 6)
                out[graph] = (toks, {k: LAUNCHES[k] - before[k] for k in LAUNCHES})
            assert out[True] == out[False], (slots, name)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1), dtype=torch.int32)
    logits = {}
    with torch.inference_mode():
        for graph in (False, True):
            eng = ServeEngine(cfg, params, device=dev, graph=graph)
            _, caches = lm.prefill(params, {"tokens": toks[:, :8]}, cfg, max_len=12)
            decode = _Decode(eng, caches, 2, 8)
            logits[graph] = torch.stack([decode(toks[:, 8 + i]).clone() for i in range(8)])
    got, want = logits[True][..., :cfg.vocab_size], logits[False][..., :cfg.vocab_size]
    rms = float(want.double().pow(2).mean().sqrt())
    assert float(((got - want).abs() - 2**-6 * want.abs()).max()) <= 2**-6 * rms


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b", "recurrentgemma-9b",
                                  "llava-next-mistral-7b", "musicgen-large", "qwen2.5-14b",
                                  "deepseek-7b", "yi-34b", "phi4-mini-3.8b", "mamba2-1.3b"])
def test_replayed_train_step_equals_eager(dev, arch):
    """``chip_smoke.py`` phase ``train``'s replayed-against-eager check:
    4 steps of the compiled train step (step 1 eager, step 2 captured, then
    replayed) from the seed of two eager runs give their losses, learning
    rates and every parameter, moment, master (and residual) bit for bit,
    or within twice the eager runs' spread where they already differ; a
    replay that does not advance ``count`` fails the same check.  The eight
    reduced configs of check (3) (int8 and top-k compression on two), and
    phi4 and mamba2 at full width cut to 2 layers."""
    import chip_smoke

    if arch in chip_smoke.TRAIN_CARD_VS_CPU:
        out = chip_smoke._replay_vs_eager_reduced(dev, arch)
    else:
        layers, batch, seq = chip_smoke.REPLAY_FULL
        out = chip_smoke._replay_vs_eager(dev, chip_smoke._depth_cut(arch, layers), batch, seq)
    assert out["planted_frozen_count"]["failed_the_check"]
    if out["eager_runs_bit_equal"]:
        assert not any(out["replayed_diff"].values())


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b"])
def test_replayed_prefill_equals_eager(dev, arch):
    """Prefill buckets replayed from CUDA graphs: both schedulers' greedy
    tokens equal a ``graph=False`` engine's, with the same kernel launches;
    the continuous scheduler's one bucket is captured at its second request
    and replayed for every later one."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = ARCHS[arch].reduced()
    params = lm.init_params(cfg, 0, device=dev)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11], [12, 13], [14, 15, 16]]
    for name in ("generate", "generate_continuous"):
        out = {}
        for graph in (False, True):
            eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2), device=dev, graph=graph)
            before = dict(LAUNCHES)
            toks = getattr(eng, name)(prompts, 6)
            out[graph] = (toks, {k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        assert out[True] == out[False], name
        runs = [b.run for b in eng._prefills.values()]
        assert all(r.graph is not None for r in runs)
        assert sum(r.calls for r in runs) == (3 if name == "generate" else len(prompts))


def test_checkpoint_restores_onto_the_card_bit_for_bit(dev, tmp_path):
    """A checkpoint of card state (f32, bf16, int and f64 leaves) restored
    with ``device="cuda"`` and into card targets equals the saved tensors;
    ``save_async`` snapshots the card state before an in-place write."""
    from repro_torch.train import Checkpointer, restore, save

    gen = torch.Generator(device=dev).manual_seed(0)
    state = {"w": [torch.randn(3, 5, generator=gen, device=dev),
                   torch.randn(7, generator=gen, device=dev).to(torch.bfloat16)],
             "ids": (torch.arange(9, device=dev, dtype=torch.int32),),
             "v": torch.randn(4, generator=gen, device=dev, dtype=torch.float64)}
    want = {"w": [t.clone() for t in state["w"]], "ids": (state["ids"][0].clone(),),
            "v": state["v"].clone()}
    save(str(tmp_path / "a"), 1, state)
    cpu_like = {"w": [torch.zeros(3, 5), torch.zeros(7, dtype=torch.bfloat16)],
                "ids": (torch.zeros(9, dtype=torch.int32),), "v": torch.zeros(4, dtype=torch.float64)}
    ckpt = Checkpointer(str(tmp_path / "b"))
    ckpt.save_async(2, state)
    state["v"].add_(1.0)  # the card state is written in place right after
    ckpt.wait()
    for d, step, like in ((tmp_path / "a", 1, cpu_like), (tmp_path / "b", 2, cpu_like),
                          (tmp_path / "a", 1, state)):
        got, _ = restore(str(d), step, like, device=None if like is state else "cuda")
        for a, b in ((got["w"][0], want["w"][0]), (got["w"][1], want["w"][1]),
                     (got["ids"][0], want["ids"][0]), (got["v"], want["v"])):
            assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)


def test_sharded_train_step_on_a_one_rank_mesh(dev):
    """``chip_smoke.py`` phase ``sharding``'s (a) at the reduced phi4: the
    DTensor train step on a one-rank NCCL ``(1, 1)`` mesh against the
    unsharded step, 3 steps of batch 4 × 64; K3 refuses a DTensor."""
    import chip_smoke
    from repro_torch.configs import ARCHS

    out = chip_smoke._sharded_train(dev, ARCHS["phi4-mini-3.8b"].reduced(), seq=64, batch=4)
    assert out["step1_loss_rel_diff"]["value"] <= out["step1_loss_rel_diff"]["bound"]
    assert len(out["sharded"]["losses"]) == 3 and out["sharded"]["step_profile"]["kernels_per_step"]
    assert "DTensor" in out["k3_refuses_dtensor"]


def test_sharded_serve_on_a_one_rank_mesh(dev):
    """``chip_smoke.py`` phase ``sharding``'s (c) and (d) at the reduced phi4:
    ``ServeEngine(pol=...)`` on a one-rank NCCL ``(1, 1)`` mesh gives the
    unsharded engine's greedy tokens with both schedulers, each call
    launching its layers' K3 / K4, decode replayed from a CUDA graph; and
    the dry-run's count of phi4's decode step on that mesh is priced."""
    import chip_smoke
    from repro_torch.configs import ARCHS

    with chip_smoke._one_rank_mesh(dev) as mesh:
        out = chip_smoke._sharded_serve(dev, mesh, ARCHS["phi4-mini-3.8b"].reduced(), new=8)
        assert out["tokens_equal_unsharded"] == ["generate", "generate_continuous"]
        assert all(r["graph"] and r["captures"] for r in out["sharded"].values())
        dry = chip_smoke._dryrun_vs_card(mesh, None)
    assert dry["flops_per_step"] > 0 and dry["dominant"] == "memory"


# -- threefry: JAX's random streams on the card ------------------------------


@pytest.mark.parametrize("case", ["lif_noise", "phi4_sampler", "phi4_leaf"])
def test_threefry_matches_plain(dev, case):
    """``chip_smoke.py`` phase 2's ``threefry`` cases (a rank-stacked LIF
    draw ``[8, 4096]`` after a split, phi4's sampler ``[4, vocab]``, one
    full-width phi4 bfloat16 leaf): keys, split and raw bits bit-equal to the
    plain version on the card, float32 normals and gumbels within 2 ulp,
    bfloat16 normals within one bfloat16 ulp, reruns bit-identical."""
    import chip_smoke
    from repro_torch import random
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import threefry as k

    _, rows, n, kind, dtype_name, split_first = next(
        c for c in chip_smoke.THREEFRY_CASES if c[0] == case)
    dtype = getattr(torch, dtype_name)
    root = random.PRNGKey(3, device=dev)[None]
    keys = k.split(root, rows)[0]
    assert torch.equal(keys, random.split_ref(root, rows)[0])
    bits = random.KINDS["bits"]
    assert torch.equal(k.draw(keys, n, bits, torch.int64),
                       random.draw_ref(keys, n, bits, torch.int64))
    lo, diff = random.bounds(kind, dtype)
    before = LAUNCHES["threefry"]
    got, again = (k.draw(keys, n, random.KINDS[kind], dtype, lo, diff, split_first=split_first)
                  for _ in range(2))
    assert LAUNCHES["threefry"] == before + 2
    want = random.draw_ref(keys, n, random.KINDS[kind], dtype, lo, diff,
                           split_first=split_first)
    if split_first:
        assert torch.equal(got[0], want[0]) and torch.equal(again[0], want[0])
        got, again, want = got[1], again[1], want[1]
    assert torch.equal(got, again) and torch.isfinite(got).all()
    limit = chip_smoke.THREEFRY_ULPS[f"{kind}/{dtype_name}"]
    assert chip_smoke._ulps(got, want, dtype) <= limit


def test_draws_on_the_card_equal_the_cpus(dev):
    """The public draws on a CUDA key launch the kernel once each (split,
    the draws, ``split_normal``, ``categorical``'s gumbel) and give the CPU
    key's values: keys and bits bit-equal, float32 within 2 ulp, bfloat16
    within one bfloat16 ulp, the categorical draw index for index."""
    import chip_smoke
    from repro_torch import random
    from repro_torch.kernels import LAUNCHES

    cpu = random.split(random.PRNGKey(11), 4)
    card = cpu.to(dev)
    before = LAUNCHES["threefry"]
    assert torch.equal(random.split(card, 3).cpu(), random.split(cpu, 3))
    assert torch.equal(random.random_bits(card, 16, (5, 7)).cpu(),
                       random.random_bits(cpu, 16, (5, 7)))
    for fn, dtype, limit in ((random.normal, torch.float32, 2),
                             (random.normal, torch.bfloat16, 1),
                             (random.gumbel, torch.float32, 2),
                             (lambda k, s, d: random.uniform(k, s, d, 0.9, 0.999),
                              torch.float32, 0)):
        got, want = fn(card, (3, 1000), dtype), fn(cpu, (3, 1000), dtype)
        assert got.device.type == "cuda"
        assert chip_smoke._ulps(got.cpu(), want, dtype) <= limit
    new, z = random.split_normal(card, (4096,))
    want_new, want_z = random.split_normal(cpu, (4096,))
    assert torch.equal(new.cpu(), want_new) and chip_smoke._ulps(z.cpu(), want_z,
                                                                 torch.float32) <= 2
    logits = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 5000)).astype(np.float32))
    assert torch.equal(random.categorical(card[0], logits.to(dev)).cpu(),
                       random.categorical(cpu[0], logits))
    assert LAUNCHES["threefry"] == before + 8


def test_noisy_runs_and_weights_on_the_card_equal_the_cpus(dev):
    """Channel noise at ``noise_sigma=2`` on the card: the distributed
    engine's raster (replayed, one ``threefry`` launch a step) equals the
    CPU engine's for the same seed; ``init_params`` of a reduced config
    drawn on the card equals the CPU's draw leaf by leaf."""
    import chip_smoke
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.snn import BlockSynapses, DistributedSNN, LIFParams

    w, drive = _block_network(7)
    steps = 60
    runs = {}
    for where in (dev, "cpu"):
        before = LAUNCHES["threefry"]
        runs[str(where)] = DistributedSNN(
            mesh=(4, 2), params=LIFParams(noise_sigma=2.0), exchange="sparse", i_ext=drive,
            syn=BlockSynapses.from_dense(w, 8), device=where).run(steps, seed=3).cpu()
        launched = LAUNCHES["threefry"] - before
        assert launched == (steps + 1 if where == dev else 0)  # the keys' split, then a step each
    assert runs[str(dev)].sum() > 0 and torch.equal(runs[str(dev)], runs["cpu"])
    cfg = ARCHS["mamba2-1.3b"].reduced()
    chip_smoke._numpy_params(cfg, 4, dev)  # raises when a leaf differs
