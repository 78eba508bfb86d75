"""The port's mixture of experts (``repro_torch.models.layers.moe_block``,
``_topk_iterative``) against the JAX package's on the CPU, from the same
numpy inputs (bf16-exact values).

The port dispatches by index where the reference multiplies one-hot masks;
the kept rows, the products and the gate weights are the same, only the
float32 sum over a token's k slots runs in another order.  Tolerances:
bf16 compute, two bf16 steps (``rtol = 2^-6``, ``atol = 2^-6 · rms``);
float32 compute (``COMPUTE_DTYPE`` float32 in both packages), ``1e-5`` of
the largest output; gradients ``1e-4 · max|g|``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.sharding.policies import ShardingPolicy
from repro_torch.configs import ARCHS
from repro_torch.models import layers as L
from tests.test_moe import _dense_moe_oracle

POL = ShardingPolicy()
ARCH = "qwen3-moe-30b-a3b"  # reduced: 8 experts, top-2, d_model 128, d_ff 256


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _inputs(seed: int, b: int, s: int, router_scale: float = 0.1, arch: str = ARCH):
    """Expert weights and tokens (bf16-exact numpy), the reference's and
    the port's configs."""
    jc, pc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    rng = np.random.default_rng(seed)
    d, e, f = pc.d_model, pc.n_experts, pc.d_ff
    p = {"router": _bf16_exact(rng.normal(size=(d, e)) * router_scale),
         "w_in": _bf16_exact(rng.normal(size=(e, d, f)) * 0.05),
         "w_gate": _bf16_exact(rng.normal(size=(e, d, f)) * 0.05),
         "w_out": _bf16_exact(rng.normal(size=(e, f, d)) * 0.05)}
    return jc, pc, p, _bf16_exact(rng.normal(size=(b, s, d)))


def _both(jc, pc, p, x, **kw):
    """(port, reference) outputs as float32 numpy."""
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    ref = JL.moe_block(jnp.asarray(x, JL.COMPUTE_DTYPE), jp, jc, POL, **kw)
    got = L.moe_block(torch.from_numpy(x).to(L.COMPUTE_DTYPE), tp, pc, **kw)
    assert got.dtype == L.COMPUTE_DTYPE and got.shape == x.shape
    return got.float().numpy(), np.asarray(ref, np.float32)


def assert_bf16_close(got, want):
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    np.testing.assert_allclose(got, want, rtol=2**-6, atol=2**-6 * rms)


def assert_f32_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _route_oracle(gate_i: np.ndarray, cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Each (token, slot)'s place in its expert's buffer by counting along
    each row's flattened S·k order, and whether it fits the capacity."""
    b, s, k = gate_i.shape
    pos = np.zeros((b, s, k), np.int64)
    for r in range(b):
        seen: dict[int, int] = {}
        for t in range(s):
            for j in range(k):
                ex = int(gate_i[r, t, j])
                pos[r, t, j] = seen.get(ex, 0)
                seen[ex] = pos[r, t, j] + 1
    return pos, pos < cap


@pytest.mark.parametrize("seed", [0, 1])
def test_ample_capacity_matches_reference_and_dense_oracle(seed):
    """``capacity_factor=8``: nothing drops, so the port equals the
    reference (bf16) and ``tests/test_moe.py``'s dense oracle (its own
    bound); under float32 compute it equals the reference to 1e-5."""
    jc, pc, p, x = _inputs(seed, 2, 32)
    got, ref = _both(jc, pc, p, x, capacity_factor=8.0)
    assert_bf16_close(got, ref)
    oracle = _dense_moe_oracle(jnp.asarray(x, jnp.bfloat16),
                               {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
                               jc, jc.top_k)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32), rtol=0.1, atol=0.02)
    r = L.moe_route(torch.from_numpy(x), torch.from_numpy(p["router"]), pc, 8.0)
    assert bool(r["keep"].all())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tight_capacity_drops_the_references_slots(dtype, monkeypatch):
    """``capacity_factor=0.25`` with a skewed router (scale 5): most slots
    drop, and the outputs agree only if the port drops exactly the
    reference's (token, slot) pairs; its places in the experts' buffers
    equal a counting loop's."""
    if dtype == "float32":
        monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jc, pc, p, x = _inputs(3, 2, 64, router_scale=5.0)
    got, ref = _both(jc, pc, p, x, capacity_factor=0.25)
    (assert_bf16_close if dtype == "bfloat16" else assert_f32_close)(got, ref)
    r = L.moe_route(torch.from_numpy(x), torch.from_numpy(p["router"]), pc, 0.25)
    assert r["cap"] == int(64 * pc.top_k * 0.25 / pc.n_experts) + 1
    pos, keep = _route_oracle(r["gate_i"].numpy(), r["cap"])
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert 0 < keep.sum() < keep.size  # some slots drop, some stay
    # a dropped slot adds nothing: a token whose slots all dropped gives 0
    lost = ~keep.any(-1)
    assert lost.any() and np.all(got[lost] == 0) and np.all(ref[lost] == 0)


def test_chunked_sequence_matches(f32_compute):
    """S = 8,192 (two 4,096-token dispatch groups, the reference's
    chunking) at reduced width; the chunks compete for capacity on their
    own, which differs from one 8,192-token group."""
    jc, pc, p, x = _inputs(5, 1, 8192, router_scale=1.0)
    got, ref = _both(jc, pc, p, x)
    assert_f32_close(got, ref)
    halves = [L.moe_block(torch.from_numpy(x[:, i * 4096:(i + 1) * 4096]),
                          {k: torch.from_numpy(v) for k, v in p.items()}, pc).numpy()
              for i in range(2)]
    np.testing.assert_array_equal(got, np.concatenate(halves, axis=1))
    whole = L.moe_route(torch.from_numpy(x), torch.from_numpy(p["router"]), pc)
    assert whole["cap"] != L.moe_route(torch.from_numpy(x[:, :4096]),
                                       torch.from_numpy(p["router"]), pc)["cap"]


def test_mixtral_and_unchunked_lengths_match():
    """mixtral reduced (8 experts top-2, the reference's TP mode) and a
    sequence over 4,096 that is no multiple of it (one dispatch group)."""
    jc, pc, p, x = _inputs(6, 2, 24, arch="mixtral-8x22b")
    assert_bf16_close(*_both(jc, pc, p, x))
    jc, pc, p, x = _inputs(7, 1, 4100)
    assert_bf16_close(*_both(jc, pc, p, x))


@pytest.mark.parametrize("case", ["random", "tied"])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_topk_iterative_matches_reference(case, k):
    """Indices and values equal the reference's, ties included: argmax
    takes the first maximum in both libraries."""
    rng = np.random.default_rng(k)
    if case == "random":
        probs = rng.random((3, 7, 16)).astype(np.float32)
    else:  # few distinct values, so most rounds pick among equals
        probs = (rng.integers(0, 3, (3, 7, 16)) / 4).astype(np.float32)
    jv, ji = JL._topk_iterative(jnp.asarray(probs), k)
    tv, ti = L._topk_iterative(torch.from_numpy(probs), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if case == "tied" and k > 1:  # equal values were picked: the order among ties counted
        assert (np.diff(tv.numpy(), axis=-1) == 0).any()


def test_gradients_match(f32_compute):
    """d/d(router, experts, x) of a scalar loss through the block, float32
    compute and float32 parameters, at capacity 1.25 (some slots drop):
    the routing masks carry no gradient, the gate weights do."""
    jc, pc, p, x = _inputs(9, 2, 32, router_scale=1.0)
    w = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)

    def jloss(jp, jx):
        return jnp.sum(JL.moe_block(jx, jp, jc, POL) * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                              jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (L.moe_block(tx, tp, pc) * torch.from_numpy(w)).sum().backward()
    assert not bool(L.moe_route(tx, tp["router"], pc)["keep"].all())
    for name in sorted(p):
        want = np.asarray(jg[name])
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(tp[name].grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)
    want = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_decode_token_never_drops():
    """A decode step (S = 1) has capacity ``int(k · 1.25 / E) + 1`` and k
    distinct experts, so it keeps every slot (qwen3-moe at full width:
    capacity 1)."""
    cfg = dataclasses.replace(ARCHS[ARCH], d_model=64)
    router = torch.randn(64, cfg.n_experts, generator=torch.Generator().manual_seed(0))
    r = L.moe_route(torch.randn(4, 1, 64), router, cfg)
    assert r["cap"] == 1 and bool(r["keep"].all())
    assert all(len(set(row.tolist())) == cfg.top_k for row in r["gate_i"].reshape(4, -1))
