"""The port's sequence scans and recurrent mixers on the CPU, against the
JAX package on the same numpy inputs:

* the plain versions (``repro_torch.kernels.ref``: ``ssd_chunked``,
  ``ssd_ref``, ``rglru_ref``) against the Pallas kernels in interpret
  mode (``ssd_scan``, ``rglru_scan``, as the reference's own tests run
  them), ``_ssd_chunked_jnp`` and the JAX recurrences, on the sweeps of
  ``tests/test_kernels.py:64-103``, at the reference's ``rtol = atol =
  3e-3``;
* the layer functions of the Mamba-2 and RG-LRU blocks
  (``repro_torch.models.layers``) against ``repro.models.layers`` in float32
  (``COMPUTE_DTYPE`` float32 in both packages): ``1e-5`` for the convs and
  gates, which are the same elementwise float32 arithmetic; ``3e-3`` for
  the blocks, whose scans and matmuls sum in other orders.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ref as R
from repro.kernels.ops import _ssd_chunked_jnp
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.sharding.policies import ShardingPolicy
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.ref import rglru_ref, ssd_chunked, ssd_ref
from repro_torch.models import layers as L
from repro_torch.models import lm

POL = ShardingPolicy()
CPU = "cpu"
TOL = dict(rtol=3e-3, atol=3e-3)  # tests/test_kernels.py:74-76, 101-103
EXACT = dict(rtol=1e-5, atol=1e-5)

SSD_CASES = [(2, 256, 4, 2, 32, 16, 64), (1, 128, 2, 1, 16, 8, 128), (1, 512, 8, 2, 64, 32, 128)]
RGLRU_CASES = [(2, 256, 128, 64, 64), (1, 128, 256, 128, 128), (3, 512, 64, 256, 64)]


def _ssd_inputs(seed, bs, s, h, g, p, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bs, s, h, p)).astype(np.float32),
            rng.uniform(0.85, 0.999, size=(bs, s, h)).astype(np.float32),
            rng.normal(size=(bs, s, g, n)).astype(np.float32),
            rng.normal(size=(bs, s, g, n)).astype(np.float32))


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("bs,s,h,g,p,n,chunk", SSD_CASES)
def test_ssd_plain_versions_match_jax(bs, s, h, g, p, n, chunk):
    """``ssd_chunked`` against the Pallas ``ssd_scan`` (interpret mode) and
    ``_ssd_chunked_jnp``; ``ssd_ref`` against ``ssd_ref``."""
    arrs = _ssd_inputs(s + p, bs, s, h, g, p, n)
    jx = [jnp.asarray(a) for a in arrs]
    out = ssd_chunked(*_t(*arrs), chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == (bs, s, h, p)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ssd_scan(*jx, chunk=chunk,
                                                                    interpret=True)), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(_ssd_chunked_jnp(*jx, chunk=chunk)), **TOL)
    np.testing.assert_allclose(ssd_ref(*_t(*arrs)).numpy(), np.asarray(R.ssd_ref(*jx)), **TOL)


def test_ssd_chunk_rule():
    """``chunk = min(chunk, S)``: S = 127 runs as one chunk of 127 (not a
    power of two) and equals the recurrence; S = 200 > 128 is not a
    multiple of 128 and raises, where the reference's reshape fails."""
    arrs = _ssd_inputs(1, 1, 127, 2, 1, 16, 8)
    out = ops.ssd(*_t(*arrs))
    np.testing.assert_allclose(out.numpy(), np.asarray(R.ssd_ref(*map(jnp.asarray, arrs))),
                               **TOL)
    np.testing.assert_allclose(out.numpy(), ssd_ref(*_t(*arrs)).numpy(), **TOL)
    bad = _t(*_ssd_inputs(2, 1, 200, 2, 1, 16, 8))
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd(*bad)
    with pytest.raises(TypeError):  # the reference fails on the same shape
        _ssd_chunked_jnp(*map(jnp.asarray, (b.numpy() for b in bad)), chunk=128)


# the sweeps, then chunks that are not powers of two: 127 = min(128, S) at
# S = 127, and 96
STATE_CASES = SSD_CASES + [(1, 127, 4, 1, 64, 32, 128), (2, 288, 4, 2, 32, 16, 96)]


def _closed_form_state(xh: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, rep: int):
    """h_S = Σ_s (Π_{u>s} a_u) b_s ⊗ x_s over the whole sequence: the
    reference's closed form, in PyTorch (one float32 cumsum)."""
    cum = torch.cumsum(torch.log(a.float()), dim=1)  # [B, S, H]
    decay_to_end = torch.exp(cum[:, -1:] - cum)
    bb = bmat.float().repeat_interleave(rep, dim=2) * decay_to_end[..., None]  # [B,S,H,N]
    return torch.einsum("bshn,bshp->bhnp", bb, xh.float())


@pytest.mark.parametrize("bs,s,h,g,p,n,chunk", STATE_CASES)
def test_ssd_final_state_matches_closed_form(bs, s, h, g, p, n, chunk):
    """The state ``ssd_chunked`` carries out of its last chunk equals the
    reference's closed form ``repro.models.layers._final_ssd_state`` (JAX)
    and a PyTorch copy of it, and asking for it leaves y as it was."""
    arrs = _ssd_inputs(s + n, bs, s, h, g, p, n)
    x, a, b, c = _t(*arrs)
    y, state = ssd_chunked(x, a, b, c, chunk=chunk, return_state=True)
    assert state.dtype == torch.float32 and state.shape == (bs, h, n, p)
    torch.testing.assert_close(y, ssd_chunked(x, a, b, c, chunk=chunk), rtol=0, atol=0)
    want = JL._final_ssd_state(*(jnp.asarray(v) for v in (arrs[0], arrs[1], arrs[2])), h // g)
    np.testing.assert_allclose(state.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(state.numpy(), _closed_form_state(x, a, b, h // g).numpy(), **TOL)
    got_y, got = ops.ssd(x, a, b, c, chunk=chunk, return_state=True)  # the CPU dispatch
    torch.testing.assert_close(got, state, rtol=0, atol=0)
    torch.testing.assert_close(got_y, y, rtol=0, atol=0)


def test_ssd_float64_plain_versions_agree():
    """Given float64 inputs the plain versions compute in float64 (the
    yardstick on the card): chunked and direct recurrence agree to 1e-10."""
    x, a, b, c = (t.double() for t in _t(*_ssd_inputs(3, 2, 256, 4, 2, 32, 16)))
    out = ssd_chunked(x, a, b, c, chunk=64)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, ssd_ref(x, a, b, c), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("bs,s,d,chunk,bd", RGLRU_CASES)
def test_rglru_ref_matches_jax(bs, s, d, chunk, bd):
    rng = np.random.default_rng(s + d)
    a = rng.uniform(0.8, 0.999, size=(bs, s, d)).astype(np.float32)
    b = rng.normal(size=(bs, s, d)).astype(np.float32)
    out = rglru_ref(*_t(a, b))
    assert out.dtype == torch.float32 and out.shape == (bs, s, d)
    kern = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b), chunk=chunk, block_d=bd, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(R.rglru_ref(jnp.asarray(a), jnp.asarray(b))),
                               **TOL)


def test_cpu_scans_launch_nothing():
    before = dict(LAUNCHES)
    arrs = _t(*_ssd_inputs(4, 1, 64, 2, 1, 16, 8))
    torch.testing.assert_close(ops.ssd(*arrs, chunk=32), ssd_chunked(*arrs, chunk=32),
                               rtol=0, atol=0)
    a, b = torch.rand(2, 40, 8), torch.randn(2, 40, 8)
    torch.testing.assert_close(ops.rglru(a, b), rglru_ref(a, b), rtol=0, atol=0)
    assert LAUNCHES == before


# -- layer functions ---------------------------------------------------------


@pytest.fixture
def float32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


def _layer0(arch: str):
    """Layer 0's parameters of the reduced ``arch`` in both packages."""
    jc, pc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = convert.lm_params(jax.tree.map(lambda x: np.asarray(x, np.float32), jp), pc, CPU)
    return jc, pc, jax.tree.map(lambda x: x[0], jp["seg0"]["m0"]), lm._layer(tp["seg0"], 0)["m0"]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_convs_match(float32_compute):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 24, 48)).astype(np.float32)
    w = rng.normal(size=(4, 48)).astype(np.float32)
    np.testing.assert_allclose(L.causal_conv1d(*_t(x, w)).numpy(),
                               np.asarray(JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w))),
                               **EXACT)
    state = rng.normal(size=(2, 3, 48)).astype(np.float32)
    y, st = L.conv1d_step(*_t(x[:, 0], state, w))
    jy, jst = JL.conv1d_step(jnp.asarray(x[:, 0]), jnp.asarray(state), jnp.asarray(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **EXACT)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    # one step of the conv equals the full conv's last position
    full = L.causal_conv1d(*_t(np.concatenate([state, x[:, :1]], axis=1), w))
    torch.testing.assert_close(y, full[:, -1], **EXACT)
    # bf16 in, bf16 out, summed in float32
    xb = torch.from_numpy(x).bfloat16()
    assert L.causal_conv1d(xb, torch.from_numpy(w)).dtype == torch.bfloat16


def test_gates_match(float32_compute):
    jc, pc, jp, tp = _layer0("mamba2-1.3b")
    dt = np.random.default_rng(8).normal(size=(2, 16, pc.ssm_heads)).astype(np.float32) * 3
    for got, want in zip(L._ssm_gates(torch.from_numpy(dt), tp),
                         JL._ssm_gates(jnp.asarray(dt), jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    jc, pc, jp, tp = _layer0("recurrentgemma-9b")
    u = np.random.default_rng(9).normal(size=(2, 16, pc.lru_width)).astype(np.float32)
    for got, want in zip(L._rglru_gates(torch.from_numpy(u), tp),
                         JL._rglru_gates(jnp.asarray(u), jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


def test_softplus_matches_logaddexp_above_20():
    x = torch.tensor([-30.0, -1.0, 0.0, 5.0, 19.9, 20.0, 20.5, 40.0, 90.0])
    np.testing.assert_allclose(L._softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("s", [48, 128])
def test_mamba2_block_and_decode_match(float32_compute, s):
    """The block's output and its decode state (SSM state and raw conv
    tails), then one decode step from that state."""
    jc, pc, jp, tp = _layer0("mamba2-1.3b")
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, pc.d_model)).astype(np.float32)
    out, st = L.mamba2_block(torch.from_numpy(x), tp, pc, return_state=True)
    jout, jst = JL.mamba2_block(jnp.asarray(x), jp, jc, POL, return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(jst["ssm"]), **TOL)
    for key in ("x", "b", "c"):
        np.testing.assert_allclose(_np(st["conv"][key]), _np(jst["conv"][key]), **TOL)
    xt = rng.normal(size=(2, 1, pc.d_model)).astype(np.float32)
    cache = {"ssm": st["ssm"].clone(), "conv": {k: v.clone() for k, v in st["conv"].items()}}
    y, new = L.mamba2_decode(torch.from_numpy(xt), tp, cache, pc)
    jy, jnew = JL.mamba2_decode(jnp.asarray(xt), jp, jst, jc, POL)
    assert new is cache  # updated in place
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(jnew["ssm"]), **TOL)
    np.testing.assert_allclose(cache["conv"]["x"].numpy(), np.asarray(jnew["conv"]["x"]), **TOL)


@pytest.mark.parametrize("s", [40, 96])
def test_rglru_block_and_decode_match(float32_compute, s):
    jc, pc, jp, tp = _layer0("recurrentgemma-9b")
    rng = np.random.default_rng(s + 1)
    x = rng.normal(size=(2, s, pc.d_model)).astype(np.float32)
    out, st = L.rglru_block(torch.from_numpy(x), tp, pc, return_state=True)
    jout, jst = JL.rglru_block(jnp.asarray(x), jp, jc, POL, return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(jst["h"]), **TOL)
    np.testing.assert_allclose(st["conv"].numpy(), np.asarray(jst["conv"]), **TOL)
    xt = rng.normal(size=(2, 1, pc.d_model)).astype(np.float32)
    cache = {"h": st["h"].clone(), "conv": st["conv"].clone()}
    y, _ = L.rglru_decode(torch.from_numpy(xt), tp, cache, pc)
    jy, jnew = JL.rglru_decode(jnp.asarray(xt), jp, jst, jc, POL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(cache["h"].numpy(), np.asarray(jnew["h"]), **TOL)
    np.testing.assert_allclose(cache["conv"].numpy(), np.asarray(jnew["conv"]), **TOL)
