"""The port's training path (``repro_torch.data``, ``repro_torch.train``,
``lm.loss_fn``, ``layers.blocked_attention`` and the mixers' training
route, ``repro_torch.launch.train``) against the JAX package's on the CPU,
from the same numpy inputs: ``SyntheticLM`` batches and the reference's
``init_params`` carried across by ``convert.lm_params``.

Tolerances.  The data pipeline and gradient compression are the same
arithmetic on the same numbers: exactly equal.  AdamW and the schedule in
float32: 1e-6 relative (a parameter kept in bf16 within one bf16 step of
the reference's, since a master one float32 step away may round to the
neighbouring bf16).  ``blocked_attention`` in float32: 1e-5 absolute.
Loss and gradients under float32 compute (``COMPUTE_DTYPE`` float32 in both
packages and the parameters in float32, so no gradient is rounded to
bf16 — one bf16 step of a large entry would dwarf any bound that compares
the algorithm): loss 1e-5 relative, each gradient leaf within
1e-4·max|g_ref| + 1e-6.  Under bf16 compute the two round at other places
of other sums: loss 2e-2 relative, each gradient leaf's cosine with the
reference's at least 0.99.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.sharding.policies import ShardingPolicy
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert, data
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.train import (
    AdamWConfig,
    Supervisor,
    SupervisorConfig,
    TrainStepConfig,
    adamw_update,
    cosine_lr,
    init_opt_state,
    make_grad_fn,
    make_train_step,
)
from repro_torch.train import checkpoint as ck
from repro_torch.train import compression
from repro_torch.train.optimizer import global_norm, tree_leaves, tree_map

POL = ShardingPolicy()
CPU = "cpu"
TRAINED = ["deepseek-7b", "phi4-mini-3.8b", "mamba2-1.3b", "recurrentgemma-9b"]
SEQ = 32


def _cfgs(arch: str):
    return JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()


def _params(jc, pc, *, f32: bool = False, seed: int = 0):
    """The reference's init_params and the port's copy of it; ``f32``: every
    leaf in float32 in both."""
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    if f32:
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    tp = convert.lm_params(jax.tree.map(lambda x: np.asarray(x, np.float32), jp), pc, CPU)
    if f32:
        tp = tree_map(lambda x: x.float(), tp)
    return jp, tp


def _batches(jc, pc, step: int, batch: int = 4, seq: int = SEQ):
    nb = jdata.SyntheticLM(jc, jdata.DataConfig(seq_len=seq, global_batch=batch))(step)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture
def f32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-7b", "llava-next-mistral-7b", "musicgen-large"])
@pytest.mark.parametrize("step,host", [(0, (0, 1)), (5, (1, 2))])
def test_synthetic_batches_equal_the_references(arch, step, host):
    kw = dict(seq_len=SEQ, global_batch=4, seed=3, host_index=host[0], host_count=host[1])
    jc, pc = _cfgs(arch)
    want = jdata.SyntheticLM(jc, jdata.DataConfig(**kw))(step)
    got = data.SyntheticLM(pc, data.DataConfig(**kw))(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_prefetcher_yields_the_steps_in_order():
    d = data.SyntheticLM(ARCHS["deepseek-7b"].reduced(), data.DataConfig(seq_len=16, global_batch=2))
    pf = data.Prefetcher(d, depth=2, start_step=3)
    try:
        for s in (3, 4, 5):
            assert np.array_equal(next(pf)["tokens"], d(s)["tokens"])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------


def test_cosine_lr_matches():
    cfg = AdamWConfig(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10, total_steps=100)
    jcfg = jopt.AdamWConfig(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10, total_steps=100)
    steps = [0, 1, 5, 10, 11, 50, 99, 100, 150]
    got = np.array([float(cosine_lr(cfg, torch.tensor(s, dtype=torch.int32))) for s in steps])
    want = np.array([float(jopt.cosine_lr(jcfg, jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[1] < got[3] and got[4] >= got[5] >= got[7] and abs(got[7] - 1e-4) < 1e-9


def _state_pair(rng, warm_steps: int):
    """The same params (a bf16 matrix, f32 vectors), grads and an AdamW
    state after ``warm_steps`` reference updates, in both packages."""
    shapes = {"w": ((48, 40), jnp.bfloat16), "b": ((40,), jnp.float32),
              "blk": {"s": ((7, 5), jnp.float32)}}
    jp = jax.tree.map(lambda sd: jnp.asarray(rng.normal(size=sd[0]), sd[1]), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    jcfg = jopt.AdamWConfig(warmup_steps=3, total_steps=20, weight_decay=0.1)
    js = jopt.init_opt_state(jp)
    for _ in range(warm_steps):
        g = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), jp)
        jp, js, _ = jopt.adamw_update(jp, g, js, jcfg)
    jg = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * 3.0, p.dtype), jp)

    def port(x):
        t = torch.from_numpy(np.array(x, np.float32))
        return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t.to(
            torch.int32 if x.dtype == jnp.int32 else torch.float32)

    tp, tg = jax.tree.map(port, jp), jax.tree.map(port, jg)
    ts = jax.tree.map(port, js)
    return (jp, jg, js, jcfg), (tp, tg, ts)


@pytest.mark.parametrize("warm_steps", [0, 4])
def test_adamw_update_matches(warm_steps):
    (jp, jg, js, jcfg), (tp, tg, ts) = _state_pair(np.random.default_rng(warm_steps), warm_steps)
    cfg = AdamWConfig(warmup_steps=3, total_steps=20, weight_decay=0.1)
    jp2, js2, jm = jopt.adamw_update(jp, jg, js, jcfg)
    tp2, ts2, tm = adamw_update(tp, tg, ts, cfg)
    assert int(ts2["count"]) == int(js2["count"]) == warm_steps + 1
    assert ts2["count"].dtype == torch.int32
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    # 1e-6 of each leaf's largest entry besides 1e-6 of each entry: an
    # entry such as b1·m + (1 - b1)·g that cancels keeps the rounding of
    # its terms (the reference's compiler may fuse a multiply and an add)
    for key in ("m", "v", "master"):
        for got, want in zip(tree_leaves(ts2[key]), jax.tree.leaves(js2[key])):
            want = _np(want)
            np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=key)
    for got, want in zip(tree_leaves(tp2), jax.tree.leaves(jp2)):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16 else torch.float32)
        rtol = 2**-8 if want.dtype == jnp.bfloat16 else 1e-6
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=1e-6 * np.abs(want).max())
    # the parameters are the master cast to their dtype, updated in place
    assert tp2 is tp and all(torch.equal(p, w.to(p.dtype))
                             for p, w in zip(tree_leaves(tp2), tree_leaves(ts2["master"])))


def test_adamw_carries_error_feedback_and_clips():
    (_, _, _, _), (tp, tg, ts) = _state_pair(np.random.default_rng(1), 0)
    ts["ef"] = {"marker": torch.ones(2)}
    _, out, metrics = adamw_update(tp, tg, ts, AdamWConfig(clip_norm=1e-3))
    assert out["ef"] is ts["ef"]
    assert float(metrics["grad_norm"]) == pytest.approx(float(global_norm(tg)))


def test_int8_and_topk_equal_the_references():
    rng = np.random.default_rng(0)
    for scale in (1e-4, 1.0, 1e3):
        g = (rng.normal(size=(257,)) * scale).astype(np.float32)
        g[:3] = [0.5 * scale, -1.5 * scale, 2.5 * scale]  # halves: round to even in both
        q, s = compression.int8_compress(torch.from_numpy(g))
        jq, js = jcomp.int8_compress(jnp.asarray(g))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        assert np.array_equal(compression.int8_decompress(q, s).numpy(),
                              np.asarray(jcomp.int8_decompress(jq, js)))
        for frac in (0.01, 0.1, 0.5):
            got = compression.topk_mask(torch.from_numpy(g), frac)
            assert np.array_equal(got.numpy(), np.asarray(jcomp.topk_mask(jnp.asarray(g), frac)))
    zeros = compression.int8_compress(torch.zeros(8))[0]
    assert not zeros.any()
    masked = compression.topk_mask(torch.arange(100, dtype=torch.float32), frac=0.1)
    assert set(torch.nonzero(masked).flatten().tolist()) == set(range(90, 100))


@pytest.mark.parametrize("kind", ["int8_ef", "topk_ef"])
def test_compression_apply_equals_the_reference_and_telescopes(kind):
    """Three steps of error feedback on the same gradients give the
    reference's sent gradients and residuals exactly; over 20 steps
    Σ sent + e_T = Σ g (tests/test_train.py:94)."""
    rng = np.random.default_rng(0)
    jstate, tstate = {}, {}
    total_sent, total_g = np.zeros(32), np.zeros(32)
    for t in range(20):
        g = {"w": rng.normal(size=(32,)).astype(np.float32),
             "b": {"x": rng.normal(size=(4, 6)).astype(np.float32)}}
        sent, tstate = compression.apply(kind, tree_map(torch.from_numpy, g), tstate)
        if t < 3:
            jsent, jstate = jcomp.apply(kind, jax.tree.map(jnp.asarray, g), jstate, POL)
            for a, b in zip(tree_leaves(sent), jax.tree.leaves(jsent)):
                assert np.array_equal(a.numpy(), np.asarray(b))
            for a, b in zip(tree_leaves(tstate["ef"]), jax.tree.leaves(jstate["ef"])):
                assert np.array_equal(a.numpy(), np.asarray(b))
        total_sent += sent["w"].numpy()
        total_g += g["w"]
    np.testing.assert_allclose(total_sent + tstate["ef"]["w"].numpy(), total_g,
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        compression.apply("nope", {"w": torch.zeros(2)}, {})


# ---------------------------------------------------------------------------
# the training route's layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("sq,skv,kv_chunk", [(45, 45, 16), (24, 24, 1024), (8, 20, 6)])
def test_blocked_attention_matches(window, sq, skv, kv_chunk):
    """Causal and windowed GQA, with a chunk that does not divide Skv
    (45 → 15; 20 → 5), float32, and the gradient of a weighted sum."""
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, sq, 4, 16), (2, skv, 2, 16), (2, skv, 2, 16)))
    causal = sq == skv
    want = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                window=window, kv_chunk=kv_chunk)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = L.blocked_attention(tq, tk, tv, causal=causal, window=window, kv_chunk=kv_chunk)
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= 1e-5
    w = rng.normal(size=got.shape).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(JL.blocked_attention(
        *a, causal=causal, window=window, kv_chunk=kv_chunk) * w), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    (got * torch.from_numpy(w)).sum().backward()
    for t, j in zip((tq, tk, tv), jgrads):
        assert np.abs(t.grad.numpy() - np.asarray(j)).max() <= 1e-5


def test_training_scans_match_the_references():
    """``ssd_chunked`` against ``_ssd_chunked_jnp`` and the port's plain
    ``ssd_chunked`` (two chunks and one), ``rglru_trace`` against
    ``rglru_ref``, float32."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 4, 8)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, size=(2, 32, 4)).astype(np.float32)
    b, c = (rng.normal(size=(2, 32, 2, 6)).astype(np.float32) for _ in range(2))
    for chunk in (16, 128):
        want = np.asarray(jops._ssd_chunked_jnp(*map(jnp.asarray, (x, a, b, c)), chunk=chunk))
        got = L.ssd_chunked(*map(torch.from_numpy, (x, a, b, c)), chunk=chunk).numpy()
        plain = ops.ssd(*map(torch.from_numpy, (x, a, b, c)), chunk=chunk).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        L.ssd_chunked(*map(torch.from_numpy, (x, a, b, c)), chunk=12)
    ra = rng.uniform(0.0, 1.0, size=(3, 40, 8)).astype(np.float32)
    rb = rng.normal(size=(3, 40, 8)).astype(np.float32)
    # the same steps in the same order; the reference's compiler fuses
    # a·h + b into one rounding
    np.testing.assert_allclose(L.rglru_trace(torch.from_numpy(ra), torch.from_numpy(rb)).numpy(),
                               np.asarray(jref.rglru_ref(jnp.asarray(ra), jnp.asarray(rb))),
                               rtol=1e-6, atol=1e-6)


def test_training_route_calls_no_kernel(monkeypatch):
    """The training forward never reaches the kernel dispatch, whatever
    the grad mode; the serving path still does."""
    called = []
    for name in ("attention", "ssd", "rglru"):
        monkeypatch.setattr(ops, name, lambda *a, _n=name, **k: called.append(_n) or 1 / 0)
    for arch in ("recurrentgemma-9b", "mamba2-1.3b"):
        cfg = ARCHS[arch].reduced()
        params = lm.init_params(cfg, 0, device=CPU)
        toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            loss = lm.loss_fn(params, {"tokens": toks, "labels": toks}, cfg)
        assert torch.isfinite(loss)
        with pytest.raises(ZeroDivisionError):
            lm.prefill(params, {"tokens": toks}, cfg)
    assert set(called) == {"rglru", "ssd"}
    with pytest.raises(ValueError, match="training route"):
        L.rglru_block(torch.zeros(1, 4, 128), params["seg0"], cfg, train=True, return_state=True)


def test_abstract_params_are_the_references_shapes():
    for arch in TRAINED:
        jc, pc = _cfgs(arch)
        want = jax.tree.leaves(jlm.abstract_params(jc, POL))
        got = tree_leaves(lm.abstract_params(pc))
        assert [tuple(t.shape) for t in got] == [w.shape for w in want]
        assert all(t.device.type == "meta" for t in got)
        assert [str(t.dtype).split(".")[1] for t in got] == [str(w.dtype) for w in want]


# ---------------------------------------------------------------------------
# loss, gradients, train step
# ---------------------------------------------------------------------------


def _grads(jc, pc, jp, tp, n_mb: int = 1):
    jb, tb = _batches(jc, pc, 0)
    jl, jg = jax.jit(jts.make_grad_fn(jc, POL, n_mb))(jp, jb)
    tl, tg = make_grad_fn(pc, n_mb)(tp, tb)
    return (float(jl), jax.tree.leaves(jg)), (float(tl), tree_leaves(tg))


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_grads_match_float32(arch, f32_compute):
    jc, pc = _cfgs(arch)
    (jl, jg), (tl, tg) = _grads(jc, pc, *_params(jc, pc, f32=True))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert len(tg) == len(jg)
    for i, (t, j) in enumerate(zip(tg, jg)):
        j = _np(j)
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        bound = 1e-4 * np.abs(j).max() + 1e-6
        assert np.abs(t.numpy() - j).max() <= bound, f"leaf {i} {j.shape}"


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_grads_match_bf16(arch):
    jc, pc = _cfgs(arch)
    (jl, jg), (tl, tg) = _grads(jc, pc, *_params(jc, pc))
    assert abs(tl - jl) <= 2e-2 * abs(jl)
    for i, (t, j) in enumerate(zip(tg, jg)):
        assert t.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[j.dtype.type]
        t, j = _np(t).ravel().astype(np.float64), _np(j).ravel().astype(np.float64)
        cos = t @ j / max(np.linalg.norm(t) * np.linalg.norm(j), 1e-300)
        assert cos >= 0.99, f"leaf {i}: cosine {cos}"


def test_microbatch_equivalence():
    """Grad accumulation over microbatches == one big batch
    (tests/test_train.py:54), and the accumulated gradients are float32."""
    cfg = ARCHS["deepseek-7b"].reduced()
    params = lm.init_params(cfg, 0, device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in data.SyntheticLM(
        cfg, data.DataConfig(seq_len=64, global_batch=4))(0).items()}
    l1, g1 = make_grad_fn(cfg, 1)(params, batch)
    l2, g2 = make_grad_fn(cfg, 2)(params, batch)
    assert abs(float(l1) - float(l2)) < 5e-3
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(_np(a), _np(b), rtol=3e-2, atol=3e-3)
    assert all(not p.requires_grad for p in tree_leaves(params))


@pytest.mark.parametrize("arch,compression_kind", [("deepseek-7b", "none"),
                                                   ("phi4-mini-3.8b", "int8_ef")])
def test_three_step_trajectory_matches(arch, compression_kind, f32_compute):
    """Three steps of the train step (2 microbatches) from the same params
    and batches under float32 compute: each step's loss within 1e-4
    relative; after step 1 the params where |g_ref| > 1e-4·max|g_ref|
    (Adam's first step is about lr·sign(g), so entries at the noise floor
    may move the other way)."""
    jc, pc = _cfgs(arch)
    jp, tp = _params(jc, pc, f32=True)
    (_, jg0), _ = _grads(jc, pc, jp, tp, 2)
    jcfg = jts.TrainStepConfig(n_microbatches=2, compression=compression_kind,
                               adamw=jopt.AdamWConfig(warmup_steps=2, total_steps=50))
    tcfg = TrainStepConfig(n_microbatches=2, compression=compression_kind,
                           adamw=AdamWConfig(warmup_steps=2, total_steps=50))
    jstep = jax.jit(jts.make_train_step(jc, POL, jcfg))
    tstep = make_train_step(pc, tcfg)
    js, ts = jopt.init_opt_state(jp), init_opt_state(tp)
    for i in range(3):
        jb, tb = _batches(jc, pc, i)
        jl, jp, js, _ = jstep(jp, js, jb)
        tl, tp, ts, metrics = tstep(tp, ts, tb)
        assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl)), f"step {i + 1}"
        assert float(metrics["loss"]) == float(tl)
        if i == 0:
            for t, j, g in zip(tree_leaves(tp), jax.tree.leaves(jp), jg0):
                g = np.abs(_np(g))
                keep = g > 1e-4 * g.max()
                np.testing.assert_allclose(_np(t)[keep], _np(j)[keep], rtol=1e-5, atol=1e-7)
    assert int(ts["count"]) == 3 and ("ef" in ts) == (compression_kind != "none")


def _supervised(tmp, step, data_fn, cfg, hook=None, n=10):
    params = lm.init_params(cfg, 0, device=CPU)
    sup = Supervisor(step, params, init_opt_state(params), data_fn,
                     SupervisorConfig(ckpt_dir=str(tmp), ckpt_every=2), failure_hook=hook)
    return sup, sup.run(n)


def test_supervisor_trains_and_replays_bit_equal(tmp_path):
    """The port's step under the port's Supervisor: the loss falls within
    10 steps; a failure injected at step 3 rolls back to step 2 and the
    final params and state equal a failure-free run's bit for bit."""
    cfg = ARCHS["deepseek-7b"].reduced()
    dl = data.SyntheticLM(cfg, data.DataConfig(seq_len=SEQ, global_batch=4))
    data_fn = lambda s: {k: torch.from_numpy(v) for k, v in dl(s).items()}
    step = make_train_step(cfg, TrainStepConfig(adamw=AdamWConfig(warmup_steps=2,
                                                                  total_steps=50)))
    ok, hist = _supervised(tmp_path / "ok", step, data_fn, cfg)
    losses = [h.loss for h in hist]
    assert min(losses[5:]) < losses[0]
    fired = []

    def bomb(s):
        if s == 3 and not fired:
            fired.append(s)
            raise RuntimeError("injected node failure")

    bad, hist = _supervised(tmp_path / "bad", step, data_fn, cfg, hook=bomb)
    assert fired and any(h.restarted for h in hist) and hist[-1].step == 10
    for a, b in zip(tree_leaves(ok.params), tree_leaves(bad.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(ok.opt_state), tree_leaves(bad.opt_state)):
        assert torch.equal(a, b)


def test_reference_checkpoint_resumes_in_the_port(tmp_path, f32_compute):
    """The reference trains 2 steps and checkpoints; the port restores the
    checkpoint into its own structures and its step 3 gives the
    reference's step-3 loss (float32 compute, bf16 params as saved)."""
    from repro.train import checkpoint as jck

    jc, pc = _cfgs("deepseek-7b")
    jp, tp = _params(jc, pc)
    jcfg = jts.TrainStepConfig(n_microbatches=2, adamw=jopt.AdamWConfig(warmup_steps=2,
                                                                        total_steps=50))
    jstep = jax.jit(jts.make_train_step(jc, POL, jcfg))
    js = jopt.init_opt_state(jp)
    for i in range(2):
        _, jp, js, _ = jstep(jp, js, _batches(jc, pc, i)[0])
    jck.save(str(tmp_path), 2, jp, js)
    jl3 = float(jstep(jp, js, _batches(jc, pc, 2)[0])[0])

    like = lm.init_params(pc, 9, device=CPU)
    params, opt, manifest = ck.restore(str(tmp_path), 2, like, init_opt_state(like))
    assert manifest["step"] == 2 and int(opt["count"]) == 2
    step = make_train_step(pc, TrainStepConfig(n_microbatches=2, adamw=AdamWConfig(
        warmup_steps=2, total_steps=50)))
    tl3 = float(step(params, opt, _batches(jc, pc, 2)[1])[0])
    assert abs(tl3 - jl3) <= 1e-5 * abs(jl3)


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launcher

    argv = ["--arch", "deepseek-7b", "--reduced", "--steps", "4", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    hist = launcher.main(argv)
    assert [h.step for h in hist] == [1, 2, 3, 4]
    assert ck.latest_step(str(tmp_path), intact_only=True) == 4
    hist = launcher.main(argv + ["--resume"])
    assert [h.step for h in hist] == [5, 6, 7, 8]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=deepseek-7b params=") and out[0].endswith("devices=1")
    assert "resumed from step 4" in out
    assert out[-1].startswith("steps 5..8: loss ") and "restarts=0" in out[-1]


def test_grad_leaves_are_the_params_and_none_is_missing():
    """Every parameter gets a gradient, the same shape and dtype (one
    microbatch), and on the recurrent configs none is all zero."""
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        cfg = ARCHS[arch].reduced()
        params = lm.init_params(cfg, 1, device=CPU)
        toks = torch.from_numpy(data.SyntheticLM(cfg, data.DataConfig(seq_len=SEQ,
                                                                       global_batch=2))(0)["tokens"])
        _, grads = make_grad_fn(cfg, 1)(params, {"tokens": toks, "labels": toks})
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            assert g is not None and g.shape == p.shape and g.dtype == p.dtype
            assert bool(g.abs().sum() > 0)
