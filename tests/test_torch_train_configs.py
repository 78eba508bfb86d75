"""The port's training route against the JAX package's on the CPU for the
configs and windows ``tests/test_torch_train.py`` never reaches, and the
model-FLOP count of ``chip_smoke.py``'s training paths.

``tests/test_torch_train.py`` trains ``reduced()`` configs at 32 tokens,
so three blind spots stay open there: ``reduced()`` makes qwen2.5-14b,
yi-34b and mixtral-8x22b MHA, ``init_params`` makes the q/k/v biases and
the norm scales zero, and the reduced windows (64) never bite at 32
tokens.  Here qwen2.5, yi and mixtral run with ``tests/test_torch_lm.py``'s
``HEADS`` (groups 5, 7 and 6) and every config with its zero-initialised
leaves made ``0.1 · normal`` (that file's ``_params``); mixtral and
recurrentgemma also run at 128 tokens, past their windows.  Each case
carries a planted fault that the float32 bound must catch.

Tolerances (``tests/test_torch_train.py``'s).  float32 compute and float32
parameters: loss within 1e-5 relative, each gradient leaf within
1e-4·max|g_ref| + 1e-6.  bf16 compute: loss within 2e-2 relative, each
gradient leaf's cosine with the reference's at least 0.99.  The three-step
trajectory under float32 compute: each step's loss within 1e-4 relative,
the params after step 1 within 1e-5 relative where |g_ref| > 1e-4·max|g_ref|.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.models import layers as JL
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import ARCHS
from repro_torch.models import layers as L
from repro_torch.train import (
    AdamWConfig,
    TrainStepConfig,
    init_opt_state,
    make_grad_fn,
    make_train_step,
)
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.optimizer import tree_leaves, tree_map
from tests import test_torch_lm as tlm
from tests.test_torch_train import POL, _batches, _np

ROUTER = ("seg0", "mlp0", "router")
# (arch, tokens): GQA groups 5, 7 and 6 at the training tests' 32 tokens;
# mixtral (swa) and recurrentgemma (local) also at 128, past their reduced
# windows of 64.  Each with its planted fault: (what, a context the port's
# gradients are taken in, or the path of the gradient zeroed after)
CASES = {
    ("qwen2.5-14b", 32): chip_smoke.TRAIN_FAULTS["qwen2.5-14b"],
    ("yi-34b", 32): chip_smoke.TRAIN_FAULTS["yi-34b"],
    ("mixtral-8x22b", 32): chip_smoke.TRAIN_FAULTS["mixtral-8x22b"],
    ("mixtral-8x22b", 128): ("the swa layers' window dropped",
                             lambda: chip_smoke.attention_changed(window=None), None),
    ("recurrentgemma-9b", 128): chip_smoke.TRAIN_FAULTS["recurrentgemma-9b"],
}
TRAJECTORY = ["qwen3-moe-30b-a3b", "mixtral-8x22b"]


@contextlib.contextmanager
def _compute(f32: bool):
    """Both packages' matmul dtype: float32, or bf16 (their default)."""
    saved = JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE
    if f32:
        JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        JL.COMPUTE_DTYPE, L.COMPUTE_DTYPE = saved


def _params(arch: str, f32: bool):
    """The reduced configs (``HEADS``'s groups) and both packages'
    parameters from one tree, every zero-initialised leaf non-zero;
    ``f32``: every leaf in float32 in both."""
    jc, pc = tlm._cfgs(arch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlm, "NONZERO", (jc.name,))
        jp, tp = tlm._params(jc, pc)
    if f32:
        jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
        tp = tree_map(lambda x: x.float(), tp)
    return jc, pc, jp, tp


def _batch_of(jc, pc, step: int, seq: int):
    return _batches(jc, pc, step, batch=4 if seq == 32 else 2, seq=seq)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, seq: int, f32: bool):
    """The reference's loss and gradient leaves of batch 0 (one
    microbatch), and the port's inputs."""
    jc, pc, jp, tp = _params(arch, f32)
    jb, tb = _batch_of(jc, pc, 0, seq)
    with _compute(f32):
        jl, jg = jax.jit(jts.make_grad_fn(jc, POL, 1))(jp, jb)
    return (float(jl), [_np(g) for g in jax.tree.leaves(jg)]), (pc, tp, tb)


def _port(arch: str, seq: int, f32: bool, fault=None):
    """The port's loss and gradient leaves on the reference's inputs,
    with ``fault`` (one of ``CASES``' values) planted."""
    _, (pc, tp, tb) = _reference(arch, seq, f32)
    _, ctx, zeroed = fault or (None, None, None)
    with _compute(f32), ctx() if ctx else contextlib.nullcontext():
        tl, tg = make_grad_fn(pc, 1)(tp, tb)
    if zeroed:
        chip_smoke._zero_grad(tg, zeroed)
    return float(tl), tree_leaves(tg)


def _f32_excess(port, ref) -> float:
    """The largest excess over the float32 bounds (> 0: outside them)."""
    (tl, tg), (jl, jg) = port, ref
    assert len(tg) == len(jg)
    excess = [abs(tl - jl) - 1e-5 * abs(jl)]
    for t, j in zip(tg, jg):
        assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
        excess.append(float(np.abs(t.numpy() - j).max()) - (1e-4 * np.abs(j).max() + 1e-6))
    return max(excess)


@pytest.mark.parametrize("arch,seq", list(CASES))
def test_loss_and_grads_match_float32(arch, seq):
    ref, _ = _reference(arch, seq, True)
    assert _f32_excess(_port(arch, seq, True), ref) <= 0


@pytest.mark.parametrize("arch,seq", list(CASES))
def test_planted_fault_fails_the_float32_bound(arch, seq):
    ref, _ = _reference(arch, seq, True)
    fault = CASES[arch, seq]
    assert _f32_excess(_port(arch, seq, True, fault), ref) > 0, f"{fault[0]}: unseen"


@pytest.mark.parametrize("arch,seq", list(CASES))
def test_loss_and_grads_match_bf16(arch, seq):
    (jl, jg), _ = _reference(arch, seq, False)
    tl, tg = _port(arch, seq, False)
    assert abs(tl - jl) <= 2e-2 * abs(jl)
    for i, (t, j) in enumerate(zip(tg, jg)):
        t, j = _np(t).ravel().astype(np.float64), j.ravel().astype(np.float64)
        cos = t @ j / max(np.linalg.norm(t) * np.linalg.norm(j), 1e-300)
        assert cos >= 0.99, f"leaf {i}: cosine {cos}"


def _step_cfgs():
    adamw = dict(warmup_steps=2, total_steps=50)
    return (jts.TrainStepConfig(n_microbatches=2, adamw=jopt.AdamWConfig(**adamw)),
            TrainStepConfig(n_microbatches=2, adamw=AdamWConfig(**adamw)))


@functools.lru_cache(maxsize=None)
def _reference_trajectory(arch: str):
    """Three reference steps (2 microbatches, float32 compute): each
    step's loss, the params after step 1 and |step-1 gradients| (batch 0's
    in one microbatch: the same mean)."""
    jc, pc, jp, _ = _params(arch, True)
    (_, jg0), _ = _reference(arch, 32, True)
    with _compute(True):
        jstep = jax.jit(jts.make_train_step(jc, POL, _step_cfgs()[0]))
        js, losses = jopt.init_opt_state(jp), []
        for i in range(3):
            jl, jp, js, _ = jstep(jp, js, _batch_of(jc, pc, i, 32)[0])
            losses.append(float(jl))
            if i == 0:
                after1 = [_np(x) for x in jax.tree.leaves(jp)]
    return losses, after1, [np.abs(g) for g in jg0]


def _trajectory_faults(arch: str, zeroed=None) -> list[str]:
    """The port's three steps against the reference's: what falls outside
    the bounds; with ``zeroed``, that gradient zeroed before every update."""
    jc, pc, _, tp = _params(arch, True)
    losses, after1, g0 = _reference_trajectory(arch)
    real, bad = train_step_mod.adamw_update, []

    def update(params, grads, opt_state, cfg):
        chip_smoke._zero_grad(grads, zeroed)
        return real(params, grads, opt_state, cfg)

    with pytest.MonkeyPatch.context() as mp, _compute(True):
        if zeroed:
            mp.setattr(train_step_mod, "adamw_update", update)
        step, ts = make_train_step(pc, _step_cfgs()[1]), init_opt_state(tp)
        for i in range(3):
            tl, tp, ts, metrics = step(tp, ts, _batch_of(jc, pc, i, 32)[1])
            if abs(float(tl) - losses[i]) > 1e-4 * abs(losses[i]):
                bad.append(f"step {i + 1} loss {float(tl)} vs {losses[i]}")
            assert float(metrics["loss"]) == float(tl)
            if i == 0:
                for n, (t, j, g) in enumerate(zip(tree_leaves(tp), after1, g0)):
                    keep = g > 1e-4 * g.max()
                    if not np.allclose(_np(t)[keep], j[keep], rtol=1e-5, atol=1e-7):
                        bad.append(f"leaf {n} after step 1")
    assert int(ts["count"]) == 3
    return bad


@pytest.mark.parametrize("arch", TRAJECTORY)
def test_three_step_trajectory_matches(arch):
    assert _trajectory_faults(arch) == []


@pytest.mark.parametrize("arch", TRAJECTORY)
def test_trajectory_with_the_router_gradient_zeroed_fails(arch):
    assert _trajectory_faults(arch, ROUTER), "the router's gradient zeroed: unseen"


# ---------------------------------------------------------------------------
# chip_smoke.py's model-FLOP count of a train step
# ---------------------------------------------------------------------------

B, S = 2, 128
D, VP = 128, 2048  # the reduced width and padded vocabulary (512 → 2,048)
HEAD = 128  # reduced q heads · head_dim: 4 · 32
OUT = D * VP + D  # unembed and final_norm (the embedding is a lookup)
FULL_PAIRS = S * (S + 1) // 2  # a causal layer's (query, key) pairs
WINDOW_PAIRS = 64 * 65 // 2 + (S - 64) * 64  # causal, window 64
EXPERTS = 3 * 8 * D * 256 * 2 // 8  # w_in, w_gate, w_out of 8 experts, top-2
# a layer's weights that multiply every position
QWEN3_LAYER = 4 * D * HEAD + 2 * 32 + 2 * D + D * 8  # q/k/v/o, QK-norm, ln1/ln2, router
MIXTRAL_LAYER = 4 * D * HEAD + 2 * D + D * 8
RGLRU = 5 * D * D + 4 * D + D  # wx, wg, both gates, wo; conv taps; lam
LOCAL = 2 * D * HEAD + 2 * D * 32  # wq, wo; wk, wv of one KV head
MLP = 3 * D * 256
HAND = {
    "qwen3-moe-30b-a3b": (6 * B * S * (4 * QWEN3_LAYER + OUT + 4 * EXPERTS),
                          12 * B * 4 * FULL_PAIRS * HEAD),
    "mixtral-8x22b": (6 * B * S * (4 * MIXTRAL_LAYER + OUT + 4 * EXPERTS),
                      12 * B * 4 * WINDOW_PAIRS * HEAD),
    "recurrentgemma-9b": (6 * B * S * (3 * RGLRU + LOCAL + 4 * MLP + 4 * 2 * D + OUT),
                          12 * B * WINDOW_PAIRS * HEAD),
}


@pytest.mark.parametrize("arch", list(HAND))
def test_model_flops_are_the_hand_count(arch):
    """The experts at top_k / n_experts of their weights (the router
    whole), each attention layer at the (query, key) pairs its mask keeps."""
    got = chip_smoke._model_flops(ARCHS[arch].reduced(), B, S)
    assert (got["weights"], got["attention"]) == HAND[arch]


@pytest.mark.parametrize("arch,layers", [("phi4-mini-3.8b", 8), ("mamba2-1.3b", 24)])
def test_model_flops_of_phi4_and_mamba2_keep_their_count(arch, layers):
    """phase ``train``'s (a) and (b) at their cut: the count before the
    experts and windows were counted (6 · every weight but the embedding ·
    positions + 6 · B · S² · Hq · hd an attention layer) plus the causal
    diagonal's S pairs a head and layer, which that count's S²/2 left out
    (phi4 has no expert or window; mamba2 no attention)."""
    cfg, b, s = chip_smoke._depth_cut(arch, layers), 4, 1024
    sizes = chip_smoke._train_sizes(cfg)
    weights = sizes["params"] - (0 if cfg.tie_embeddings else sizes["embed_params"])
    n_attn = sum(m in ("full", "swa", "local") for m in cfg.layer_pattern)
    before = 6 * weights * b * s + 6 * b * s**2 * cfg.n_heads * cfg.head_dim * n_attn
    diagonal = 6 * b * s * cfg.n_heads * cfg.head_dim * n_attn
    assert chip_smoke._model_flops(cfg, b, s)["total"] == before + diagonal
