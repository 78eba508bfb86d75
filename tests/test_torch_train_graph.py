"""The port's compiled train step (``repro_torch.train.CompiledTrainStep``,
the counterpart of the reference's ``jax.jit`` of the step) on the CPU.

On the CPU the step runs eagerly, through the same static state the card
replays a CUDA graph over: the first call's parameter, moment, master,
count and residual tensors, updated in place, and one set of batch buffers
per batch shape.  So the failure a graph would hide — state advanced into
new tensors that a replay never reads (a ``count`` frozen at step 2 would
freeze the learning rate) — shows here as a trajectory that leaves the
plain step's.  The replay itself is held to eager runs on the card
(``tests/test_torch_cuda.py -k replayed_train``).

Tolerances.  Against ``make_train_step`` called plainly: bit for bit (the
same arithmetic on the same tensors).  Against the reference's
``make_train_step`` under float32 compute (one case: each jit of the
reference costs seconds), ``tests/test_torch_train.py``'s bounds: each step's loss within 1e-4 relative, its learning rate within
1e-6, and the params after step 1 within 1e-5 relative where |g| >
1e-4·max|g| (the port's step-1 gradient, which the CPU tests hold to the
reference's within 1e-4·max|g_ref|).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import data
from repro_torch.configs import ARCHS
from repro_torch.models import lm
from repro_torch.train import (
    AdamWConfig,
    Supervisor,
    SupervisorConfig,
    TrainStepConfig,
    init_opt_state,
    make_grad_fn,
    make_train_step,
)
from repro_torch.train import checkpoint as ck
from repro_torch.train import train_step as train_step_mod
from repro_torch.train.train_step import CompiledTrainStep, compile_train_step
from repro_torch.train.optimizer import tree_leaves, tree_map
from tests.test_torch_train import POL, _batches, _cfgs, _np, _params, f32_compute  # noqa: F401

CPU = "cpu"
STEPS = 4


def _ts(n_mb: int, kind: str = "none") -> TrainStepConfig:
    # one warmup step and 4 in all: the rate changes at every step
    return TrainStepConfig(n_microbatches=n_mb, compression=kind,
                           adamw=AdamWConfig(warmup_steps=1, total_steps=STEPS))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _state(opt: dict) -> list[torch.Tensor]:
    return [opt["count"], *(leaf for key in ("m", "v", "master", "ef") if key in opt
                            for leaf in tree_leaves(opt[key]))]


@pytest.mark.parametrize("arch,n_mb,kind,ref", [("phi4-mini-3.8b", 1, "int8_ef", True),
                                                ("qwen3-moe-30b-a3b", 2, "none", False)])
def test_compiled_step_equals_plain_and_reference(arch, n_mb, kind, ref, f32_compute):
    """4 steps: the compiled step's losses, learning rates, parameters and
    every state leaf equal the plain step's bit for bit at every step; with
    ``ref``, also the reference's losses and rates within the bounds above
    (its params after step 1 too).  Without it the reference is reached
    through the plain step, which ``tests/test_torch_train.py`` holds to it
    over microbatches."""
    jc, pc = _cfgs(arch)
    if ref:
        jp, tp = _params(jc, pc, f32=True)
        _, g0 = make_grad_fn(pc, n_mb)(tp, _batches(jc, pc, 0)[1])  # the step-1 mask's
        jcfg = jts.TrainStepConfig(n_microbatches=n_mb, compression=kind,
                                   adamw=jopt.AdamWConfig(warmup_steps=1, total_steps=STEPS))
        jstep = jax.jit(jts.make_train_step(jc, POL, jcfg))
        js = jopt.init_opt_state(jp)
    else:
        tp = tree_map(lambda t: t.float(), lm.init_params(pc, 0, device=CPU))
    plain, compiled = make_train_step(pc, _ts(n_mb, kind)), CompiledTrainStep(
        pc, _ts(n_mb, kind), device=CPU)
    pp, ps = _clone(tp), init_opt_state(tp)
    cp, cs = tp, init_opt_state(tp)
    lrs = []
    for i in range(STEPS):
        jb, tb = _batches(jc, pc, i)
        pl, pp, ps, pm = plain(pp, ps, tb)
        cl, cp, cs, cm = compiled(cp, cs, tb)
        assert torch.equal(cl, pl) and torch.equal(cm["lr"], pm["lr"]), f"step {i + 1}"
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cp), tree_leaves(pp)))
        assert all(torch.equal(a, b) for a, b in zip(_state(cs), _state(ps)))
        lrs.append(float(cm["lr"]))
        if not ref:
            continue
        jl, jp, js, jm = jstep(jp, js, jb)
        assert abs(float(cl) - float(jl)) <= 1e-4 * abs(float(jl)), f"step {i + 1}"
        np.testing.assert_allclose(float(cm["lr"]), float(jm["lr"]), rtol=1e-6)
        if i == 0:
            for t, j, g in zip(tree_leaves(cp), jax.tree.leaves(jp), tree_leaves(g0)):
                g = np.abs(_np(g))
                keep = g > 1e-4 * g.max()
                np.testing.assert_allclose(_np(t)[keep], _np(j)[keep], rtol=1e-5, atol=1e-7)
    assert len(set(lrs)) == STEPS  # a frozen count would repeat a rate
    assert int(cs["count"]) == STEPS and ("ef" in cs) == (kind != "none")
    assert cp is tp and len(compiled.runs) == 1  # the first call's tensors, one batch shape


def _data_fn(cfg, seq: int = 32, batch: int = 4):
    dl = data.SyntheticLM(cfg, data.DataConfig(seq_len=seq, global_batch=batch))
    return lambda s: {k: torch.from_numpy(v) for k, v in dl(s).items()}


def test_rollback_through_the_compiled_step_equals_the_failure_free_run(tmp_path):
    """A failure injected at step 3 rolls the ``Supervisor`` back to its
    step-2 checkpoint; the restored tensors are copied into the compiled
    step's static ones, and the 6 steps end bit-equal to a failure-free
    plain run (int8 residuals included).  The step-2 checkpoint holds step
    2's state, though the step rewrote those tensors in place afterwards
    (``save_async`` snapshots on the caller's thread)."""
    cfg = ARCHS["phi4-mini-3.8b"].reduced()
    ts = TrainStepConfig(compression="int8_ef",
                         adamw=AdamWConfig(warmup_steps=1, total_steps=6))
    data_fn = _data_fn(cfg)
    fired = []

    def bomb(s):
        if s == 3 and not fired:
            fired.append(s)
            raise RuntimeError("injected node failure")

    def supervisor(name, step, hook=None):
        params = lm.init_params(cfg, 0, device=CPU)
        opt = init_opt_state(params)
        opt["ef"] = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return Supervisor(step, params, opt, data_fn,
                          SupervisorConfig(ckpt_dir=str(tmp_path / name), ckpt_every=2),
                          failure_hook=hook)

    ok = supervisor("plain", make_train_step(cfg, ts))
    ok.run(2)
    state2 = _clone({"params": ok.params, "opt": ok.opt_state})
    ok_hist = ok.run(4)
    bad = supervisor("compiled", compile_train_step(cfg, ts, device=CPU), bomb)
    bad_hist = bad.run(6)
    assert isinstance(bad.train_step, CompiledTrainStep)
    assert fired and any(h.restarted for h in bad_hist) and bad_hist[-1].step == 6
    assert [h.loss for h in bad_hist[-3:]] == [h.loss for h in ok_hist[-3:]]
    for a, b in zip(tree_leaves(ok.params), tree_leaves(bad.params)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(_state(ok.opt_state), _state(bad.opt_state)))
    assert bad.params is bad.train_step.params  # the static tensors, not the restored ones
    params2, opt2, manifest = ck.restore(str(tmp_path / "compiled"), 2, bad.params,
                                         bad.opt_state)
    assert manifest["step"] == 2 and int(opt2["count"]) == 2
    for a, b in zip(tree_leaves(params2) + _state(opt2),
                    tree_leaves(state2["params"]) + _state(state2["opt"])):
        assert torch.equal(a, b)


def test_each_batch_shape_gets_its_own_buffers():
    """Batches of two shapes, A B A: two sets of static buffers, and the
    three steps equal the plain step's bit for bit."""
    cfg = ARCHS["deepseek-7b"].reduced()
    ts = _ts(1)
    compiled, plain = CompiledTrainStep(cfg, ts, device=CPU), make_train_step(cfg, ts)
    params = lm.init_params(cfg, 0, device=CPU)
    cp, cs = params, init_opt_state(params)
    pp = _clone(params)
    ps = init_opt_state(pp)
    shapes = [_data_fn(cfg, 32, 4)(0), _data_fn(cfg, 16, 2)(1), _data_fn(cfg, 32, 4)(2)]
    for batch in shapes:
        cl, cp, cs, _ = compiled(cp, cs, batch)
        pl, pp, ps, _ = plain(pp, ps, batch)
        assert torch.equal(cl, pl)
    assert len(compiled.runs) == 2
    bufs = [b for b, _ in compiled.runs.values()]
    assert {tuple(b["tokens"].shape) for b in bufs} == {(4, 32), (2, 16)}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cp), tree_leaves(pp)))


def test_graph_switch_and_stale_state_raise(monkeypatch):
    """``graph=True`` on the CPU raises ``ValueError``, as every engine's
    switch does; so does a step that returns state in new tensors (the
    optimizer before its count advanced in place), which a replay would
    never read; under a mesh ``compile_train_step`` refuses a graph."""
    cfg = ARCHS["deepseek-7b"].reduced()
    with pytest.raises(ValueError, match="graph=True"):
        CompiledTrainStep(cfg, device=CPU, graph=True)
    assert CompiledTrainStep(cfg, device=CPU).graph is False
    real = train_step_mod.adamw_update

    def new_count(params, grads, opt_state, cfg_):
        return real(params, grads, {**opt_state, "count": opt_state["count"].clone()}, cfg_)

    monkeypatch.setattr(train_step_mod, "adamw_update", new_count)
    params = lm.init_params(cfg, 0, device=CPU)
    with pytest.raises(ValueError, match="stale state"):
        CompiledTrainStep(cfg, _ts(1), device=CPU)(params, init_opt_state(params),
                                                   _data_fn(cfg)(0))
