"""Traffic kind ``serve_offline``: an offline queue that is always full,
served greedily through ``repro_torch.serve.ServeEngine.generate_continuous``.

Each call hands the engine ``requests`` prompts (:mod:`cellbench.prompts`:
the same lengths every call, in an order drawn from the seed, uniform
tokens) and asks ``new_tokens`` of each; calls run back to back.
``serve_tok_s`` is every token the window's calls returned over the
window's wall time.  The weights are made on the card from the seed
(:mod:`cellbench.lmweights`) and laid out as the program's parameter tree.

Once the window has closed, one call drawn from the seed is checked: of
its requests, the one with the longest prompt and one of each way the
scheduler serves a request (:mod:`cellbench.reference.schedule`: decoded
over the first fill's last prompt, the first fill's last itself, a
refill), drawn from the seed, each token held to the plain float32
reference (:mod:`cellbench.reference.lm`) by how far its logit lies below
the reference's best.

Parameters (``workloads/<cell>.json``): ``slots``, ``requests``,
``new_tokens``, ``prompt`` (``median``, ``sigma``, ``lo``, ``hi``),
``trace_calls``, ``gap_limit`` (the limit of the logit check).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from cellbench import counts, lmweights, prompts
from cellbench.harness import Check
from cellbench.reference import lm as ref_lm
from cellbench.reference import schedule

#: the program's parameter names for the benchmark's weights (one segment
#: of ``full`` layers: ``lm.param_defs``)
TREE = {"attn_norm": ("seg0", "ln1_0"), "mlp_norm": ("seg0", "ln2_0"),
        "wq": ("seg0", "m0", "wq"), "wk": ("seg0", "m0", "wk"), "wv": ("seg0", "m0", "wv"),
        "wo": ("seg0", "m0", "wo"), "w_up": ("seg0", "mlp0", "wi"),
        "w_gate": ("seg0", "mlp0", "wg"), "w_down": ("seg0", "mlp0", "wo"),
        "final_norm": ("final_norm",)}


@dataclasses.dataclass
class State:
    ctx: object
    engine: object
    fingerprint: dict
    calls: list = dataclasses.field(default_factory=list)  # per call: served tokens
    asked: list = dataclasses.field(default_factory=list)  # per call: its prompts' index
    unit_s: list = dataclasses.field(default_factory=list)  # each call's wall seconds


def arch(cfg: dict):
    """The program's configuration of the sizes ``cfg`` states."""
    from repro_torch.configs.base import ArchConfig

    n = cfg["num_hidden_layers"]
    return ArchConfig(name=cfg["name"], family="dense", n_layers=n, d_model=cfg["hidden_size"],
                      n_heads=cfg["num_attention_heads"],
                      n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
                      d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
                      layer_pattern=("full",) * n, tie_embeddings=cfg["tie_word_embeddings"],
                      rope_theta=float(cfg["rope_theta"]))


def as_run(cfg: dict) -> dict:
    """The configuration as the program runs it: the published values with
    those of ``run`` (where the program departs from them) in their
    place."""
    return {**cfg, **cfg.get("run", {})}


def program_params(cfg: dict, w: dict[str, torch.Tensor]) -> dict:
    """The program's parameter tree over the benchmark's weights (the
    embedding padded with zero rows to the program's vocabulary)."""
    from repro_torch.models import lm

    a = arch(cfg)
    emb = w["embed"]
    pad = lm.padded_vocab(a) - emb.shape[0]
    tree: dict = {"embed": {"tok": torch.cat([emb, emb.new_zeros((pad, emb.shape[1]))])}}
    for name, path in TREE.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = w[name]
    want = lm.abstract_params(a)

    def same(x, y, where):
        if isinstance(y, dict):
            if set(x) != set(y):
                raise ValueError(f"{where}: {sorted(x)} against the program's {sorted(y)}")
            for k in y:
                same(x[k], y[k], f"{where}/{k}")
        elif tuple(x.shape) != tuple(y.shape) or x.dtype != y.dtype:
            raise ValueError(f"{where}: {tuple(x.shape)} {x.dtype} against the program's "
                             f"{tuple(y.shape)} {y.dtype}")

    same(tree, want, "params")
    return tree


def _prompts(ctx, index: int) -> list[list[int]]:
    prm, cfg = ctx.cell.params, ctx.cell.config
    p = prm["prompt"]
    return prompts.call(ctx.seed, index, prm["requests"], p["median"], p["sigma"], p["lo"],
                        p["hi"], cfg["vocab_size"])


def setup(ctx) -> State:
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg, prm = ctx.cell.config, ctx.cell.params
    w = lmweights.make(cfg, ctx.seed, ctx.device)
    fp = lmweights.fingerprint(w)
    params = program_params(cfg, w)
    del w
    eng = ServeEngine(arch(cfg), params, ServeConfig(batch_slots=prm["slots"], temperature=0.0),
                      device=ctx.device)
    ctx.log("weights made; warming up")
    # one call at the cell's shapes: its prefill bucket and its decode batch
    warm = _prompts(ctx, 0)
    longest = max(range(len(warm)), key=lambda i: len(warm[i]))
    warm = [warm[longest]] + warm[: prm["slots"] - 1]
    eng.generate_continuous(warm, max_new_tokens=prm["new_tokens"])
    return State(ctx=ctx, engine=eng, fingerprint=fp)


def _call(st: State, index: int | None = None) -> tuple[int, int]:
    """One call of the prompts of call ``index`` (the next one when
    ``None``); (tokens served, requests failed)."""
    prm, cfg = st.ctx.cell.params, st.ctx.cell.config
    index = len(st.calls) if index is None else index
    out = st.engine.generate_continuous(_prompts(st.ctx, index),
                                        max_new_tokens=prm["new_tokens"])
    st.calls.append(out)
    st.asked.append(index)
    bad = sum(len(t) != prm["new_tokens"] or not all(0 <= x < cfg["vocab_size"] for x in t)
              for t in out)
    return sum(len(t) for t in out), bad


def window(st: State, seconds: float):
    t0 = time.perf_counter()
    tokens = failed = 0
    while True:
        t = time.perf_counter()
        got, bad = _call(st)
        st.unit_s.append(time.perf_counter() - t)
        tokens, failed = tokens + got, failed + bad
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    n = len(st.calls) * st.ctx.cell.params["requests"]
    st.ctx.log(f"{len(st.calls)} calls, {tokens} tokens in {elapsed:.3f} s; calls of "
               f"{', '.join(f'{s:.3f}' for s in st.unit_s)} s")
    return {"serve_tok_s": tokens / elapsed}, n, failed


def work(cfg: dict, lengths, sched: schedule.Schedule) -> dict:
    """What one call's traffic needs (:mod:`cellbench.counts`): the least
    seconds of every prefill and decode step at the chip's peaks, and those
    of the attention kernels' own parts."""
    least = k3 = k4 = 0.0
    for r in sched.prefills:
        c = counts.prefill(cfg, int(lengths[r]))
        least += counts.least_s(c["flops"], c["bytes"])
        k3 += counts.least_s(c["attn_flops"], c["attn_bytes"])
    for step in sched.steps:
        if not step:
            continue
        c = counts.decode(cfg, [int(lengths[r]) + k for r, k in step])
        least += counts.least_s(c["flops"], c["bytes"])
        k4 += counts.least_s(c["attn_flops"], c["attn_bytes"])
    return {"least_s": least, "k3_least_s": k3, "k4_least_s": k4}


def traced(st: State):
    """The traced window: ``trace_calls`` calls under the profiler, each
    made just before untraced with the same prompts, so that the shares of
    a call's time divide by the time it takes without the profiler's own
    cost (``untraced_s``)."""
    from cellbench import trace as tr

    prm, cfg = st.ctx.cell.params, st.ctx.cell.config
    n = int(prm["trace_calls"])
    first = len(st.calls)
    failed = 0
    t = time.perf_counter()
    for i in range(n):
        failed += _call(st, first + i)[1]
    untraced_s = time.perf_counter() - t
    with tr.traced(st.ctx.device) as got:
        for i in range(n):
            failed += _call(st, first + i)[1]
    t = got[0]
    total = {"least_s": 0.0, "k3_least_s": 0.0, "k4_least_s": 0.0}
    for i in range(first, first + n):
        lengths = [len(p) for p in _prompts(st.ctx, i)]
        w = work(cfg, lengths, schedule.plan(lengths, prm["slots"], prm["new_tokens"]))
        total = {k: total[k] + w[k] for k in total}
    t.counters.update(total, untraced_s=untraced_s, k3_kernels=("flash_",),
                      k4_kernels=("decode_tc_kernel", "decode_split_kernel",
                                  "decode_combine_kernel"))
    return t, (len(st.calls) - first) * prm["requests"], failed


def picks(sched: schedule.Schedule, lengths, rng) -> list[int]:
    """The longest prompt's request and one drawn from each way of being
    served: over the first fill's last prompt, that last request itself, a
    refill."""
    reqs = sched.requests
    kinds = [[r.index for r in reqs if r.owner != r.index],
             [r.index for r in reqs if r.owner == r.index and r.start == sched.plen],
             [r.index for r in reqs if r.start > sched.plen]]
    out = [int(np.argmax(lengths))]
    for kind in kinds:
        left = [r for r in kind if r not in out]
        if left:
            out.append(int(rng.choice(left)))
    return out


def _judge(st: State) -> dict:
    """Frees the program's state, then holds one call drawn from the seed
    to the plain reference (see the module)."""
    ctx = st.ctx
    prm, cfg = ctx.cell.params, ctx.cell.config
    dev = ctx.device
    st.engine = None  # the program's weights, caches and graphs go
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([ctx.seed, 11])
    c = int(rng.integers(0, len(st.calls)))
    asked = _prompts(ctx, st.asked[c])
    lengths = [len(p) for p in asked]
    sched = schedule.plan(lengths, prm["slots"], prm["new_tokens"])
    chosen = picks(sched, lengths, rng)
    served = st.calls[c]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = lmweights.make(cfg, ctx.seed, dev)
    drift = sum(a != b for a, b in zip(lmweights.fingerprint(w).values(),
                                       st.fingerprint.values()))
    model = ref_lm.Model(as_run(cfg), w, dev)
    seqs, targets = ref_lm.sequences(sched, asked, served, chosen)
    with torch.no_grad():
        logits = model.logits(seqs)
        g = ref_lm.gaps(logits, targets, served, cfg["vocab_size"])
    ctx.log(f"call {c}, requests {chosen}: {g.size} tokens, widest gap {g.max()}, "
            f"{int((g > 0).sum())} not the reference's best")
    return {"gaps": g, "logits": logits, "seqs": seqs, "weights": w, "drift": drift}


def check(st: State) -> list[Check]:
    prm = st.ctx.cell.params
    wrong = sum(len(t) != prm["new_tokens"] for call in st.calls for t in call)
    got = _judge(st)
    return [Check("logit_gap", float(got["gaps"].max()), float(prm["gap_limit"])),
            Check("tokens_missing", float(wrong), 0.0),
            Check("weights_redrawn_off", float(got["drift"]), 0.0)]


def readings(ctx, control: bool) -> dict:
    """The number the check compares, from one call at the cell's load, and
    with ``control`` the same number of the control: the reference with
    every weight matrix in fp8 (e4m3), the token it puts first at each row."""
    st = setup(ctx)
    window(st, 0.0)
    got = _judge(st)
    out = {"logit_gap": float(got["gaps"].max()), "tokens": int(got["gaps"].size),
           "not_best": int((got["gaps"] > 0).sum())}
    if control:
        cfg = ctx.cell.config
        low = ref_lm.Model(as_run(cfg), got["weights"], ctx.device, quantize=ref_lm.fp8)
        with torch.no_grad():
            cg = ref_lm.control_gaps(got["logits"], low.logits(got["seqs"]), cfg["vocab_size"])
        out.update(control_logit_gap=float(cg.max()), control_not_best=int((cg > 0).sum()))
    return out
