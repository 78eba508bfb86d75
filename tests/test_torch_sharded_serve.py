"""The port's serving route sharded over many ranks (``lm.prefill`` /
``lm.decode_step`` / ``ServeEngine`` with a ``ShardingPolicy``, every kernel
on each rank's shards) against the reference's sharded serving and the
port's one-process serving, on the CPU.

Families, reduced, from the reference's ``init_params`` (key 0) carried
across by ``convert.lm_params``, every leaf and ``COMPUTE_DTYPE`` float32:
phi4-mini-3.8b (4 KV heads: the cache's heads over ``tp``), phi4 with one KV
head under ``attn_mode="gather"`` (a full-attention cache whose slots are
split over ``tp``), recurrentgemma-9b (1 KV head: the slot-split ``local``
ring of window 64, which the decode steps wrap, so one rank holds the new
row's slot and the other not), mamba2-1.3b (K5 and the states on the
rank's heads) and qwen3-moe-30b-a3b (expert parallelism: 8 experts over
``model`` of size 2).  A prefill of 4 × 64 tokens with room for 4 decode
steps, then the 4 steps; and ``ServeEngine`` with 2 slots over 3 prompts
(``generate``'s last wave and every ``generate_continuous`` prefill are
batch-1: the batch axes do not divide them and are dropped).  The port
runs on 4 gloo ranks on a ``(2, 2)`` ``("data", "model")`` mesh
(``tests/_torch_dist.py:sharded_serve_runs``); the reference's ``jax.jit``
prefill and decode and its engine run under its ``make_policy`` on 4 fake
host devices in a subprocess (``run_devices``), beside the ranks.

Tolerance (``tests/test_torch_lm.py``'s float32 checks): logits over the
real vocabulary and every cache leaf within ``rtol = 1e-4`` and ``atol =
1e-4 · max|reference|``; the recurrent families within 1e-3, as there
(their states sum many more terms); greedy tokens equal.  The sharded run
against the one-process port: the same bounds.
"""
from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import lm as jlm
from repro_torch.configs import ARCHS
from repro_torch.models import lm
from repro_torch.sharding import make_policy
from tests._torch_dist import _spec_leaves, sharded_serve_runs, spawn
from tests.conftest import run_devices

#: (name, arch, config overrides, make_policy kwargs, serve through the engine)
CASES = [
    ("phi4", "phi4-mini-3.8b", {}, {}, True),
    ("phi4-kv1-gather", "phi4-mini-3.8b", {"n_kv_heads": 1}, {"attn_mode": "gather"}, False),
    ("recurrentgemma", "recurrentgemma-9b", {}, {}, True),
    ("mamba2", "mamba2-1.3b", {}, {}, True),
    ("qwen3-moe", "qwen3-moe-30b-a3b", {}, {}, True),
]
NAMES = [c[0] for c in CASES]
ENGINE = [c[0] for c in CASES if c[4]]
RECURRENT = ("recurrentgemma", "mamba2")
B, S, T, MAX_NEW = 4, 64, 4, 4

REFERENCE = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.compat import make_mesh
from repro.configs import ARCHS
from repro.models import layers as JL, lm
from repro.serve.engine import ServeConfig, ServeEngine
from repro.sharding.policies import make_policy

JL.COMPUTE_DTYPE = jnp.float32
mesh = make_mesh((2, 2), ("data", "model"))
z = np.load({src!r})
tokens, steps = z["tokens"], z["steps"]
prompts = [list(map(int, p)) for p in {prompts!r}]
out = {{}}
for name, arch, overrides, kw, engine in {cases!r}:
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **overrides)
    pol = make_policy(mesh, **kw)
    params = jax.tree.map(lambda x: x.astype(jnp.float32),
                          lm.init_params(cfg, jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)),
                          params, lm.param_specs(cfg, pol))
    n = tokens.shape[1] + steps.shape[1]
    logits, caches = jax.jit(lambda p, b: lm.prefill(p, b, cfg, pol, max_len=n))(
        params, {{"tokens": jnp.asarray(tokens)}})
    out[name + "|prefill"] = np.asarray(logits, np.float32)
    for i, leaf in enumerate(jax.tree.leaves(caches)):
        out[name + "|prefill_caches|%d" % i] = np.asarray(leaf)
    dec = jax.jit(lambda p, c, b, pos: lm.decode_step(p, c, b, pos, cfg, pol))
    for i in range(steps.shape[1]):
        logits, caches = dec(params, caches, {{"tokens": jnp.asarray(steps[:, i:i + 1])}},
                             jnp.int32(tokens.shape[1] + i))
        out[name + "|decode|%d" % i] = np.asarray(logits, np.float32)
    for i, leaf in enumerate(jax.tree.leaves(caches)):
        out[name + "|decode_caches|%d" % i] = np.asarray(leaf)
    if engine:
        eng = ServeEngine(cfg, params, pol, ServeConfig(batch_slots=2))
        out[name + "|generate"] = np.asarray(eng.generate(prompts, {max_new}))
        out[name + "|continuous"] = np.asarray(eng.generate_continuous(prompts, {max_new}))
np.savez({dst!r}, **out)
print("OK")
"""


def _flat(tree, prefix: str = "") -> dict:
    """Leaves keyed by path, float32 numpy, in sorted-key order."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], prefix + key + "/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _leaves(z: dict, key: str) -> list:
    n = sum(1 for k in z if k.startswith(key + "|"))
    return [z[f"{key}|{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (the port's results by rank, the reference's)}"""
    tmp = tmp_path_factory.mktemp("sharded_serve")
    rng = np.random.default_rng(0)
    vocab = ARCHS["phi4-mini-3.8b"].reduced().vocab_size  # 512 in every reduced config
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    steps = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
    prompts = [rng.integers(1, vocab, size=n).tolist() for n in (5, 12, 7)]
    src, dst = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    np.savez(src, tokens=tokens, steps=steps)
    cases = []
    for name, arch, overrides, kw, engine in CASES:
        jc = dataclasses.replace(JAX_ARCHS[arch].reduced(), **overrides)
        cases.append((arch, _flat(jlm.init_params(jc, jax.random.PRNGKey(0))), overrides, kw,
                      engine))
    code = REFERENCE.format(src=src, dst=dst, prompts=prompts, cases=CASES, max_new=MAX_NEW)
    with ThreadPoolExecutor(1) as pool:  # the reference beside the ranks
        ref = pool.submit(run_devices, code, 4, 600)
        port = spawn(sharded_serve_runs, 4, tmp / "ranks", cases, tokens, steps, prompts,
                     MAX_NEW, timeout=600)
        assert "OK" in ref.result()
    z = dict(np.load(dst))
    out = {}
    for i, (name, _, _, _, engine) in enumerate(CASES):
        want = {"prefill": z[name + "|prefill"], "decode": _leaves(z, name + "|decode"),
                "prefill_caches": _leaves(z, name + "|prefill_caches"),
                "decode_caches": _leaves(z, name + "|decode_caches")}
        if engine:
            want.update(generate=z[name + "|generate"].tolist(),
                        continuous=z[name + "|continuous"].tolist())
        out[name] = ([r[i] for r in port], want)
    return out


def _close(got, want, tol: float, msg: str, vocab: int | None = None) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=msg)


def _check(got: dict, want: dict, name: str) -> None:
    tol = 1e-3 if name in RECURRENT else 1e-4
    vocab = ARCHS["phi4-mini-3.8b"].reduced().vocab_size
    _close(got["prefill"], want["prefill"], tol, "prefill logits", vocab)
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _close(g, w, tol, f"decode step {i}", vocab)
    for key in ("prefill_caches", "decode_caches"):
        assert len(got[key]) == len(want[key]), key
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            _close(g, w, tol, f"{key} leaf {i}")


@pytest.mark.parametrize("name", NAMES)
def test_sharded_prefill_and_decode_equal_the_reference(runs, name):
    ranks, want = runs[name]
    for rank, got in enumerate(ranks):  # every rank gathers the same values
        _check(got, want, name)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_prefill_and_decode_equal_the_one_process_port(runs, name):
    ranks, _ = runs[name]
    _check(ranks[0], ranks[0]["plain"], name)


@pytest.mark.parametrize("name", ENGINE)
def test_engine_greedy_tokens_equal_the_reference(runs, name):
    ranks, want = runs[name]
    for got in ranks:
        assert got["generate"] == want["generate"]
        assert got["continuous"] == want["continuous"]
    assert ranks[0]["plain"]["generate"] == want["generate"]


@pytest.mark.parametrize("name", ENGINE)
def test_engine_decode_logits_equal_the_one_process_port(runs, name):
    """Every decode step of both schedulers under the mesh gives the
    unsharded engine's logits: a decode that lost the prompt's cache rows
    (its ``slot_pos``) after the continuous fill would not."""
    ranks, _ = runs[name]
    tol = 1e-3 if name in RECURRENT else 1e-4
    vocab = ARCHS["phi4-mini-3.8b"].reduced().vocab_size
    want = ranks[0]["plain"]["engine_decode"]
    for got in ranks:
        assert len(got["engine_decode"]) == len(want)
        for i, (g, w) in enumerate(zip(got["engine_decode"], want)):
            _close(g, w, tol, f"engine decode step {i}", vocab)


@pytest.mark.parametrize("name", NAMES)
def test_cache_shards_follow_the_specs(runs, name):
    """Every rank holds its spec's share of each cache leaf: the batch over
    ``data``; the K/V heads over ``model`` when they divide it, else the
    slots (phi4 with one KV head, recurrentgemma's ring); recurrent states
    over ``model`` on their channels."""
    ranks, want = runs[name]
    arch, overrides = next((c[1], c[2]) for c in CASES if c[0] == name)
    pol = make_policy(SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda dim: 2))
    specs = _spec_leaves(lm.cache_specs(dataclasses.replace(ARCHS[arch].reduced(), **overrides),
                                        pol))
    for got in ranks:
        assert len(got["local_shapes"]) == len(specs)
        for local, full, spec in zip(got["local_shapes"], want["decode_caches"], specs):
            share = tuple(math.ceil(n / 2 ** len(spec.axes_of(d))) for d, n in
                          enumerate(full.shape))
            assert local == share, (local, full.shape, spec)
