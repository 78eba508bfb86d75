"""The port's serving engine (``repro_torch.serve``) against the JAX
package's (``repro.serve``) on the CPU, from the same converted parameters:
greedy tokens of both schedulers equal the reference's, and the
reference's own engine tests (``tests/test_serve_placement.py:63-100``)
hold for the port.

The mixtures of experts (``qwen3-moe-30b-a3b``, ``mixtral-8x22b``) are
served through the same schedules: their left-padding tokens take expert
capacity before the prompt does, in both packages.  qwen2.5-14b, mixtral
and yi-34b are served with 2 KV heads at their full configs' groups (5, 6
and 7; ``reduced()`` alone makes them MHA), and qwen2.5's q/k/v biases,
qwen3-moe's QK-norm and phi4's norm scales non-zero
(``tests/test_torch_lm.py``'s ``HEADS``, ``NONZERO`` and ``_params``).

Token equality is asked with ``COMPUTE_DTYPE`` float32 in both packages'
``layers`` modules, so that near-ties in bf16 cannot flip an argmax; the
bf16 logits are compared by ``tests/test_torch_lm.py``.
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
from repro.models import lm as jlm
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.sharding.policies import ShardingPolicy
from repro_torch.configs import ARCHS
from repro_torch.kernels import LAUNCHES
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.engine import _splice_cache, _tile_cache
from tests.test_torch_lm import HEADS, _params

CPU = "cpu"
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8], [9], [10, 11, 12, 13, 14, 15, 16, 17, 18]]


@pytest.fixture
def float32_compute(monkeypatch):
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)


def _models(arch: str, kv: int | None = None):
    """The reduced configs, with ``kv`` KV heads (and ``HEADS``' q heads),
    and the parameters of both packages from one tree."""
    jc, pc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    if kv:
        heads = HEADS.get(arch, (pc.n_heads,))[0]
        jc, pc = (dataclasses.replace(c, n_heads=heads, n_kv_heads=kv) for c in (jc, pc))
    jp, tp = _params(jc, pc)
    return jc, pc, jp, tp


@pytest.mark.parametrize("arch,kv", [("deepseek-7b", None), ("phi4-mini-3.8b", 2),
                                     ("mamba2-1.3b", None), ("recurrentgemma-9b", None),
                                     ("qwen3-moe-30b-a3b", None), ("mixtral-8x22b", 2),
                                     ("qwen2.5-14b", 2), ("yi-34b", 2)])
def test_greedy_tokens_equal_the_reference(float32_compute, arch, kv):
    """Both schedulers, 5 prompts on 2 slots (three waves; two refills),
    6 new tokens: the same greedy tokens as ``repro.serve.ServeEngine``."""
    jc, pc, jp, tp = _models(arch, kv)
    ref = JaxServeEngine(jc, jp, ShardingPolicy(), JaxServeConfig(batch_slots=2))
    eng = ServeEngine(pc, tp, ServeConfig(batch_slots=2), device=CPU)
    before = dict(LAUNCHES)
    wave = eng.generate(PROMPTS, max_new_tokens=6)
    assert wave == ref.generate(PROMPTS, max_new_tokens=6)
    cont = eng.generate_continuous(PROMPTS, max_new_tokens=6)
    assert cont == ref.generate_continuous(PROMPTS, max_new_tokens=6)
    assert all(len(o) == 6 for o in wave + cont)
    assert LAUNCHES == before  # the CPU takes the plain versions


# reduced phi4's random weights give logits so peaked (each prompt's last
# token repeats) that sampling at 0.8 draws the greedy tokens; mamba2's not
@pytest.mark.parametrize("arch,draws_differ", [("phi4-mini-3.8b", False),
                                               ("mamba2-1.3b", True)])
def test_sampled_tokens_equal_the_reference(float32_compute, arch, draws_differ):
    """``temperature=0.8``: the engine holds ``PRNGKey(seed)`` and samples
    ``categorical(sub, logits / T)`` after a split each step, so both
    schedulers give the reference engine's tokens from the same seed and
    ``init_params`` seed, with no parameter conversion, and end on the
    reference's key (one split a sampled step)."""
    jc, pc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    ref = JaxServeEngine(jc, jlm.init_params(jc, jax.random.PRNGKey(1)), ShardingPolicy(),
                         JaxServeConfig(batch_slots=2, temperature=0.8, seed=5))
    eng = ServeEngine(pc, lm.init_params(pc, 1, device=CPU),
                      ServeConfig(batch_slots=2, temperature=0.8, seed=5), device=CPU)
    wave = eng.generate(PROMPTS, max_new_tokens=6)
    assert wave == ref.generate(PROMPTS, max_new_tokens=6)
    cont = eng.generate_continuous(PROMPTS, max_new_tokens=6)
    assert cont == ref.generate_continuous(PROMPTS, max_new_tokens=6)
    np.testing.assert_array_equal(eng._key.numpy(), np.asarray(ref._key))
    greedy = ServeEngine(pc, eng.params, ServeConfig(batch_slots=2), device=CPU)
    assert (wave != greedy.generate(PROMPTS, max_new_tokens=6)) == draws_differ


@pytest.fixture(scope="module")
def deepseek():
    cfg = ARCHS["deepseek-7b"].reduced()
    return cfg, lm.init_params(cfg, 0, device=CPU)


def test_greedy_deterministic(deepseek):
    cfg, params = deepseek
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2), device=CPU)
    a = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=5)
    b = eng.generate([[1, 2, 3], [4, 5]], max_new_tokens=5)
    assert a == b
    assert all(len(x) == 5 for x in a)
    assert all(0 <= t < cfg.vocab_size for x in a for t in x)


def test_waves_cover_queue(deepseek):
    cfg, params = deepseek
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2), device=CPU)
    outs = eng.generate([[1], [2], [3], [4], [5]], max_new_tokens=3)
    assert len(outs) == 5 and all(len(o) == 3 for o in outs)


def test_continuous_batching_matches_wave(deepseek):
    cfg, params = deepseek
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2), device=CPU)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8], [9]]
    wave = eng.generate(prompts, max_new_tokens=5)
    cont = eng.generate_continuous(prompts, max_new_tokens=5)
    assert all(len(o) == 5 for o in cont)
    # the first wave's requests decode identically under both schedulers
    assert cont[0] == wave[0] and cont[1] == wave[1]


def test_eos_stops_slot(deepseek):
    cfg, params = deepseek
    probe = ServeEngine(cfg, params, ServeConfig(batch_slots=1), device=CPU)
    first = probe.generate([[1]], max_new_tokens=1)[0][0]
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=1, eos_id=first), device=CPU)
    assert eng.generate([[1]], max_new_tokens=8)[0] == [first]


def test_sampling_is_seeded(deepseek):
    cfg, params = deepseek

    def run(seed):
        sc = ServeConfig(batch_slots=2, temperature=1.0, seed=seed)
        return ServeEngine(cfg, params, sc, device=CPU).generate([[1, 2], [3]], max_new_tokens=8)

    a = run(0)
    assert a == run(0) and a != run(1)
    assert all(0 <= t < cfg.vocab_size for x in a for t in x)


def test_cache_tile_and_splice():
    """``_tile_cache`` copies slot 0 to every slot; ``_splice_cache``
    overwrites a batch-1 cache whole (the reference replaces it) and writes
    one slot of a batched one, both in place (a decode graph holds the
    tensors), and leaves ``slot_pos`` (no batch dim) as it was, as the
    reference does.  The tiled cache shares no storage with the batch-1
    one, ``slot_pos`` included (a replayed prefill rewrites its bucket's
    caches)."""
    k0 = torch.arange(6.0).view(2, 1, 3)
    single = [{"0": {"k": k0.clone(), "slot_pos": torch.tensor([[0, -1]] * 2)}}]
    tiled = _tile_cache(single, 3)
    assert tiled[0]["0"]["k"].shape == (2, 3, 3)
    assert torch.equal(tiled[0]["0"]["k"][:, 2], single[0]["0"]["k"][:, 0])
    assert tiled[0]["0"]["slot_pos"] is not single[0]["0"]["slot_pos"]
    assert torch.equal(tiled[0]["0"]["slot_pos"], single[0]["0"]["slot_pos"])
    other = [{"0": {"k": -torch.ones(2, 1, 3), "slot_pos": torch.tensor([[5, 6]] * 2)}}]
    k_single = single[0]["0"]["k"]
    _splice_cache(single, other, 0)
    assert single[0]["0"]["k"] is k_single and torch.equal(k_single, other[0]["0"]["k"])
    k_tiled = tiled[0]["0"]["k"]
    _splice_cache(tiled, other, 1)
    assert tiled[0]["0"]["k"] is k_tiled
    assert torch.equal(k_tiled[:, 1], -torch.ones(2, 3))
    assert torch.equal(k_tiled[:, 0], k0[:, 0])
    assert torch.equal(tiled[0]["0"]["slot_pos"], torch.tensor([[0, -1]] * 2))


def _storages(tree) -> list[int]:
    return [leaf.untyped_storage().data_ptr() for leaf in _leaves(tree)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_tiled_cache_shares_no_storage_with_its_prefill(deepseek):
    """``_tile_cache`` copies every leaf of the batch-1 cache, ``slot_pos``
    included: a later prefill written into that cache in place (as a replay
    of its bucket writes it) leaves the tiled cache as it was."""
    cfg, params = deepseek
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=3), device=CPU)
    with torch.inference_mode():
        _, single = eng._prefill(np.array([[0, 0, 0, 1, 2, 3, 4, 5]], np.int32), 12)
        tiled = _tile_cache(single, 3)
        want = [x.clone() for x in _leaves(tiled)]
        assert not set(_storages(tiled)) & set(_storages(single))
        _, later = eng._prefill(np.array([[9, 8, 7, 6, 5, 4, 3, 2]], np.int32), 12)
        for dst, src in zip(_leaves(single), _leaves(later)):
            dst.copy_(src)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tiled), want))
    assert any(not torch.equal(a, b) for a, b in zip(_leaves(single), _leaves(tiled)))
    assert list(eng._prefills) == [(1, 8, 12)]


def test_prefill_runs_per_bucket(deepseek):
    """Prefill is keyed by the reference's bucket ``(batch, plen, max_len)``:
    two waves of 2 at one padded length share one bucket, the continuous
    scheduler prefills every request at ``(1, plen, plen + 2·new)``."""
    cfg, params = deepseek
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2), device=CPU)
    eng.generate([[1, 2, 3], [4, 5], [6, 7, 8, 9], [10]], max_new_tokens=3)
    assert list(eng._prefills) == [(2, 8, 11)]
    eng.generate_continuous([[1, 2, 3], [4, 5], [6, 7, 8, 9]], max_new_tokens=3)
    assert list(eng._prefills) == [(2, 8, 11), (1, 8, 14)]


def test_engine_rejects_what_the_slice_does_not_serve(deepseek):
    """The engine serves text archs, experts included, and refuses the vlm
    and audio configs as the reference's demo engine does
    (``repro/serve/engine.py:50``)."""
    cfg, params = deepseek
    for arch in ("llava-next-mistral-7b", "musicgen-large"):
        with pytest.raises(NotImplementedError, match="serves text archs"):
            ServeEngine(ARCHS[arch].reduced(), params, device=CPU)
        with pytest.raises(NotImplementedError):
            JaxServeEngine(JAX_ARCHS[arch].reduced(), {})
    moe = ARCHS["mixtral-8x22b"].reduced()
    assert ServeEngine(moe, lm.init_params(moe, 0, device=CPU), device=CPU).cfg is moe
    with pytest.raises(ValueError, match="lie on"):
        ServeEngine(cfg, {"embed": {"tok": torch.zeros(1, device="meta")}}, device=CPU)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b", "recurrentgemma-9b",
                                  "qwen3-moe-30b-a3b"])
def test_launcher_prints_prompt_lines(capsys, arch):
    from repro_torch.launch import serve

    outs = serve.main(["--arch", arch, "--prompts", "1,2,3", "4,5",
                       "--max-new", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"[1, 2, 3] -> {outs[0]}", f"[4, 5] -> {outs[1]}"]
    assert all(len(o) == 4 for o in outs)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_recurrent_cache_tile_and_splice(arch):
    """The recurrent caches' leaves (``[R, B, ...]`` states, the nested
    ``conv`` dict of ssm layers) tile and splice as the reference's
    ``_tile_cache`` / ``_splice_cache`` do: every batch-1 leaf is tiled, a
    spliced slot takes the newcomer's state, the other slots keep theirs,
    and ``slot_pos`` (no batch dim) stays as it was."""
    from repro.serve.engine import _splice_cache as jax_splice
    from repro.serve.engine import _tile_cache as jax_tile

    cfg = ARCHS[arch].reduced()
    params = lm.init_params(cfg, 0, device=CPU)
    t1, t2 = (torch.tensor([toks], dtype=torch.int32) for toks in ([1, 2, 3, 4] * 4, [5, 6] * 8))
    _, c1 = lm.prefill(params, {"tokens": t1}, cfg, max_len=20)
    _, c2 = lm.prefill(params, {"tokens": t2}, cfg, max_len=20)
    as_jax = lambda c: jax.tree.map(lambda x: jnp.asarray(x.float().numpy()), c)  # noqa: E731
    tiled = _tile_cache(c1, 3)
    out = _splice_cache(tiled, c2, 1)
    want = jax_splice(jax_tile(as_jax(c1), 3), as_jax(c2), 1)
    got = jax.tree.leaves(jax.tree.map(lambda x: x.float().numpy(), out))
    ref = jax.tree.leaves(want)
    assert len(got) == len(ref) and len(got) == len(jax.tree.leaves(as_jax(c1)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, np.asarray(r))
    conv = out[0]["0"]["conv"]
    if arch == "mamba2-1.3b":
        assert conv["x"].shape[1] == 3 and out[0]["0"]["ssm"].shape[1] == 3
        assert torch.equal(out[0]["0"]["ssm"][:, 1], c2[0]["0"]["ssm"][:, 0])
        assert torch.equal(out[0]["0"]["ssm"][:, 2], c1[0]["0"]["ssm"][:, 0])
    else:
        assert torch.equal(out[0]["2"]["slot_pos"], c1[0]["2"]["slot_pos"])
        assert torch.equal(out[0]["0"]["h"][:, 1], c2[0]["0"]["h"][:, 0])
