"""The port's LM (``repro_torch.models``) against the JAX package's
(``repro.models``) on the CPU, from the same parameters
(``repro_torch.convert.lm_params`` of the JAX ``init_params`` tree) and the
same numpy tokens: the layers one by one, prefill and several decode steps
for ``deepseek-7b`` reduced (MHA), ``phi4-mini-3.8b`` reduced with two kv
heads (GQA, group 2), ``mamba2-1.3b`` reduced (ssm),
``recurrentgemma-9b`` reduced (rglru + local attention, window 64, whose
ring-buffer decode is checked on an aligned and a misaligned prefill),
``qwen2.5-14b`` reduced (the one served config with q/k/v biases),
``yi-34b`` reduced, and the mixtures of experts (``qwen3-moe-30b-a3b``,
``mixtral-8x22b``, whose ``swa`` ring is misaligned after its prefill) and
the vlm and audio front ends (``llava-next-mistral-7b``,
``musicgen-large``) reduced.

Two blind spots of the reduced configs are closed here.  ``reduced()``
caps the q heads at 4 and lowers the KV heads until they divide, so it
makes qwen2.5, mixtral and yi MHA: they run with 2 KV heads and their full
configs' groups instead (``HEADS``: 10, 12 and 14 q heads, groups 5, 6 and
7).  ``init_params`` makes the q/k/v biases, the QK-norm scales and every
norm scale zero (``PDef.init == "zeros"``), so a port that dropped one
would still equal the reference: for ``NONZERO``'s configs (qwen2.5's
biases, qwen3-moe's QK-norm, phi4 with neither) every such leaf of the
reference's tree is made ``0.1 · normal`` before both packages get it, and
zeroing the biases or QK-norm scales of the port again must fail the
float32 bound.

Tolerance.  Both packages compute in bfloat16 with float32 softmax and
norms and round at the same places, but their matmuls sum in other orders,
so an output may land one bf16 step (2^-8 .. 2^-7 relative) away:
``rtol = 2^-6`` (two steps) and ``atol = 2^-6 · rms(reference)`` for values
near zero.  The float32 checks (``COMPUTE_DTYPE`` float32 in both
packages) hold to ``1e-4`` relative.
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
from repro.sharding.policies import ShardingPolicy
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import lm

POL = ShardingPolicy()
CPU = "cpu"
MODELS = ["deepseek-7b", "mamba2-1.3b", "phi4-mini-3.8b", "qwen2.5-14b", "recurrentgemma-9b",
          "yi-34b"]
RECURRENT = ["mamba2-1.3b", "recurrentgemma-9b"]
# arch -> (n_heads, n_kv_heads) of its reduced config: phi4 GQA (group 2);
# qwen2.5, mixtral and yi grouped as their full configs (groups 5, 6, 7)
HEADS = {"phi4-mini-3.8b": (4, 2), "qwen2.5-14b": (10, 2), "mixtral-8x22b": (12, 2),
         "yi-34b": (14, 2)}
# the configs whose zero-initialised leaves are made 0.1 · normal
NONZERO = ("phi4-mini-3.8b", "qwen2.5-14b", "qwen3-moe-30b-a3b")


def _cfgs(arch: str):
    jc, pc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    if arch in HEADS:
        heads, kv = HEADS[arch]
        jc, pc = (dataclasses.replace(c, n_heads=heads, n_kv_heads=kv) for c in (jc, pc))
    return jc, pc


def _params(jc, pc, seed: int = 0):
    """The reference's ``init_params`` tree, for ``NONZERO``'s configs with
    every zero-initialised leaf (q/k/v biases, QK-norm and norm scales)
    replaced by seeded ``0.1 · normal`` values in the leaf's dtype, and the
    port's parameters converted from it."""
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    if jc.name in NONZERO:
        rng = np.random.default_rng(seed + 100)

        def fill(defs, leaf):
            if isinstance(defs, jlm.PDef):
                return (jnp.asarray(0.1 * rng.standard_normal(defs.shape), defs.dtype)
                        if defs.init == "zeros" else leaf)
            return {k: fill(defs[k], leaf[k]) for k in sorted(defs)}

        jp = fill(jlm.param_defs(jc), jp)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, convert.lm_params(tree, pc, CPU)


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assert_bf16_close(port, ref, n_vocab=None, msg=""):
    port, ref = _f32(port), _f32(ref)
    if n_vocab is not None:
        port, ref = port[..., :n_vocab], ref[..., :n_vocab]
    rms = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
    np.testing.assert_allclose(port, ref, rtol=2**-6, atol=2**-6 * rms, err_msg=msg)


def _bf16(rng, *shape) -> tuple[np.ndarray, torch.Tensor]:
    """A bf16-exact numpy array and the same values as a bf16 tensor."""
    a = np.array(jnp.asarray(rng.normal(size=shape), jnp.bfloat16), np.float32)
    return a, torch.from_numpy(a).to(torch.bfloat16)


@pytest.fixture(scope="module")
def phi4():
    jc, pc = _cfgs("phi4-mini-3.8b")
    jp, tp = _params(jc, pc)
    return jc, pc, jp, tp


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree["seg0"])


def test_norm_rope_mlp_match(phi4):
    jc, pc, jp, tp = phi4
    rng = np.random.default_rng(0)
    x, tx = _bf16(rng, 2, 16, pc.d_model)
    jx = jnp.asarray(x, jnp.bfloat16)
    jl, tl = _layer0(jp), lm._layer(tp["seg0"], 0)
    scale = rng.normal(size=pc.d_model).astype(np.float32) * 0.1
    assert_bf16_close(L.rms_norm(tx, torch.from_numpy(scale)), JL.rms_norm(jx, jnp.asarray(scale)))
    h, th = _bf16(rng, 2, 16, 4, 32)
    pos = np.arange(3, 19)
    assert_bf16_close(L.rope(th, torch.from_numpy(pos), 10_000.0),
                      JL.rope(jnp.asarray(h, jnp.bfloat16), jnp.asarray(pos), 10_000.0))
    # one position as an int (decode) equals a length-1 position vector
    torch.testing.assert_close(L.rope(th[:, :1], 7, 10_000.0),
                               L.rope(th[:, :1], torch.tensor([7]), 10_000.0), rtol=0, atol=0)
    assert_bf16_close(L.swiglu_mlp(tx, tl["mlp0"]), JL.swiglu_mlp(jx, jl["mlp0"], POL))


@pytest.mark.parametrize("mixer", ["full", "swa"])
def test_attention_block_matches(phi4, mixer):
    jc, pc, jp, tp = phi4
    jc, pc = (dataclasses.replace(c, window=24) for c in (jc, pc))
    x, tx = _bf16(np.random.default_rng(1), 2, 48, pc.d_model)
    jout, (jk, jv) = JL.attention_block(jnp.asarray(x, jnp.bfloat16), _layer0(jp)["m0"], jc,
                                        mixer, POL, return_kv=True)
    tout, (tk, tv) = L.attention_block(tx, lm._layer(tp["seg0"], 0)["m0"], pc, mixer,
                                       return_kv=True)
    assert tout.shape == (2, 48, pc.d_model) and tk.shape == (2, 48, pc.n_kv_heads, pc.head_dim)
    assert_bf16_close(tout, jout)
    assert_bf16_close(tk, jk)
    assert_bf16_close(tv, jv)


def test_attention_decode_matches(phi4):
    """One decode step against a half-filled cache: the output and the
    cache written in place equal the reference's new cache."""
    jc, pc, jp, tp = phi4
    rng = np.random.default_rng(2)
    b, w, n = 3, 16, 9
    x, tx = _bf16(rng, b, 1, pc.d_model)
    k, tk = _bf16(rng, b, w, pc.n_kv_heads, pc.head_dim)
    v, tv = _bf16(rng, b, w, pc.n_kv_heads, pc.head_dim)
    k[:, n:] = v[:, n:] = 0.0
    tk[:, n:] = tv[:, n:] = 0.0
    sp = np.where(np.arange(w) < n, np.arange(w), -1).astype(np.int32)
    jcache = {"k": jnp.asarray(k, jnp.bfloat16), "v": jnp.asarray(v, jnp.bfloat16),
              "slot_pos": jnp.asarray(sp)}
    tcache = {"k": tk, "v": tv, "slot_pos": torch.from_numpy(sp.copy())}
    jout, jnew = JL.attention_decode(jnp.asarray(x, jnp.bfloat16), _layer0(jp)["m0"], jcache,
                                     jnp.int32(n), jc, "full", POL)
    tout, tnew = L.attention_decode(tx, lm._layer(tp["seg0"], 0)["m0"], tcache, n, pc, "full")
    assert tnew["k"] is tk  # written in place
    assert_bf16_close(tout, jout)
    assert_bf16_close(tk, jnew["k"])
    assert_bf16_close(tv, jnew["v"])
    np.testing.assert_array_equal(tcache["slot_pos"].numpy(), np.asarray(jnew["slot_pos"]))
    # swa on the same cache: a ring buffer, slot pos % W, validity per slot
    jc, pc = (dataclasses.replace(c, window=6) for c in (jc, pc))
    jcache = {k: jnp.asarray(v) for k, v in jnew.items()}
    for pos in (n + 1, w + 3):  # the second wraps to slot 3
        jout, jcache = JL.attention_decode(jnp.asarray(x, jnp.bfloat16), _layer0(jp)["m0"], jcache,
                                           jnp.int32(pos), jc, "swa", POL)
        tout, _ = L.attention_decode(tx, lm._layer(tp["seg0"], 0)["m0"], tcache, pos, pc, "swa")
        assert_bf16_close(tout, jout)
        np.testing.assert_array_equal(tcache["slot_pos"].numpy(), np.asarray(jcache["slot_pos"]))


def _prefill_and_decode(jc, pc, jp, tp, toks: np.ndarray, s: int):
    """prefill(S) and teacher-forced decode steps over ``toks[:, S:]`` in
    both packages, the reference jitted: ``[(call, port logits, reference
    logits)]`` and both final caches."""
    extra = toks.shape[1] - s
    jl, jcache = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t}, jc, POL, max_len=s + extra))(
        jp, jnp.asarray(toks[:, :s]))
    tl, tcache = lm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pc, max_len=s + extra)
    calls = [("prefill", tl, jl)]
    dec = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, {"tokens": t}, pos, jc, POL))
    for i in range(extra):
        jl, jcache = dec(jp, jcache, jnp.asarray(toks[:, s + i : s + i + 1]), jnp.int32(s + i))
        tl, tcache = lm.decode_step(tp, tcache, {"tokens": torch.from_numpy(toks[:, s + i : s + i + 1])},
                                    s + i, pc)
        calls.append((f"decode {i}", tl, jl))
    return calls, tcache, jcache


def _f32_excess(port, ref, n_vocab: int) -> float:
    """How far the port's logits lie past the float32 bound, ``1e-4``
    relative and ``1e-4`` of the reference's largest logit (<= 0: within)."""
    port, ref = _f32(port)[..., :n_vocab], _f32(ref)[..., :n_vocab]
    return float((np.abs(port - ref) - 1e-4 * np.abs(ref) - 1e-4 * np.abs(ref).max()).max())


@pytest.mark.parametrize("arch", MODELS)
def test_prefill_and_decode_match(arch):
    """prefill(S) and 8 teacher-forced decode steps: logits and caches
    equal the reference's (bf16 bound above); the port's forward over all
    S + 8 tokens agrees with its own last decode step."""
    jc, pc = _cfgs(arch)
    jp, tp = _params(jc, pc)
    b, s, extra = 2, 48, 8
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (b, s + extra)).astype(np.int32)
    calls, tcache, jcache = _prefill_and_decode(jc, pc, jp, tp, toks, s)
    tl = calls[0][1]
    assert tl.shape == (b, lm.padded_vocab(pc)) and tl.dtype == torch.float32
    assert (tl[:, jc.vocab_size:] == -1e30).all()
    for name, tl, jl in calls:
        assert_bf16_close(tl, jl, jc.vocab_size, f"{arch} {name}")
    for path, (t, j) in _cache_leaves(tcache, jcache):
        if path.endswith("slot_pos"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)
        elif path.endswith(("/ssm", "/h")):
            # float32 sums of bf16 terms: an input one bf16 step away moves a
            # sum near zero by that step of its terms, not of the sum
            j = _f32(j)
            np.testing.assert_allclose(_f32(t), j, rtol=2**-6, atol=2**-6 * np.abs(j).max(),
                                       err_msg=path)
        else:
            assert_bf16_close(t, j, msg=path)
    h = lm.forward(tp, lm.embed_inputs(tp, {"tokens": torch.from_numpy(toks)}, pc), pc)
    assert_bf16_close(tl, lm.lm_logits(tp, h[:, -1:], pc)[:, 0], pc.vocab_size, "forward")


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "yi-34b"])
def test_float32_prefill_and_decode_match(arch, monkeypatch):
    """qwen2.5 (group 5, non-zero q/k/v biases) and yi (group 7) with
    ``COMPUTE_DTYPE`` float32 in both packages: prefill and 8 teacher-forced
    decode steps within ``1e-4``."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jc, pc = _cfgs(arch)
    assert pc.n_heads // pc.n_kv_heads == {"qwen2.5-14b": 5, "yi-34b": 7}[arch]
    jp, tp = _params(jc, pc)
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 48 + 8)).astype(np.int32)
    for name, tl, jl in _prefill_and_decode(jc, pc, jp, tp, toks, 48)[0]:
        assert _f32_excess(tl, jl, jc.vocab_size) <= 0, f"{arch} {name}"


@pytest.mark.parametrize("arch,leaves", [("qwen2.5-14b", ("bq", "bk", "bv")),
                                         ("qwen3-moe-30b-a3b", ("q_norm", "k_norm"))])
def test_zeroed_leaves_fail_the_bound(arch, leaves, monkeypatch):
    """The bounds see the leaves ``init_params`` makes zero: under float32
    compute the port's prefill is within ``1e-4`` of the reference's with
    ``NONZERO``'s leaves and falls outside it with these zeroed again in
    every layer (under bf16 compute zeroed QK-norm scales stay within two
    bf16 steps: random weights give the attention little weight in the
    logits)."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jc, pc = _cfgs(arch)
    jp, tp = _params(jc, pc)
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, POL)
    tl, _ = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, pc)
    assert _f32_excess(tl, jl, jc.vocab_size) <= 0
    mixers = [m for seg, node in tp.items() if seg.startswith("seg")
              for m in node.values() if isinstance(m, dict) and leaves[0] in m]
    assert mixers
    for m in mixers:
        for k in leaves:
            m[k] = torch.zeros_like(m[k])
    tl, _ = lm.prefill(tp, {"tokens": torch.from_numpy(toks)}, pc)
    assert _f32_excess(tl, jl, jc.vocab_size) > 0, f"{leaves} zeroed: unseen"


def _cache_leaves(tcache, jcache, path=""):
    """(path, (port leaf, reference leaf)) over both caches' nested dicts."""
    if isinstance(tcache, (list, dict)):
        keys = range(len(tcache)) if isinstance(tcache, list) else sorted(tcache)
        assert (sorted(jcache) if isinstance(jcache, dict) else range(len(jcache))) == keys
        for k in keys:
            yield from _cache_leaves(tcache[k], jcache[k], f"{path}/{k}")
    else:
        assert tuple(tcache.shape) == jcache.shape, path
        yield path, (tcache, jcache)


def test_float32_compute_matches(phi4, monkeypatch):
    """With ``COMPUTE_DTYPE`` float32 in both packages the logits of the
    prefill and of the 8th decode step agree to float32 rounding: the
    algorithm, not the bf16 rounding, is compared (phi4's norm scales
    non-zero)."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jc, pc, jp, tp = phi4
    b, s = 2, 40
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (b, s + 8)).astype(np.int32)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc, POL, max_len=s + 8)
    tl, tcache = lm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pc, max_len=s + 8)
    assert tcache[0]["0"]["k"].dtype == torch.float32
    np.testing.assert_allclose(tl.numpy()[:, : jc.vocab_size], np.asarray(jl)[:, : jc.vocab_size],
                               rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(jl)).max()))
    for i in range(8):
        jl, jcache = jlm.decode_step(jp, jcache, {"tokens": jnp.asarray(toks[:, s + i : s + i + 1])},
                                     jnp.int32(s + i), jc, POL)
        tl, tcache = lm.decode_step(tp, tcache, {"tokens": torch.from_numpy(toks[:, s + i : s + i + 1])},
                                    s + i, pc)
    np.testing.assert_allclose(tl.numpy()[:, : jc.vocab_size], np.asarray(jl)[:, : jc.vocab_size],
                               rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(jl)).max()))


def test_slot_pos_prefix_and_seq_lens(phi4, monkeypatch):
    """``slot_pos`` stays the prefix ``[0, n)``; each decode step hands the
    kernel ``slot_pos`` with ``slot_lo = -1`` (the windowed layers' rule,
    one validity path), under which it attends to ``min(pos + 1, W)``
    slots; writes past the cache (``pos >= W``) are no-ops, as in the
    reference."""
    jc, pc, jp, tp = phi4
    b, s, w = 2, 12, 14
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (b, s + 4)).astype(np.int32)
    _, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc, POL, max_len=w)
    _, tcache = lm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pc, max_len=w)
    seen = []
    real = L.ops.decode_attention

    def spy(q, k, v, *, seq_lens=None, sm_scale=None, slot_pos=None, slot_lo=-1):
        assert seq_lens is None and slot_lo == -1
        seen.append([int(((slot_pos >= 0) & (slot_pos > slot_lo)).sum())] * q.shape[0])
        return real(q, k, v, sm_scale=sm_scale, slot_pos=slot_pos, slot_lo=slot_lo)

    monkeypatch.setattr(L.ops, "decode_attention", spy)
    for pos in range(s, s + 4):  # pos 12, 13 fill the cache; 14, 15 fall past it
        t = toks[:, pos : pos + 1]
        jl, jcache = jlm.decode_step(jp, jcache, {"tokens": jnp.asarray(t)}, jnp.int32(pos),
                                     jc, POL)
        tl, tcache = lm.decode_step(tp, tcache, {"tokens": torch.from_numpy(t)}, pos, pc)
        assert_bf16_close(tl, jl, jc.vocab_size, f"pos {pos}")
        for seg in tcache:
            sp = seg["0"]["slot_pos"]
            n = min(pos + 1, w)
            assert torch.equal(sp, torch.where(torch.arange(w) < n, torch.arange(w), -1)
                               .to(torch.int32).expand_as(sp))
        assert seen[-pc.n_layers:] == [[min(pos + 1, w)] * b] * pc.n_layers
        np.testing.assert_array_equal(tcache[0]["0"]["slot_pos"].numpy(),
                                      np.asarray(jcache[0]["0"]["slot_pos"]))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_configs_are_the_references(arch):
    """The port's copy of each config, and its reduced form, field for
    field equal to ``repro.configs``'."""
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for port, ref in ((ARCHS[arch], JAX_ARCHS[arch]),
                      (ARCHS[arch].reduced(), JAX_ARCHS[arch].reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


NEW_PATHS = ["llava-next-mistral-7b", "mixtral-8x22b", "musicgen-large", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_every_config_builds_params_and_caches(arch):
    """Every config of the zoo, reduced, builds its parameters (keys,
    shapes and dtypes the reference's) and its decode caches on the CPU:
    the port refuses none (experts, vlm and audio included)."""
    cfg = ARCHS[arch].reduced()
    params = lm.init_params(cfg, 0, device=CPU)
    ref = jlm.abstract_params(JAX_ARCHS[arch].reduced(), POL)
    got = list(_cache_leaves(params, ref))
    assert got and all(str(t.dtype).split(".")[-1] == str(j.dtype) for _, (t, j) in got)
    caches = lm.init_cache(cfg, 2, 8, device=CPU)
    want = jlm.init_cache(JAX_ARCHS[arch].reduced(), 2, 8, POL)
    assert len(list(_cache_leaves(caches, want))) == len(jax.tree.leaves(want))


def _batch(cfg, toks: np.ndarray, rng=None) -> tuple[dict, dict, int]:
    """(reference batch, port batch, vision prefix length) for tokens of
    ``cfg``'s front end; a vlm batch given ``rng`` also carries random
    patch embeddings ``[B, Nv, D]``."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.modality == "vlm" and rng is not None:
        ve = rng.normal(size=(toks.shape[0], cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        jb["vision_embed"], tb["vision_embed"] = jnp.asarray(ve), torch.from_numpy(ve)
        return jb, tb, cfg.vision_tokens
    return jb, tb, 0


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    if cfg.modality == "audio":
        shape = (*shape, cfg.n_codebooks)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", NEW_PATHS)
def test_moe_and_front_ends_prefill_and_decode_match(arch, compute, monkeypatch):
    """qwen3-moe (non-zero QK-norm scales) and mixtral (experts; 12 q / 2
    KV heads, group 6; its layers ``swa``, window 64, after a prefill of 96
    tokens, so that its ring is misaligned), llava (16 patch embeddings
    before 48 text tokens; decode continues at position 16 + 48) and
    musicgen (4 codebooks: tokens ``[B, S, 4]``, logits ``[B, 4, Vp]``)
    reduced: prefill(S) and 4 teacher-forced decode steps (qwen3-moe 8),
    logits and caches as the reference's — two bf16 steps under bf16
    compute, 1e-5 of the largest logit under float32 compute.  The
    reference runs op by op: under ``jax.jit`` XLA fuses musicgen's bf16
    sum of four codebook embeddings and rounds it elsewhere than its own
    eager run, which rounds after each add, as the port does."""
    if compute == "float32":
        monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jc, pc = _cfgs(arch)
    jp, tp = _params(jc, pc)
    b, s, extra = 2, 96 if pc.window else 48, 8 if arch in NONZERO else 4
    toks = _tokens(pc, (b, s + extra), 7)
    rng = np.random.default_rng(8)
    jb, tb, nv = _batch(pc, toks[:, :s], rng)
    max_len = nv + s + extra

    def close(t, j, msg, vocab=True):
        if vocab:
            t, j = t[..., : jc.vocab_size], j[..., : jc.vocab_size]
        if compute == "bfloat16":
            assert_bf16_close(t, j, msg=msg)
        else:
            j = _f32(j)
            np.testing.assert_allclose(_f32(t), j, rtol=1e-5, atol=1e-5 * np.abs(j).max(),
                                       err_msg=msg)

    jl, jcache = jlm.prefill(jp, jb, jc, POL, max_len=max_len)
    tl, tcache = lm.prefill(tp, tb, pc, max_len=max_len)
    head = (b, pc.n_codebooks, lm.padded_vocab(pc)) if pc.modality == "audio" \
        else (b, lm.padded_vocab(pc))
    assert tl.shape == head and (tl[..., jc.vocab_size:] == -1e30).all()
    close(tl, jl, f"{arch} prefill")
    for i in range(extra):
        t = toks[:, s + i : s + i + 1]
        jl, jcache = jlm.decode_step(jp, jcache, {"tokens": jnp.asarray(t)},
                                     jnp.int32(nv + s + i), jc, POL)
        tl, tcache = lm.decode_step(tp, tcache, {"tokens": torch.from_numpy(t)}, nv + s + i, pc)
        assert tl.shape == head
        close(tl, jl, f"{arch} decode {i}")
    for path, (t, j) in _cache_leaves(tcache, jcache):
        if path.endswith("slot_pos"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)
        else:
            close(t, j, path, vocab=False)


def test_init_params_structure_and_seed():
    cfg = ARCHS["phi4-mini-3.8b"].reduced()
    a, b = lm.init_params(cfg, 3, device=CPU), lm.init_params(cfg, 3, device=CPU)
    c = lm.init_params(cfg, 4, device=CPU)
    ref = jlm.init_params(JAX_ARCHS["phi4-mini-3.8b"].reduced(), jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat) == len(jax.tree.leaves(ref))
    names = {jax.tree_util.keystr(k): v for k, v in flat.items()}

    def walk(t, path=""):
        for k, v in t.items():
            yield from walk(v, f"{path}['{k}']") if isinstance(v, dict) else [(f"{path}['{k}']", v)]

    port = dict(walk(a))
    assert port.keys() == names.keys()
    for key, v in port.items():
        assert tuple(v.shape) == names[key].shape, key
        assert str(v.dtype).split(".")[-1] == str(names[key].dtype), key
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(walk(a), walk(b)))
    assert not torch.equal(a["embed"]["tok"], c["embed"]["tok"])
    assert 0.9 < a["embed"]["tok"].float().std().item() < 1.1


def _leaves_with_paths(tree, path=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves_with_paths(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-1.3b", "recurrentgemma-9b",
                                  "qwen3-moe-30b-a3b"])
def test_init_params_equal_the_reference(arch, record_property):
    """``lm.init_params(cfg, s)`` draws the reference's
    ``init_params(cfg, PRNGKey(s))`` (one mixer family each: full
    attention, ssm, rglru with local attention, experts): every float32
    leaf within 2 ulp, every bfloat16 leaf within one bfloat16 ulp; the
    share of bit-equal leaves and values is recorded."""
    jc, pc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    ref = dict(_leaves_with_paths(jlm.init_params(jc, jax.random.PRNGKey(7))))
    got = dict(_leaves_with_paths(lm.init_params(pc, 7, device=CPU)))
    assert got.keys() == ref.keys()
    equal_leaves, values, equal_values = 0, 0, 0
    for path, t in got.items():
        want = np.asarray(ref[path], np.float64)
        mine = t.double().numpy()
        assert mine.shape == want.shape, path
        if t.dtype == torch.bfloat16:
            step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
            limit = 1
        else:
            step = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
            limit = 2
        assert (np.abs(mine - want) <= limit * step).all(), path
        equal_leaves += int(np.array_equal(mine, want))
        values += want.size
        equal_values += int((mine == want).sum())
    record_property("bit_equal_leaves", f"{equal_leaves}/{len(got)}")
    record_property("bit_equal_values", equal_values / values)
    print(f"{arch}: {equal_leaves}/{len(got)} leaves and {equal_values / values:.6f} of "
          "the values bit-equal")
    assert equal_values / values > 0.99


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_float32_compute_matches(arch, monkeypatch):
    """mamba2 / recurrentgemma reduced with ``COMPUTE_DTYPE`` float32 in
    both packages: prefill and 3 decode steps to ``1e-3`` of the largest
    logit, every cache leaf to ``1e-3``."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jc, pc = _cfgs(arch)
    jp, tp = _params(jc, pc)
    b, s = 2, 40
    toks = np.random.default_rng(6).integers(0, jc.vocab_size, (b, s + 3)).astype(np.int32)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc, POL, max_len=s + 3)
    tl, tcache = lm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pc, max_len=s + 3)

    def close(t, j, msg):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.float().numpy(), j, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(j).max()), err_msg=msg)

    close(tl[:, : jc.vocab_size], jl[:, : jc.vocab_size], "prefill")
    for i in range(3):
        t = toks[:, s + i : s + i + 1]
        jl, jcache = jlm.decode_step(jp, jcache, {"tokens": jnp.asarray(t)}, jnp.int32(s + i),
                                     jc, POL)
        tl, tcache = lm.decode_step(tp, tcache, {"tokens": torch.from_numpy(t)}, s + i, pc)
        close(tl[:, : jc.vocab_size], jl[:, : jc.vocab_size], f"decode {i}")
    for path, (t, j) in _cache_leaves(tcache, jcache):
        assert t.dtype == (torch.int32 if path.endswith("slot_pos") else torch.float32), path
        close(t, j, path)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_matches_forward(arch):
    """prefill(S) + decode(token S) == forward(S + 1)'s last logits within
    0.05, as ``tests/test_models.py:88-117`` holds the reference (bf16)."""
    cfg = ARCHS[arch].reduced()
    params = lm.init_params(cfg, 0, device=CPU)
    b, s = 2, 64
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    h = lm.forward(params, lm.embed_inputs(params, {"tokens": toks}, cfg), cfg)
    ref = lm.lm_logits(params, h[:, -1:], cfg)[:, 0]
    _, caches = lm.prefill(params, {"tokens": toks[:, :s]}, cfg, max_len=s + 1)
    out, _ = lm.decode_step(params, caches, {"tokens": toks[:, s:]}, s, cfg)
    err = (out - ref)[:, : cfg.vocab_size].abs().max().item()
    assert err < 0.05, f"{arch}: {err}"


@pytest.mark.parametrize("s,steps", [(128, 8), (96, 4)])
def test_local_ring_buffer_matches(monkeypatch, s, steps):
    """recurrentgemma reduced (``local_window`` 64) under float32 compute:
    an aligned prefill (S = 128, two windows) whose decode overwrites a slot
    every step, and a misaligned one (S = 96): slot 0 then holds position
    32, outside the window at position 96, and slot 32 takes 96 while 64
    is still inside it, so the valid slots are not a prefix.  Logits and
    ``slot_pos`` equal the reference's at every step.  Both packages run the
    same float32 arithmetic summed in other orders (3e-7 of the largest
    logit apart), so the bound is 1e-5 of it: attending to the first 63
    slots instead (a prefix) moves the logits by 1e-3 of it."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    jc, pc = _cfgs("recurrentgemma-9b")
    assert pc.local_window == 64 and pc.layer_pattern[2] == "local"
    jp, tp = _params(jc, pc)
    toks = np.random.default_rng(s).integers(0, jc.vocab_size, (2, s + steps)).astype(np.int32)
    jl, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc, POL, max_len=s + steps)
    tl, tcache = lm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pc, max_len=s + steps)
    prefix_seen = []
    for i in range(steps):
        pos, t = s + i, toks[:, s + i : s + i + 1]
        jl, jcache = jlm.decode_step(jp, jcache, {"tokens": jnp.asarray(t)}, jnp.int32(pos),
                                     jc, POL)
        tl, tcache = lm.decode_step(tp, tcache, {"tokens": torch.from_numpy(t)}, pos, pc)
        ref = np.asarray(jl)[:, : jc.vocab_size]
        np.testing.assert_allclose(tl.numpy()[:, : jc.vocab_size], ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=f"pos {pos}")
        sp = tcache[0]["2"]["slot_pos"][0]
        np.testing.assert_array_equal(sp.numpy(), np.asarray(jcache[0]["2"]["slot_pos"][0]))
        valid = ((sp >= 0) & (sp > pos - 64)).int()
        prefix_seen.append(bool((valid.cummin(0).values == valid).all()))
    assert prefix_seen == [s % 64 == 0] * steps  # the misaligned ring is never a prefix


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_init_params(arch):
    """The parameter tree of the new mixers equals the reference's in keys,
    shapes and dtypes, and the special inits land in their ranges: A in
    [1, 16], softplus(dt_bias) in [1e-3, 0.1], a^c = exp(-c softplus(lam) / 2)
    in [0.9, 0.999] (``repro/models/lm.py:233-252``)."""
    cfg = ARCHS[arch].reduced()
    params = lm.init_params(cfg, 5, device=CPU)
    ref = jlm.init_params(JAX_ARCHS[arch].reduced(), jax.random.PRNGKey(0))
    tree = convert.lm_params(jax.tree.map(lambda x: np.asarray(x, np.float32), ref), cfg, CPU)
    assert [(p, tuple(t[0].shape), t[0].dtype) for p, t in _cache_leaves(params, tree)] == \
           [(p, tuple(t[1].shape), t[1].dtype) for p, t in _cache_leaves(params, tree)]
    m = params["seg0"]["m0"]
    if arch == "mamba2-1.3b":
        a = torch.exp(m["A_log"])
        assert a.min() >= 1.0 - 1e-5 and a.max() <= 16.0 + 1e-4
        dt = torch.nn.functional.softplus(m["dt_bias"])
        assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 0.1 * (1 + 1e-4)
    else:
        ac = torch.exp(-L._LRU_C * torch.nn.functional.softplus(m["lam"]) / 2.0)
        assert ac.min() >= 0.9 - 1e-5 and ac.max() <= 0.999 + 1e-5
        assert m["conv"].dtype == torch.bfloat16 and m["lam"].dtype == torch.float32
    assert not torch.equal(m["wx"], lm.init_params(cfg, 6, device=CPU)["seg0"]["m0"]["wx"])
