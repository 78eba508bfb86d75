"""The compiled step on the CPU: what a CUDA graph of a decode step needs
from the model, and the engines' ``graph`` switch.

A captured decode step is replayed at every position, so the position is
a 0-d int tensor on the device and every use of it (RoPE's angles, the
cache slot, the past-the-cache no-op, K4's window bound) is computed
there.  ``lm.decode_step`` at a tensor position must equal it at an int
bit for bit, logits and every cache leaf, and both must hold to the JAX
reference at ``tests/test_torch_lm.py``'s bf16 bound: for the reduced
phi4-mini-3.8b (two kv heads), mamba2-1.3b, recurrentgemma-9b (whose
local window of 64 wraps here), qwen2.5-14b (q/k/v biases) and yi-34b,
over a full-attention cache that fills and is then written past (a
no-op).  The replay itself runs only on the card
(``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.configs import ARCHS
from repro_torch.graphs import use_graph
from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.snn import DistributedSNN, LIFParams, SNNEngine
from test_torch_lm import POL, _cache_leaves, _cfgs, _params, assert_bf16_close

GRAPH_MODELS = ["mamba2-1.3b", "phi4-mini-3.8b", "qwen2.5-14b", "recurrentgemma-9b", "yi-34b"]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("arch", GRAPH_MODELS)
def test_tensor_position_equals_int_and_the_reference(arch):
    """prefill(60) with room for 64 positions, then 8 decode steps
    (positions 60-67): at 64-67 a full-attention write falls past the cache
    and the local window of recurrentgemma wraps to slots 0-3.  A tensor
    position gives the int position's logits and caches bit for bit; both
    hold to the reference's decode_step at the bf16 bound."""
    jc, pc = _cfgs(arch)
    jp, tp = _params(jc, pc)
    b, s, room, steps = 2, 60, 64, 8
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (b, s + steps)).astype(np.int32)
    _, jcache = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t}, jc, POL, max_len=room))(
        jp, jnp.asarray(toks[:, :s]))
    _, by_int = lm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])}, pc, max_len=room)
    by_tensor = _clone(by_int)
    dec = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, {"tokens": t}, pos, jc, POL))
    pos = torch.tensor(s, dtype=torch.int32)
    for i in range(steps):
        t = toks[:, s + i : s + i + 1]
        jl, jcache = dec(jp, jcache, jnp.asarray(t), jnp.int32(s + i))
        li, _ = lm.decode_step(tp, by_int, {"tokens": torch.from_numpy(t)}, s + i, pc)
        lt, _ = lm.decode_step(tp, by_tensor, {"tokens": torch.from_numpy(t)}, pos, pc)
        pos += 1
        assert torch.equal(lt, li), f"{arch} pos {s + i}: logits differ"
        for (path, (ti, _)), (_, (tt, _)) in zip(_cache_leaves(by_int, jcache),
                                                  _cache_leaves(by_tensor, jcache)):
            assert torch.equal(tt, ti), f"{arch} pos {s + i}: {path} differs"
        assert_bf16_close(li, jl, jc.vocab_size, f"{arch} pos {s + i}")
    for path, (t, j) in _cache_leaves(by_int, jcache):
        if path.endswith("slot_pos"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)
    if arch == "recurrentgemma-9b":  # the ring wrapped: slots 0-3 hold 64-67
        assert by_int[0]["2"]["slot_pos"][0, :4].tolist() == [64, 65, 66, 67]
    elif arch != "mamba2-1.3b":  # the writes past the cache changed nothing
        assert by_int[0]["0"]["slot_pos"][0].tolist() == list(range(room))


@pytest.mark.parametrize("lo", [-3, -1, 5, 40])
def test_decode_attention_takes_the_bound_as_a_device_scalar(lo):
    """K4's plain version (and the CPU dispatch) with ``slot_lo`` as a 0-d
    int32 tensor equals it with the int, on a ring whose valid slots are
    not a prefix."""
    g = torch.Generator().manual_seed(lo + 10)
    q = torch.randn((2, 4, 32), generator=g)
    k, v = (torch.randn((2, 2, 48, 32), generator=g) for _ in "kv")
    slot_pos = (torch.arange(48, dtype=torch.int32) + 20) % 60 - 8  # -8 .. 51, wrapped
    want = decode_attention_ref(q, k, v, slot_pos=slot_pos, slot_lo=lo)
    dev_lo = torch.tensor(lo, dtype=torch.int32)
    assert torch.equal(decode_attention_ref(q, k, v, slot_pos=slot_pos, slot_lo=dev_lo), want)
    assert torch.equal(ops.decode_attention(q, k, v, slot_pos=slot_pos, slot_lo=dev_lo), want)


def test_graph_switch():
    """``None`` replays on the card and runs eagerly on the CPU, ``False``
    runs eagerly, ``True`` on the CPU raises in every engine."""
    cpu = torch.device("cpu")
    assert use_graph(None, cpu) is False and use_graph(False, cpu) is False
    assert use_graph(None, torch.device("cuda")) is True
    assert use_graph(False, torch.device("cuda")) is False
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        use_graph(True, cpu)
    cfg = ARCHS["phi4-mini-3.8b"].reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    assert ServeEngine(cfg, params, ServeConfig(), device="cpu").graph is False
    with pytest.raises(ValueError, match="graph=True"):
        ServeEngine(cfg, params, ServeConfig(), device="cpu", graph=True)
    w = np.zeros((8, 8), np.float32)
    assert SNNEngine(w_syn=w, params=LIFParams(), device="cpu").graph is False
    with pytest.raises(ValueError, match="graph=True"):
        SNNEngine(w_syn=w, params=LIFParams(), device="cpu", graph=True)
    with pytest.raises(ValueError, match="graph=True"):
        DistributedSNN(mesh=(2,), w_syn=w, params=LIFParams(), device="cpu", graph=True)
