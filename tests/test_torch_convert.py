"""``repro_torch.convert``: the reference engine's inputs (numpy arrays and
dataclass fields) become the port's weights, tiles, parameters and state,
and both engines compute the same raster from them."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.snn import (
    IzhikevichParams as JaxIzhikevich,
    LIFParams as JaxLIF,
    NeuronState as JaxState,
    SNNEngine as JaxEngine,
    expand_synapses_sparse as jax_expand_sparse,
    generate_brain_model as jax_brain_model,
    izhikevich_step as jax_izhikevich_step,
    lif_step as jax_lif_step,
)
from repro_torch import convert
from repro_torch.snn import (
    BlockSynapses,
    DistributedSNN,
    IzhikevichParams,
    LIFParams,
    SNNEngine,
    izhikevich_step,
    lif_step,
)
from tests.test_snn_sparse import _clustered_w
from tests.test_torch_snn import _assert_sustained, _drive

CPU = "cpu"


@pytest.mark.parametrize(
    "jax_params,cls",
    [(JaxLIF(tau_m=12.0, t_refrac=3.0), LIFParams),
     (JaxIzhikevich(a=0.1, d=2.0), IzhikevichParams)],
)
def test_params_roundtrip(jax_params, cls):
    p = convert.neuron_params(jax_params)
    assert isinstance(p, cls)
    assert dataclasses.asdict(p) == dataclasses.asdict(jax_params)
    assert convert.neuron_params(dataclasses.asdict(jax_params),
                                 kind=type(jax_params).__name__) == p


def test_dense_weights_give_the_reference_raster():
    w = _clustered_w(64, 8, seed=3)
    jp = JaxLIF(noise_sigma=0.0)
    drive = _drive(64, seed=1)
    ref = JaxEngine(w_syn=jnp.asarray(w), params=jp, i_ext=jnp.asarray(drive)).run(
        60, key=jax.random.PRNGKey(1))
    eng = SNNEngine(w_syn=convert.dense_weights(w, CPU),
                    params=convert.neuron_params(jp), i_ext=drive, device=CPU)
    raster = eng.run(60).spikes.numpy()
    _assert_sustained(raster)
    np.testing.assert_array_equal(raster, np.asarray(ref.spikes))


def test_block_synapses_from_reference_fields():
    """The reference's expanded tiles, carried over field by field, drive
    the port's sparse and ragged exchanges to the JAX engine's raster on
    the densified tiles; the device tiles equal ``padded()``."""
    bm = jax_brain_model(n_populations=32, n_regions=8, total_neurons=10**6, seed=1)
    jsyn, _ = jax_expand_sparse(bm.graph, 2, 8, seed=2)
    syn = convert.block_synapses(jsyn.indptr, jsyn.src_ids, jsyn.blocks, jsyn.n_blocks)
    assert isinstance(syn, BlockSynapses) and syn.nnzb == jsyn.nnzb
    src, blk = convert.padded_tiles(syn, CPU)
    want_src, want_blk = jsyn.padded()
    np.testing.assert_array_equal(src.numpy(), want_src)
    np.testing.assert_array_equal(blk.numpy(), want_blk)
    assert src.dtype == torch.int32
    jp = JaxLIF(noise_sigma=0.0)
    drive = _drive(syn.n_neurons, seed=3)
    ref = np.asarray(JaxEngine(w_syn=jnp.asarray(jsyn.to_dense()), params=jp,
                               i_ext=jnp.asarray(drive)).run(60, key=jax.random.PRNGKey(3)).spikes)
    _assert_sustained(ref)
    unwired = SNNEngine(w_syn=np.zeros_like(jsyn.to_dense()), params=convert.neuron_params(jp),
                        i_ext=drive, device=CPU).run(60).spikes.numpy()
    assert (unwired != ref).any()  # the carried tiles shape the raster
    for exch in ("sparse", "ragged"):
        eng = DistributedSNN(mesh=(4, 2), params=convert.neuron_params(jp),
                             exchange=exch, i_ext=drive, syn=syn, device=CPU,
                             tiles=(src, blk))
        np.testing.assert_array_equal(eng.run(60).numpy(), ref, err_msg=exch)
    # a fresh device copy per call: engines share one only through tiles=
    assert convert.padded_tiles(syn, CPU)[1] is not blk


@pytest.mark.parametrize("model", ["lif", "izhikevich"])
def test_state_carried_across(model):
    """A mid-run state (refractory countdowns included) carried across
    steps both implementations identically."""
    rng = np.random.default_rng(4)
    n = 512
    if model == "lif":
        jp, jstep, tstep = JaxLIF(), jax_lif_step, lif_step
        v = rng.uniform(-66.0, -49.0, n).astype(np.float32)
        u = (rng.random(n) < 0.3) * rng.uniform(0.0, 2.0, n).astype(np.float32)
        drive = 2.0
    else:
        jp, jstep, tstep = JaxIzhikevich(), jax_izhikevich_step, izhikevich_step
        v = rng.uniform(-70.0, 25.0, n).astype(np.float32)
        u = rng.uniform(-15.0, -10.0, n).astype(np.float32)
        drive = 8.0
    js = JaxState(v=jnp.asarray(v), u=jnp.asarray(u), key=jax.random.PRNGKey(0))
    ts = convert.neuron_state(v, u, CPU)
    tp = convert.neuron_params(jp)
    i_syn = np.full(n, drive, np.float32)
    for _ in range(20):
        js, jspk = jstep(js, jnp.asarray(i_syn), jp)
        ts, tspk = tstep(ts, torch.from_numpy(i_syn), tp)
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=1e-4, rtol=0)


@pytest.mark.parametrize("model", ["lif", "izhikevich"])
def test_noisy_state_carried_across(model):
    """A mid-run state with the reference's key (``neuron_state(..., key=)``
    takes its uint32 words) steps as the reference's at ``noise_sigma=2``:
    the same spikes every step and the same key after 20 steps."""
    rng = np.random.default_rng(5)
    n = 512
    if model == "lif":
        jp, jstep, tstep = JaxLIF(noise_sigma=2.0), jax_lif_step, lif_step
        v = rng.uniform(-66.0, -49.0, n).astype(np.float32)
        u = np.zeros(n, np.float32)
        drive = 2.0
    else:
        jp, jstep, tstep = JaxIzhikevich(noise_sigma=2.0), jax_izhikevich_step, izhikevich_step
        v = rng.uniform(-70.0, 25.0, n).astype(np.float32)
        u = rng.uniform(-15.0, -10.0, n).astype(np.float32)
        drive = 8.0
    key = jax.random.split(jax.random.PRNGKey(8))[1]
    js = JaxState(v=jnp.asarray(v), u=jnp.asarray(u), key=key)
    ts = convert.neuron_state(v, u, CPU, key=np.asarray(key))
    tp = convert.neuron_params(jp)
    i_syn = np.full(n, drive, np.float32)
    fired = 0
    for _ in range(20):
        js, jspk = jstep(js, jnp.asarray(i_syn), jp)
        ts, tspk = tstep(ts, torch.from_numpy(i_syn), tp)
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
        fired += int(tspk.sum())
    assert fired > 0
    np.testing.assert_array_equal(ts.key.numpy(), np.asarray(js.key))


@pytest.mark.parametrize("arch", ["deepseek-7b", "phi4-mini-3.8b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "qwen3-moe-30b-a3b", "mixtral-8x22b",
                                  "llava-next-mistral-7b", "musicgen-large"])
def test_lm_params_carry_the_reference_tree_bitwise(arch):
    """``lm_params`` of the JAX ``init_params`` tree (leaves handed over as
    float32: bf16 → f32 → bf16 is exact) holds the same values in the same
    dtypes, leaf for leaf — the recurrent mixers' float32 leaves (``A_log``,
    ``dt_bias``, ``d_skip``, ``norm``, ``lam``) and bf16 ``conv*`` leaves,
    the experts' ``router``, ``w_in``, ``w_gate``, ``w_out``, and the front
    ends' ``embed/vision_proj``, ``embed/codebooks`` and
    ``unembed_codebooks`` too; a tree with a missing or misshapen leaf
    raises."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models import lm as jlm
    from repro_torch.configs import ARCHS

    jc, pc = JAX_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    jp = jlm.init_params(jc, jax.random.PRNGKey(7))
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    tp = convert.lm_params(tree, pc, CPU)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jleaves) == len(jax.tree.leaves(tp))
    for path, leaf in jleaves:
        node = tp
        for k in path:
            node = node[k.key]
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(node.float().numpy(), np.asarray(leaf, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    del tree["seg0"]["ln1_0"]
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params(tree, pc, CPU)
    tree["seg0"]["ln1_0"] = np.zeros((1, pc.d_model + 1), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params(tree, pc, CPU)
