"""The benchmark's frozen copies and its counts, each pinned: to the
program's original where there is one, and to values worked out by hand at
a small shape."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cellbench import brain, counts, peaks, prompts
from cellbench.reference import lif, schedule
from cellbench.traffic import serve_offline


@pytest.mark.parametrize("n_pop, n_regions, seed", [(64, 8, 0), (96, 12, 5), (2048, 128, 0)])
def test_population_probabilities_equal_the_ports_model(n_pop, n_regions, seed):
    from repro_torch.snn import generate_brain_model

    g = generate_brain_model(n_populations=n_pop, n_regions=n_regions, total_neurons=10**6,
                             seed=seed).graph
    want = np.zeros((n_pop, n_pop))
    want[g.rows(), g.indices] = g.probs
    got = brain.population_probabilities(n_populations=n_pop, n_regions=n_regions,
                                         total_neurons=10**6, seed=seed)
    assert np.array_equal(got, want)
    assert np.array_equal(got, got.T) and not got.diagonal().any()
    assert got.max() <= 1.0 and got[got > 0].min() >= 0.05


def test_the_sampler_draws_the_model_class():
    """16 populations of 64 neurons on 4 ranks: no neuron onto itself,
    Dale's law, gamma(2, 4) weights scaled by 0.05, connection frequency
    P · synapse_p, and the tiles holding exactly the synapse list."""
    p = brain.population_probabilities(n_populations=16, n_regions=4, total_neurons=1000,
                                       seed=1)
    syn = brain.sample_synapses(p, 64, 4, seed=9, synapse_p=0.3, w_scale=8.0,
                                inhibitory_frac=0.2, scale=0.05, device="cpu")
    m, b = 1024, syn.block
    assert b == 256 and not np.any(syn.pre == syn.post)
    signs = {}
    for i, w in zip(syn.pre, syn.weight):
        assert signs.setdefault(int(i), w > 0) == (w > 0)
    inhib = np.mean([not s for s in signs.values()])
    assert 0.15 < inhib < 0.25
    mag = np.abs(syn.weight) / 0.05
    assert abs(mag.mean() - 8.0) < 0.2 and abs(mag.var() - 32.0) < 2.5  # gamma(2, 4)
    pop = np.arange(m) // 64
    same = pop[syn.pre] == pop[syn.post]
    assert abs(same.sum() / (16 * 64 * 63) - 0.3) < 0.01
    dense = np.zeros((m, m), np.float32)
    dense[syn.pre, syn.post] = syn.weight
    for d in range(4):
        real = int(syn.stored[:, d].sum())  # then zero tiles pointing at source 0
        for k, s in enumerate(syn.src[d].tolist()):
            tile = syn.tiles[d, k].numpy()
            if k < real:
                assert np.array_equal(tile, dense[s * b:(s + 1) * b, d * b:(d + 1) * b])
            else:
                assert s == 0 and not tile.any()
    assert syn.stored.sum() == np.count_nonzero(
        [dense[s * b:(s + 1) * b, d * b:(d + 1) * b].any() for s in range(4) for d in range(4)])


def test_prompt_lengths_by_hand():
    # quantiles 1/8, 3/8, 5/8, 7/8 of N(0, 1): ±0.3186, ±1.1503; 100 · exp(0.5 z)
    assert prompts.lengths(4, 100, 0.5, 50, 200).tolist() == [56, 85, 117, 178]
    assert prompts.lengths(4, 100, 0.5, 60, 150).tolist() == [60, 85, 117, 150]
    lens = prompts.lengths(128, 300, 0.6, 64, 1000)
    assert lens.min() == 64 and lens.max() == 1000 and lens.sum() == 45177


def test_valid_pairs_and_bound_by_hand():
    assert counts.valid_pairs(4, 4, True, None) == 10
    assert counts.valid_pairs(4, 4, True, 2) == 7
    assert counts.valid_pairs(2, 4, True, None, q_offset=2) == 7
    assert counts.valid_pairs(3, 5, False, None) == 15
    assert counts.bound(3.35e9, 0.0) == (1.0, "bytes")
    assert counts.bound(0.0, 67e9) == (1.0, "operations")
    assert counts.least_s(989e9, 1.0) == 1e-3


SMALL = {"hidden_size": 4, "intermediate_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "head_dim": 2, "num_hidden_layers": 3, "vocab_size": 10}


def test_lm_counts_by_hand():
    # a layer: q, k, v 4·(2 + 1 + 1)·2 = 32, out 2·2·4 = 16, MLP 3·4·8 = 96
    assert counts.lm_weights(SMALL) == {"layers": 432, "unembed": 40}
    c = counts.prefill(SMALL, 3)  # 6 causal pairs
    assert c == {"flops": 2 * (432 * 3 + 40) + 4 * 2 * 2 * 6 * 3,
                 "bytes": 2 * (432 + 40) + 2 * 3 * 1 * 2 * 2 * 3,
                 "attn_flops": 4 * 2 * 2 * 6 * 3, "attn_bytes": 2 * 3 * 6 * 2 * 3}
    c = counts.decode(SMALL, [5, 7])
    assert c == {"flops": 2 * 472 * 2 + 4 * 2 * 2 * 12 * 3,
                 "bytes": 2 * 472 + 2 * 12 * 1 * 2 * 2 * 3,
                 "attn_flops": 4 * 2 * 2 * 12 * 3,
                 "attn_bytes": 2 * 12 * 1 * 2 * 2 * 3 + 2 * 2 * 2 * 2 * 2 * 3}


def test_the_serving_counts_leave_padding_out():
    """The work of a call hangs on the real prompt lengths and the tokens
    made: not on the bucket the prompts were padded to, nor on the steps
    that made no token."""
    lengths = [3, 5, 2]
    sched = schedule.plan(lengths, 2, 3)
    assert sched.plen == 8
    got = serve_offline.work(SMALL, lengths, sched)
    padded = dataclasses.replace(sched, plen=64, max_len=70, steps=sched.steps + ((),))
    assert serve_offline.work(SMALL, lengths, padded) == got
    want = sum(counts.least_s(**{k: counts.prefill(SMALL, n)[k] for k in ("flops",)},
                              nbytes=counts.prefill(SMALL, n)["bytes"]) for n in lengths)
    # decode: requests 0 and 1 make tokens 1, 2 at contexts 3 + 1, 5 + 1, then 3 + 2, 5 + 2;
    # request 2 makes tokens 1, 2 at contexts 2 + 1, 2 + 2
    for ctx in ([4, 6], [5, 7], [3], [4]):
        c = counts.decode(SMALL, ctx)
        want += counts.least_s(c["flops"], c["bytes"])
    assert got["least_s"] == pytest.approx(want, rel=1e-12)


def test_k1_and_step_counts_by_hand():
    fired = np.array([[2.0, 0.0], [1.0, 1.0]])  # 2 steps, 2 blocks
    tiles = np.array([2.0, 1.0])  # stored tiles per source block
    # rows read: 2·2 + 0 + 1·2 + 1·1 = 7 of 4 float32; 2 currents of 8 written
    assert counts.k1_bytes(fired, tiles, 4, 8) == 7 * 16 + 2 * 32
    assert counts.k1_flops(fired, tiles, 4) == 28
    s = counts.sim_step(fired, tiles, 4, 8, 100.0)
    assert s["bytes"] == 7 * 16 + 2 * 32 + 2 * (24 * 8 + 100)
    assert s["flops"] == 28 + 2 * 80
    assert s["least_ms"] == s["bytes"] / peaks.HBM_BYTES * 1e3 and s["by"] == "bytes"


def test_sparse_exchange_bytes_by_hand():
    stored = np.eye(4, dtype=bool)
    assert lif.sparse_exchange_bytes(stored, (2, 2), 8) == 0  # all within groups
    stored[0, 2] = True  # rank 0 (group 0) feeds rank 2 (group 1)
    assert lif.sparse_exchange_bytes(stored, (2, 2), 8) == 1 * 2 * (2 * 8 * 4)
    stored[3, 1] = True  # and group 1 feeds group 0
    assert lif.sparse_exchange_bytes(stored, (2, 2), 8) == 2 * 2 * (2 * 8 * 4)


def test_tf32_rounding_by_hand():
    x = np.float32([1 + 2**-11, 1 + 2**-12, -(1 + 2**-11), 3.0])
    assert lif.tf32(x).tolist() == [1 + 2**-10, 1.0, -(1 + 2**-10), 3.0]


def test_the_schedule_by_hand():
    s = schedule.plan([3, 5, 2], slots=2, new_tokens=3)
    assert (s.plen, s.max_len, s.prefills) == (8, 14, (0, 1, 2))
    assert s.steps == (((0, 1), (1, 1)), ((0, 2), (1, 2)), ((2, 1),), ((2, 2),))
    r = {q.index: (q.slot, q.owner, q.start, q.tokens) for q in s.requests}
    assert r == {0: (0, 1, 8, 3), 1: (1, 1, 8, 3), 2: (0, 2, 10, 3)}


def test_the_lif_reference_catches_a_flipped_spike():
    p = brain.population_probabilities(n_populations=32, n_regions=4, total_neurons=1000,
                                       seed=0)
    syn = brain.sample_synapses(p, 8, 8, seed=3, synapse_p=0.3, w_scale=8.0,
                                inhibitory_frac=0.2, scale=0.05, device="cpu")
    m = 256
    w = lif.weights(syn.pre, syn.post, syn.weight, m)
    drive = brain.drive(m, 3.0, 8.0, seed=3, sim=0, device="cpu").numpy()
    raster = lif.simulate(w, drive, 400, lif.LIF())
    assert raster.sum() > 1000
    assert lif.judge(raster, w, drive, lif.LIF()) == {
        "margin_mv": 0.0, "disagreements": 0}
    raster[200, np.nonzero(~raster[200])[0][0]] = True
    got = lif.judge(raster, w, drive, lif.LIF())
    assert got["disagreements"] >= 1 and got["margin_mv"] > 0.1


def test_the_ports_engine_agrees_with_the_schedule_and_the_reference():
    """Every request of a tiny call through the port's engine on the CPU,
    held to the plain reference under the schedule model: no served token
    below the reference's best by more than the bf16 program's rounding.
    The first fill's quirk matters: a request judged as if it decoded over
    its own prompt reads far worse."""
    from cellbench import lmweights
    from cellbench.reference import lm as ref_lm
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = {**SMALL, "name": "small", "hidden_size": 64, "intermediate_size": 128,
           "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
           "num_hidden_layers": 2, "vocab_size": 256, "tie_word_embeddings": True,
           "rope_theta": 10000.0, "init": {"std": 0.12, "embed_std": 0.02, "norm_std": 0.1}}
    w = lmweights.make(cfg, 5, "cpu")
    eng = ServeEngine(serve_offline.arch(cfg), serve_offline.program_params(cfg, w),
                      ServeConfig(batch_slots=3, temperature=0.0), device="cpu")
    asked = prompts.call(5, 0, 6, 10, 0.5, 3, 20, 256)  # two rounds of 3: inside the cache
    served = eng.generate_continuous(asked, max_new_tokens=6)
    sched = schedule.plan([len(a) for a in asked], 3, 6)
    model = ref_lm.Model({**cfg, "rms_norm_eps": 1e-6}, w, "cpu")
    everyone = list(range(len(asked)))
    seqs, targets = ref_lm.sequences(sched, asked, served, everyone)
    with torch.no_grad():
        g = ref_lm.gaps(model.logits(seqs), targets, served, 256)
    assert g.size == 6 * 6 and g.max() < 0.02
    naive = dataclasses.replace(sched, requests=tuple(
        dataclasses.replace(r, owner=r.index) for r in sched.requests))
    seqs, targets = ref_lm.sequences(naive, asked, served, everyone)
    with torch.no_grad():
        g = ref_lm.gaps(model.logits(seqs), targets, served, 256)
    assert g.max() > 0.1


def test_partial_rotary_turns_only_the_first_dimensions():
    """``partial_rotary_factor`` 0.75 of a head of 8: the first 6
    dimensions turn as a head of 6 would, the last 2 stay."""
    from cellbench.reference import lm as ref_lm

    x = torch.randn(5, 3, 8)
    pos = np.arange(5) * 7
    got = ref_lm._rope(x, pos, 10000.0, 0.75)
    assert torch.equal(got[..., 6:], x[..., 6:])
    assert torch.equal(got[..., :6], ref_lm._rope(x[..., :6], pos, 10000.0))
    assert not torch.allclose(got[1:, :, :6], x[1:, :, :6])
