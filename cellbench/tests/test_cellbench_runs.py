"""Each traffic driver's control flow at a tiny size on the CPU: a whole
run, measured and traced, prints a correct result with the cell's metrics;
and with the timed path broken underneath, the same run says ``correct``
is false."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import run_tiny

CELLS = {"tiny-brain.sparse": ({"sim_step_ms", "setup_s"},
                               {"exchange_bytes.sim", "mfu.sim"}),
         "tiny-lm.serve-chat": ({"serve_tok_s", "setup_s"}, {"mfu.serve"})}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_a_correct_result(cell, trace):
    rc, line, err = run_tiny(cell, 3_000_000_019, trace=trace)
    assert rc == 0, err
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    e2e, per_layer = CELLS[cell]
    if trace:
        # on the CPU nothing runs on a card: the device's readers return nothing
        assert set(line["metrics"]) == per_layer
        assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == e2e
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_the_same_seed_gives_the_same_inputs():
    from cellbench import brain, lmweights, prompts

    a = prompts.call(2**31 + 5, 3, 16, 20, 0.6, 5, 40, 512)
    assert a == prompts.call(2**31 + 5, 3, 16, 20, 0.6, 5, 40, 512)
    assert a != prompts.call(2**31 + 6, 3, 16, 20, 0.6, 5, 40, 512)
    assert sorted(map(len, a)) == sorted(map(len, prompts.call(7, 0, 16, 20, 0.6, 5, 40, 512)))
    cfg = {"hidden_size": 16, "intermediate_size": 32, "vocab_size": 64,
           "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 8,
           "num_hidden_layers": 2, "init": {"std": 0.02, "embed_std": 0.02, "norm_std": 0.1}}
    w1, w2 = (lmweights.make(cfg, 2**32 + 1, "cpu") for _ in range(2))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    p = brain.population_probabilities(n_populations=16, n_regions=4, total_neurons=1000,
                                       seed=0)
    s1, s2 = (brain.sample_synapses(p, 2, 4, seed=2**33, synapse_p=0.3, w_scale=8.0,
                                    inhibitory_frac=0.2, scale=0.05, device="cpu")
              for _ in range(2))
    assert torch.equal(s1.tiles, s2.tiles) and np.array_equal(s1.weight, s2.weight)


# -- planted faults: the timed path broken underneath -----------------------------


def test_an_exchange_left_out_is_caught(monkeypatch):
    from repro_torch.snn import LoopbackComm

    def lost(self, x, pairs, axis):
        out = torch.zeros_like(x)
        self._charge(0)
        return out

    monkeypatch.setattr(LoopbackComm, "ppermute", lost)
    rc, line, _ = run_tiny("tiny-brain.sparse", 41)
    assert rc == 0 and not line["correct"]
    assert line["checks"]["spike_margin_mv"]["value"] > line["checks"]["spike_margin_mv"]["limit"]


def test_a_flipped_spike_is_caught(monkeypatch):
    from repro_torch.snn import DistributedSNN

    real = DistributedSNN.run

    def flipped(self, n_steps, **kw):
        raster = real(self, n_steps, **kw)
        raster[n_steps // 2, 7] = 1.0 - raster[n_steps // 2, 7]
        return raster

    monkeypatch.setattr(DistributedSNN, "run", flipped)
    rc, line, _ = run_tiny("tiny-brain.sparse", 42)
    assert rc == 0 and not line["correct"]
    assert line["checks"]["spike_margin_mv"]["value"] > 1e-3


def test_a_perturbed_synapse_is_caught(monkeypatch):
    """One weight of the tiles handed to the program made larger: the
    reference, which reads the benchmark's own synapse list, parts from it."""
    from cellbench import brain

    real = brain.sample_synapses

    def perturbed(*args, **kw):
        syn = real(*args, **kw)
        d, k = 0, 0
        nz = torch.nonzero(syn.tiles[d, k])
        i, j = nz[0].tolist()
        syn.tiles[d, k, i, j] += 40.0
        return syn

    monkeypatch.setattr(brain, "sample_synapses", perturbed)
    rc, line, _ = run_tiny("tiny-brain.sparse", 43)
    assert rc == 0 and not line["correct"]


def test_an_altered_token_is_caught(monkeypatch):
    from repro_torch.serve import ServeEngine

    real = ServeEngine.generate_continuous

    def altered(self, prompts, max_new_tokens=32):
        out = real(self, prompts, max_new_tokens)
        for toks in out:
            toks[3] = (toks[3] + 1) % self.cfg.vocab_size
        return out

    monkeypatch.setattr(ServeEngine, "generate_continuous", altered)
    rc, line, _ = run_tiny("tiny-lm.serve-chat", 44)
    assert rc == 0 and not line["correct"]
    assert line["checks"]["logit_gap"]["value"] > line["checks"]["logit_gap"]["limit"]


def test_a_perturbed_weight_is_caught(monkeypatch):
    """One weight handed to the program changed (the first layer's
    attention out-projection, times 8): the reference, which draws the
    weights again, parts from it."""
    from cellbench.traffic import serve_offline

    real = serve_offline.program_params

    def perturbed(cfg, w):
        tree = real(cfg, w)
        tree["seg0"]["m0"]["wo"][0].mul_(8.0)
        return tree

    monkeypatch.setattr(serve_offline, "program_params", perturbed)
    rc, line, _ = run_tiny("tiny-lm.serve-chat", 45)
    assert rc == 0 and not line["correct"]
