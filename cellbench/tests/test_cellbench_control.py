"""The control at a size a test run holds: the plain reference put in the
program's place one precision below the configuration's comes out not
correct, on three seeds, where the program passes.

* SNN (float32): the network run free with its weights rounded to TF32,
  16,384 neurons over the cell's steps, judged as the program's raster is,
  against the real cell's limit;
* serving (bf16): the reference with every product's operands in fp8, the
  token it puts first at each row, against the tiny cell's limit (set
  between the program's and the control's readings at that size).
"""
from __future__ import annotations

import pytest
import torch
from conftest import DATA

from cellbench import brain, harness, spec
from cellbench.reference import lif


@pytest.mark.parametrize("seed", [201, 202, 203])
def test_the_tf32_control_fails_the_spike_check(seed):
    cell = spec.find_cell("brain131k.sparse")
    cfg = cell.config
    n_pop = 16384 // cfg["neurons_per_population"]
    p = brain.population_probabilities(n_populations=n_pop, n_regions=n_pop // 16,
                                       total_neurons=cfg["model"]["total_neurons"], seed=0)
    syn = brain.sample_synapses(p, cfg["neurons_per_population"], 8, seed=seed, device="cpu",
                                **cfg["synapses"])
    m = syn.n_blocks * syn.block
    drive = brain.drive(m, *cfg["drive"], seed=seed, sim=0, device="cpu").numpy()
    neuron = lif.LIF(**{k: v for k, v in cfg["neuron"].items()
                        if k in lif.LIF.__dataclass_fields__})
    w = lif.weights(syn.pre, syn.post, syn.weight, m)
    steps = cell.params["steps"]
    sound = lif.simulate(w, drive, steps, neuron)
    assert lif.judge(sound, w, drive, neuron)["margin_mv"] == 0.0
    low = lif.simulate(lif.weights(syn.pre, syn.post, lif.tf32(syn.weight), m), drive, steps,
                       neuron)
    got = lif.judge(low, w, drive, neuron)
    assert got["margin_mv"] > cell.params["margin_limit_mv"], got


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_fp8_control_fails_the_logit_check(seed):
    cell = spec.find_cell("tiny-lm.serve-chat", bench_file=DATA / "benchmark.json",
                          bench_dir=DATA)
    ctx = harness.RunContext(cell=cell, seed=seed, device=torch.device("cpu"), t0=0.0)
    got = spec.traffic_driver(cell).readings(ctx, control=True)
    assert got["logit_gap"] <= cell.params["gap_limit"] < got["control_logit_gap"], got
