"""Traffic kind ``snn_sim``: back-to-back simulations of the distributed
brain model, a parameter sweep over the external drive.

Every simulation runs ``steps`` steps of ``repro_torch.snn.DistributedSNN``
from the resting state over the synapses the benchmark drew from the seed
(on the device, handed over as the engine's tiles), under a drive of its
own (uniform per neuron, drawn from the seed and the simulation's index),
through a fresh ``LoopbackComm`` whose byte ledger it keeps.  Each raster is
made boolean on the card, copied to the host and its spikes counted, as a
user who keeps the raster pays.  ``sim_step_ms`` is the window's wall time
over all the steps it completed, each simulation's start (its graph
capture) and copy included.

Parameters (``workloads/<cell>.json``): ``exchange``, ``steps``,
``min_sims`` (the reference checks one simulation drawn from the seed
among the first ``min_sims`` of the window; a traced window's last),
``trace_sims`` (simulations in a traced window, each run untraced first
under the same drive), ``margin_limit_mv`` (the limit of the spike
check).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from cellbench import brain, counts
from cellbench.harness import Check
from cellbench.reference import lif

#: steps of set-up's warm-up simulation
WARM_STEPS = 200


@dataclasses.dataclass
class State:
    ctx: object
    engine: object
    syn: brain.Synapses
    neuron: lif.LIF
    mesh: tuple[int, int]
    steps: int
    keep: int = 0  # the simulation the reference checks
    kept: dict = dataclasses.field(default_factory=dict)  # sim -> bool raster [T, M]
    ledgers: list = dataclasses.field(default_factory=list)  # per sim: its step_bytes
    rasters_shapes: list = dataclasses.field(default_factory=list)
    spikes: list = dataclasses.field(default_factory=list)
    sims: int = 0
    host: torch.Tensor | None = None  # the host's raster buffer (pinned on a card's host)
    spare: np.ndarray | None = None  # a kept raster's buffer, touched before the window
    unit_s: list = dataclasses.field(default_factory=list)  # each simulation's wall seconds


def _neuron(cfg: dict) -> lif.LIF:
    fields = {f.name for f in dataclasses.fields(lif.LIF)}
    return lif.LIF(**{k: float(v) for k, v in cfg["neuron"].items() if k in fields})


def setup(ctx) -> State:
    from repro_torch.snn import DistributedSNN, LIFParams
    from repro_torch.snn.sparse import BlockSynapses

    cfg, prm, dev = ctx.cell.config, ctx.cell.params, ctx.device
    if cfg["neuron"].get("noise_sigma", 0.0) or cfg["neuron"]["kind"] != "lif":
        raise ValueError("snn_sim runs noise-free LIF networks")
    mesh = tuple(cfg["mesh"])
    n_blocks = int(np.prod(mesh))
    p = brain.population_probabilities(**cfg["model"])
    ctx.log("population graph made")
    syn = brain.sample_synapses(p, cfg["neurons_per_population"], n_blocks, seed=ctx.seed,
                                device=dev, **cfg["synapses"])
    ctx.log(f"synapses drawn: {syn.pre.size} in {int(syn.stored.sum())} tiles")
    # the block-CSR's structure (which tiles exist); the values are the
    # device tiles handed over below, so a view of zeros stands for the host copy
    dst = np.repeat(np.arange(n_blocks), syn.stored.sum(0))
    src = np.concatenate([np.nonzero(syn.stored[:, d])[0] for d in range(n_blocks)])
    indptr = np.zeros(n_blocks + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(dst, minlength=n_blocks))
    b = syn.block
    blocks = np.broadcast_to(np.zeros((), np.float32), (src.size, b, b))
    structure = BlockSynapses(indptr=indptr, src_ids=src.astype(np.int64), blocks=blocks,
                              n_blocks=n_blocks)
    neuron = _neuron(cfg)
    params = LIFParams(**{f.name: getattr(neuron, f.name) for f in dataclasses.fields(neuron)},
                       noise_sigma=0.0)
    engine = DistributedSNN(mesh=mesh, params=params, exchange=prm["exchange"],
                            i_ext=_drive(ctx, 0), syn=structure, tiles=(syn.src, syn.tiles),
                            device=dev)
    steps = int(prm["steps"])
    st = State(ctx=ctx, engine=engine, syn=syn, neuron=neuron, mesh=mesh, steps=steps,
               host=torch.empty((steps, n_blocks * b), dtype=torch.bool,
                                pin_memory=dev.type == "cuda"))
    ctx.log("engine made; warming up")
    # builds the kernels and warms every shape a step uses; a step's work does
    # not hang on the simulation's length, and each run() captures anew
    _simulate(st, 0, record=False, steps=min(steps, WARM_STEPS))
    st.ledgers.clear()
    st.rasters_shapes.clear()
    st.spikes.clear()
    st.sims = 0
    rng = np.random.default_rng([ctx.seed, 7])
    st.keep = int(rng.integers(0, int(prm["min_sims"])))
    st.spare = np.ones(st.host.shape, dtype=bool)  # its pages are in place before the window
    return st


def _drive(ctx, sim: int) -> torch.Tensor:
    cfg = ctx.cell.config
    m = cfg["model"]["n_populations"] * cfg["neurons_per_population"]
    return brain.drive(m, *cfg["drive"], seed=ctx.seed, sim=sim, device=ctx.device)


def _simulate(st: State, sim: int, record: bool = True, steps: int | None = None) -> np.ndarray:
    """One simulation of ``steps`` (the cell's) steps: the engine under
    sim's drive, its raster copied to the host's buffer and its spikes
    counted; returns a view of the buffer (valid until the next
    simulation)."""
    from repro_torch.snn import LoopbackComm

    eng = dataclasses.replace(st.engine, i_ext=_drive(st.ctx, sim))
    comm = LoopbackComm(st.mesh, st.ctx.device)
    raster = eng.run(st.steps if steps is None else steps, comm=comm).to(torch.bool)
    # counted a block of steps at a time: a sum casts its block to int64
    spikes = sum(int(part.sum()) for part in raster.split(500))
    if raster.shape == st.host.shape:
        host = st.host.copy_(raster).numpy()
    else:  # a fault of the program's: the check counts it
        host = raster.cpu().numpy()
    if record:
        st.ledgers.append(list(comm.step_bytes))
        st.rasters_shapes.append(tuple(raster.shape))
        st.spikes.append(spikes)
        st.sims += 1
    return host


def window(st: State, seconds: float):
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        sim = st.sims
        host = _simulate(st, sim)
        if sim == st.keep:
            np.copyto(st.spare, host)
            st.kept[sim] = st.spare
        st.unit_s.append(time.perf_counter() - t)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    if not st.kept:  # a window shorter than the draw's range
        st.kept[sim] = host.copy()
    ms = np.sort(st.unit_s) * 1e3
    st.ctx.log(f"{st.sims} simulations of {st.steps} steps in {elapsed:.3f} s; a simulation "
               f"{ms[0]:.1f} / {np.median(ms):.1f} / {ms[-1]:.1f} ms (least / median / most); "
               f"spikes {min(st.spikes)}-{max(st.spikes)}")
    return {"sim_step_ms": elapsed * 1e3 / (st.sims * st.steps)}, st.sims, 0


def traced(st: State):
    """The traced window: ``trace_sims`` simulations under the profiler,
    each run just before untraced under the same drive, so that the shares
    of a step's time divide by the time a step takes without the
    profiler's own cost (``untraced_s``)."""
    from cellbench import trace as tr

    n = int(st.ctx.cell.params["trace_sims"])
    first = st.sims
    t = time.perf_counter()
    for i in range(n):
        _simulate(st, first + i)
    untraced_s = time.perf_counter() - t
    rasters = []
    with tr.traced(st.ctx.device) as got:
        for i in range(n):
            sim = first + i
            host = _simulate(st, sim)
            if i < n - 1:  # the next simulation reuses the buffer
                rasters.append(host.copy())
    rasters.append(host)
    # fired neurons by block, counted on the host once the window has closed
    fired = [r.reshape(st.steps, st.syn.n_blocks, -1).sum(2) for r in rasters]
    st.kept[sim] = host.copy()
    t = got[0]
    fired_per_block = np.concatenate(fired).astype(np.float64)
    tiles_per_source = st.syn.stored.sum(1).astype(np.float64)
    steps = n * st.steps
    m = st.syn.n_blocks * st.syn.block
    ledger = float(sum(sum(x) for x in st.ledgers[-n:]))
    t.counters.update(
        steps=steps, ledger_bytes=ledger, untraced_s=untraced_s,
        k1_least_ms=counts.bound(counts.k1_bytes(fired_per_block, tiles_per_source,
                                                 st.syn.block, m),
                                 counts.k1_flops(fired_per_block, tiles_per_source,
                                                 st.syn.block))[0],
        step_least_ms=counts.sim_step(fired_per_block, tiles_per_source, st.syn.block, m,
                                      ledger / steps)["least_ms"],
        k1_kernels=("spike_accum_ring_kernel", "compact_tiles_kernel"))
    return t, st.sims - first, 0


def check(st: State) -> list[Check]:
    """The kept raster held to the plain reference step by step, and every
    step's exchanged bytes to the reference's count."""
    prm = st.ctx.cell.params
    syn, neuron = st.syn, st.neuron
    stored, block, m = syn.stored, syn.block, syn.n_blocks * syn.block
    pre, post, weight = syn.pre, syn.post, syn.weight
    st.engine = st.syn = None  # the program's state and the device tiles go
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    want = lif.sparse_exchange_bytes(stored, st.mesh, block)
    off = max((abs(x - want) for led in st.ledgers for x in led), default=float("inf"))
    steps_off = sum(abs(len(led) - st.steps) for led in st.ledgers)
    steps_off += sum(shape != (st.steps, m) for shape in st.rasters_shapes)
    w = lif.weights(pre, post, weight, m, st.ctx.device)
    margin, count = 0.0, 0
    for sim, raster in sorted(st.kept.items()):
        if raster.shape != (st.steps, m):
            continue  # counted in steps_off
        drive = _drive(st.ctx, sim).cpu().numpy()
        got = lif.judge(raster, w, drive, neuron)
        st.ctx.log(f"simulation {sim}: {got['disagreements']} disagreements, "
                   f"widest {got['margin_mv']} mV")
        margin, count = max(margin, got["margin_mv"]), count + got["disagreements"]
    return [Check("spike_margin_mv", margin, float(prm["margin_limit_mv"])),
            Check("exchange_bytes_off", float(off), 0.0),
            Check("steps_off", float(steps_off), 0.0)]


def readings(ctx, control: bool) -> dict:
    """The spike check's number from one simulation, and with ``control``
    the same number of the control: the plain network run free in the
    program's place with its weights rounded to TF32 (the configuration
    states float32)."""
    st = setup(ctx)
    window(st, 0.0)
    syn = st.syn
    pre, post, weight, m = syn.pre, syn.post, syn.weight, syn.n_blocks * syn.block
    del syn  # the device tiles go with the program's state in check()
    checks = {c.name: c.value for c in check(st)}
    out = {"spike_margin_mv": checks["spike_margin_mv"],
           "exchange_bytes_off": checks["exchange_bytes_off"]}
    if control:
        drive = _drive(ctx, 0).cpu().numpy()
        low = lif.weights(pre, post, lif.tf32(weight), m, ctx.device)
        raster = lif.simulate(low, drive, st.steps, st.neuron)
        del low
        got = lif.judge(raster, lif.weights(pre, post, weight, m, ctx.device), drive,
                        st.neuron)
        out.update(control_spike_margin_mv=got["margin_mv"],
                   control_disagreements=got["disagreements"],
                   control_spikes=int(raster.sum()))
    return out
