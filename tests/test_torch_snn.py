"""The port's SNN layer against the JAX reference on the CPU: neuron steps,
the single-device engine, the distributed engine over loopback meshes
(every exchange), the ragged scatter modes, the plan buffer, and the
communicator's executed byte ledger.

Parity holds with channel noise too: the port draws JAX's threefry streams
(:mod:`repro_torch.random`), so a seed gives the reference's noise, and the
noisy rasters (``noise_sigma=2``, LIF and Izhikevich) equal the
reference's single-device engine and, on a ``(2, 4)`` mesh, its distributed
engine (8 fake host devices in a subprocess).  Rasters are 0/1, so "equal"
means equal, not close.

The engines run under a per-neuron drive (:func:`_drive`), so neurons fire
at different steps and the recurrent current reaches neurons outside their
refractory hold: the rasters depend on the weights and on every message of
the exchange, which the planted-fault tests show.  A uniform drive from rest
fires every neuron in one volley whose current lands inside the refractory
hold, and such a raster would not see the synapses at all.
"""
from __future__ import annotations

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.snn import (
    IzhikevichParams as JaxIzhikevich,
    LIFParams as JaxLIF,
    SNNEngine as JaxEngine,
    init_state as jax_init_state,
    izhikevich_step as jax_izhikevich_step,
    lif_step as jax_lif_step,
)
from repro_torch.snn import (
    BlockSynapses,
    DistributedSNN,
    IzhikevichParams,
    LIFParams,
    LoopbackComm,
    PlanBuffer,
    SNNEngine,
    build_ragged_plan,
    exchange_volume,
    expand_synapses_sparse,
    generate_brain_model,
    init_state,
    izhikevich_step,
    lif_step,
)
from repro_torch import random
from tests.conftest import run_devices
from tests.test_snn_sparse import _clustered_w

CPU = "cpu"
STEPS = 60


def _drive(m: int, seed: int = 0) -> np.ndarray:
    """Per-neuron external drive ``U(3, 8)``: threshold crossings from step
    ~20 on, spread over the run (about 1.6 % of neurons per step)."""
    return np.random.default_rng(seed).uniform(3.0, 8.0, m).astype(np.float32)


def _assert_sustained(raster: np.ndarray) -> None:
    """Firing spreads over many steps and goes on past the first volley's
    refractory hold (20 steps at the default LIF constants)."""
    active = np.flatnonzero(raster.sum(1))
    assert active.size >= 15, f"spikes on only {active.size} steps"
    assert raster[active[0] + 21:].sum() > 0, "no spikes after the first volley"


@functools.lru_cache(maxsize=None)
def _jax_raster(m: int, n_blocks: int, steps: int = STEPS) -> np.ndarray:
    """The JAX single-device engine's raster on ``_clustered_w(m, n_blocks)``
    under :func:`_drive` (the oracle the reference pins its distributed
    engine to)."""
    w = _clustered_w(m, n_blocks)
    ref = JaxEngine(w_syn=jnp.asarray(w), params=JaxLIF(noise_sigma=0.0),
                    i_ext=jnp.asarray(_drive(m))).run(steps, key=jax.random.PRNGKey(7))
    return np.asarray(ref.spikes)


def _prev_spikes(raster) -> np.ndarray:
    """The spikes each step's synaptic current is computed from."""
    raster = np.asarray(raster, dtype=np.float64)
    return np.vstack([np.zeros((1, raster.shape[1])), raster[:-1]])


class _LossyComm(LoopbackComm):
    """A planted fault: loses the first message of every ``ppermute``, or
    every block gathered across the slow axis."""

    def ppermute(self, x, pairs, axis):
        out = super().ppermute(x, pairs, axis)
        if pairs:
            out[pairs[0][1] * (self.r if axis == "slow" else 1)] = 0
        return out

    def all_gather(self, x, axis):
        out = super().all_gather(x, axis)
        return out if axis == "inner" else torch.zeros_like(out)


class TestNeuronSteps:
    @pytest.mark.parametrize("model", ["lif", "izhikevich"])
    def test_step_matches_jax_200_steps(self, model):
        rng = np.random.default_rng(11)
        n = 256
        if model == "lif":
            jp, tp, jstep, tstep, hi = JaxLIF(), LIFParams(), jax_lif_step, lif_step, 6.0
        else:
            jp, tp, jstep, tstep, hi = (JaxIzhikevich(), IzhikevichParams(),
                                        jax_izhikevich_step, izhikevich_step, 15.0)
        drive = rng.uniform(0.0, hi, size=(200, n)).astype(np.float32)
        js = jax_init_state(n, jp, jax.random.PRNGKey(0))
        ts = init_state(n, tp, device=CPU)
        fired = 0
        for t in range(200):
            js, jspk = jstep(js, jnp.asarray(drive[t]), jp)
            ts, tspk = tstep(ts, torch.from_numpy(drive[t]), tp)
            np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk), err_msg=f"step {t}")
            np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), atol=1e-4, rtol=0)
            np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), atol=1e-4, rtol=0)
            fired += int(tspk.sum())
        assert fired > 0

    def test_refractory_hold(self):
        p = LIFParams(t_refrac=5.0)
        s = init_state(1, p, device=CPU)._replace(v=torch.tensor([p.v_thresh + 1.0]))
        s, spk = lif_step(s, torch.zeros(1), p)
        assert float(spk[0]) == 1.0
        s, spk2 = lif_step(s, torch.full((1,), 100.0), p)
        assert float(spk2[0]) == 0.0  # refractory blocks immediate refire

    def test_noise_statistics(self):
        """sigma > 0: one LIF step from rest with no drive moves v by
        N(0, sigma²·dt); per-rank keys (rows of ``split(PRNGKey(3), n_dev)``)
        give independent streams, the same key the same noise, and each
        rank's key advances by ``split``."""
        p = LIFParams(noise_sigma=0.5)
        n_dev, n = 4, 50_000
        keys = random.split(random.PRNGKey(3), n_dev)
        st = init_state((n_dev, n), p, keys, device=CPU)
        st1, _ = lif_step(st, torch.zeros(n_dev, n), p)
        dv = (st1.v - p.v_rest).double()
        want = p.noise_sigma * np.sqrt(p.dt)
        assert abs(float(dv.mean())) < 5 * want / np.sqrt(n_dev * n)
        assert abs(float(dv.std()) / want - 1.0) < 0.02
        assert not torch.equal(dv[0], dv[1])  # ranks draw different noise
        assert torch.equal(st1.key, random.split(keys)[:, 0])
        again = init_state((n_dev, n), p, keys.clone(), device=CPU)
        assert torch.equal(lif_step(again, torch.zeros(n_dev, n), p)[0].v, st1.v)

    @pytest.mark.parametrize("model", ["lif", "izhikevich"])
    def test_noisy_step_matches_jax(self, model):
        """One noisy step draws the reference's noise: split, then normal
        from the subkey; the new key is the reference's."""
        if model == "lif":
            jp, tp, jstep, tstep = (JaxLIF(noise_sigma=2.0), LIFParams(noise_sigma=2.0),
                                    jax_lif_step, lif_step)
        else:
            jp, tp, jstep, tstep = (JaxIzhikevich(noise_sigma=2.0),
                                    IzhikevichParams(noise_sigma=2.0), jax_izhikevich_step,
                                    izhikevich_step)
        n = 4096
        drive = np.random.default_rng(4).uniform(0.0, 2.0, n).astype(np.float32)
        js, _ = jstep(jax_init_state(n, jp, jax.random.PRNGKey(9)), jnp.asarray(drive), jp)
        ts, _ = tstep(init_state(n, tp, random.PRNGKey(9), device=CPU),
                      torch.from_numpy(drive), tp)
        np.testing.assert_array_equal(ts.key.numpy(), np.asarray(js.key))
        np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=0, atol=1e-5)

    def test_noise_raises_rate(self):
        w = torch.zeros(64, 64)
        rates = [
            float(SNNEngine(w_syn=w, params=LIFParams(noise_sigma=s), i_ext=1.4,
                            device=CPU).run(300, seed=1).rates.mean())
            for s in (0.0, 1.0)
        ]
        assert rates[0] == 0.0 < rates[1]  # sub-threshold drive fires only with noise


NOISY_STEPS = 100
# a scalar drive (the reference's distributed engine takes no per-neuron
# one) that channel noise spreads over the run: the launcher's for LIF
NOISY = {"lif": (JaxLIF, LIFParams, 3.5), "izhikevich": (JaxIzhikevich, IzhikevichParams, 10.0)}


@functools.lru_cache(maxsize=None)
def _jax_noisy_distributed(mesh: tuple[int, ...], n_blocks: int,
                           steps: int = NOISY_STEPS) -> dict:
    """The reference's distributed engine at ``noise_sigma=2`` (key
    ``PRNGKey(3)``) on ``_clustered_w(64, n_blocks)`` over ``mesh`` of fake
    host devices, ``steps`` steps, for each model of :data:`NOISY` and
    every exchange the mesh takes: ``{(model, exchange): raster}``."""
    exchanges = ["flat", "sparse", "ragged"] + (["two_level"] if len(mesh) == 2 else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rasters.npz")
        run_devices(f"""
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.snn import BlockSynapses, DistributedSNN, IzhikevichParams, LIFParams
from tests.test_snn_sparse import _clustered_w
w = _clustered_w(64, {n_blocks})
syn = BlockSynapses.from_dense(w, {n_blocks})
mesh = make_mesh({mesh!r}, ("pod", "data")[:{len(mesh)}])
out = {{}}
for model, params, drive in [("lif", LIFParams(noise_sigma=2.0), {NOISY["lif"][2]}),
                             ("izhikevich", IzhikevichParams(noise_sigma=2.0),
                              {NOISY["izhikevich"][2]})]:
    for exch in {exchanges!r}:
        kw = dict(w_syn=jnp.asarray(w)) if exch in ("flat", "two_level") else dict(syn=syn)
        eng = DistributedSNN(mesh=mesh, params=params, exchange=exch, i_ext=drive, **kw)
        out[model + "/" + exch] = np.asarray(eng.run({steps}, key=jax.random.PRNGKey(3)))
np.savez({path!r}, **out)
""", n_devices=int(np.prod(mesh)))
        with np.load(path) as got:
            return {tuple(k.split("/")): got[k] for k in got.files}


class TestSingleDeviceEngine:
    @pytest.mark.parametrize("model", sorted(NOISY))
    def test_noisy_raster_matches_jax(self, model):
        """At ``noise_sigma=2`` the engine's raster is the reference's for
        the same seed, bit for bit, under a per-neuron drive."""
        jax_params, params, _ = NOISY[model]
        w = _clustered_w(64, 8)
        drive = _drive(64) * (1.0 if model == "lif" else 2.0)
        ref = JaxEngine(w_syn=jnp.asarray(w), params=jax_params(noise_sigma=2.0),
                        i_ext=jnp.asarray(drive)).run(NOISY_STEPS, key=jax.random.PRNGKey(3))
        got = SNNEngine(w_syn=w, params=params(noise_sigma=2.0), i_ext=drive,
                        device=CPU).run(NOISY_STEPS, seed=3)
        raster = got.spikes.numpy()
        _assert_sustained(raster)
        np.testing.assert_array_equal(raster, np.asarray(ref.spikes))
        quiet = SNNEngine(w_syn=w, params=params(), i_ext=drive, device=CPU).run(NOISY_STEPS)
        assert not torch.equal(quiet.spikes, got.spikes)  # the noise reaches the raster
        np.testing.assert_array_equal(got.final_state.key.numpy(),
                                      np.asarray(ref.final_state.key))

    def test_raster_matches_jax(self):
        w = _clustered_w(64, 8)
        out = SNNEngine(w_syn=w, params=LIFParams(), i_ext=_drive(64), device=CPU).run(STEPS)
        raster = out.spikes.numpy()
        _assert_sustained(raster)
        np.testing.assert_array_equal(raster, _jax_raster(64, 8))
        unwired = SNNEngine(w_syn=np.zeros_like(w), params=LIFParams(), i_ext=_drive(64),
                            device=CPU).run(STEPS).spikes.numpy()
        assert (unwired != raster).any()  # the synapses shape the raster

    def test_kernel_hook_matches_jax(self):
        """The ``spike_currents`` hook (the kernel on the card, its plain
        version here) gives the JAX engine's raster, which the Pallas
        hook (interpret mode) also gives."""
        from repro.kernels import KernelPolicy, spike_currents as jax_spike_currents
        from repro_torch.kernels import spike_currents

        rng = np.random.default_rng(0)
        w = (rng.random((128, 128)) < 0.1).astype(np.float32)
        np.fill_diagonal(w, 0)
        drive = _drive(128, seed=5)
        pol = KernelPolicy(use_pallas=True, interpret=True)
        ref = JaxEngine(w_syn=jnp.asarray(w), params=JaxLIF(), i_ext=jnp.asarray(drive)).run(
            STEPS, key=jax.random.PRNGKey(5),
            current_fn=lambda s, wm: jax_spike_currents(s, wm, policy=pol))
        out = SNNEngine(w_syn=w, params=LIFParams(), i_ext=drive, device=CPU).run(
            STEPS, current_fn=spike_currents, record_v=True)
        _assert_sustained(out.spikes.numpy())
        np.testing.assert_array_equal(out.spikes.numpy(), np.asarray(ref.spikes))
        assert out.v_trace.shape == (STEPS, 128)


MESHES = [
    ((8,), 8, ("flat", "sparse", "ragged")),
    ((4, 2), 8, ("flat", "two_level", "sparse", "ragged")),
    ((8, 4), 32, ("flat", "two_level", "sparse", "ragged")),
]


class TestDistributed:
    @pytest.mark.parametrize(
        "mesh,n_blocks,exchange",
        [(mesh, nb, ex) for mesh, nb, exs in MESHES for ex in exs],
        ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v),
    )
    def test_raster_matches_jax_engine(self, mesh, n_blocks, exchange):
        """The raster equals the oracle's, and every step's synaptic current
        equals the dense ``s @ W`` of the previous step's spikes."""
        w = _clustered_w(64, n_blocks)
        kw = {"w_syn": w} if exchange in ("flat", "two_level") else {
            "syn": BlockSynapses.from_dense(w, n_blocks)}
        eng = DistributedSNN(mesh=mesh, params=LIFParams(), exchange=exchange,
                             i_ext=_drive(64), device=CPU, **kw)
        cur = []
        raster = eng.run(STEPS, probe=lambda t, i: cur.append(i.clone())).numpy()
        _assert_sustained(raster)
        np.testing.assert_array_equal(raster, _jax_raster(64, n_blocks))
        np.testing.assert_allclose(torch.stack(cur).numpy(),
                                   _prev_spikes(raster) @ w.astype(np.float64),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("model", sorted(NOISY))
    @pytest.mark.parametrize("exchange", ["flat", "two_level", "sparse", "ragged"])
    def test_noisy_raster_matches_jax_distributed(self, exchange, model):
        """At ``noise_sigma=2`` on a ``(2, 4)`` mesh, rank ``d`` draws under
        row ``d`` of ``split(PRNGKey(3), 8)``, the key the reference's
        ``shard_map`` hands device ``d``: the raster equals the reference's
        distributed engine's, bit for bit."""
        jax_params, params, drive = NOISY[model]
        w = _clustered_w(64, 8)
        kw = {"w_syn": w} if exchange in ("flat", "two_level") else {
            "syn": BlockSynapses.from_dense(w, 8)}
        raster = DistributedSNN(mesh=(2, 4), params=params(noise_sigma=2.0), exchange=exchange,
                                i_ext=drive, device=CPU, **kw).run(NOISY_STEPS, seed=3).numpy()
        _assert_sustained(raster)
        np.testing.assert_array_equal(raster, _jax_noisy_distributed((2, 4), 8)[model, exchange])

    @pytest.mark.parametrize("exchange", ["flat", "two_level", "sparse", "ragged"])
    def test_planted_faults_change_the_raster(self, exchange, monkeypatch):
        """A lost message, or block currents of zero, move the raster off
        the oracle's: the parity tests above can see such faults."""
        w = _clustered_w(64, 8)
        kw = {"w_syn": w} if exchange in ("flat", "two_level") else {
            "syn": BlockSynapses.from_dense(w, 8)}
        eng = DistributedSNN(mesh=(4, 2), params=LIFParams(), exchange=exchange,
                             i_ext=_drive(64), device=CPU, **kw)
        want = _jax_raster(64, 8)
        np.testing.assert_array_equal(eng.run(STEPS).numpy(), want)
        lossy = eng.run(STEPS, comm=_LossyComm((4, 2), CPU)).numpy()
        assert (lossy != want).any(), "a lost message left the raster unchanged"
        if exchange in ("sparse", "ragged"):
            from repro_torch.snn import distributed

            monkeypatch.setattr(distributed, "spike_currents_blocks",
                                lambda s, src, blocks: s.new_zeros(s.shape[0], blocks.shape[-1]))
            assert (eng.run(STEPS).numpy() != want).any(), "zero currents went unseen"

    @pytest.mark.parametrize("mesh,n_blocks", [((8,), 8), ((8, 4), 32)])
    def test_ragged_scatter_modes_bit_identical(self, mesh, n_blocks):
        syn = BlockSynapses.from_dense(_clustered_w(64, n_blocks), n_blocks)
        rasters = {
            mode: DistributedSNN(mesh=mesh, params=LIFParams(), exchange="ragged",
                                 i_ext=_drive(64), syn=syn, ragged_scatter=mode,
                                 device=CPU).run(STEPS, seed=5)
            for mode in ("fused", "per_round")
        }
        _assert_sustained(rasters["fused"].numpy())
        assert torch.equal(rasters["fused"], rasters["per_round"])

    def test_plan_buffer_stage_and_flip(self):
        syn = BlockSynapses.from_dense(_clustered_w(64, 8), 8)
        eng = DistributedSNN(mesh=(4, 2), params=LIFParams(), exchange="ragged",
                             i_ext=_drive(64), syn=syn, device=CPU)
        buf = PlanBuffer(eng)
        active = buf.engine
        same = build_ragged_plan(syn, (4, 2))
        assert buf.stage(same) is True  # equal signature: prepared step reused
        assert buf.flip() is buf.engine and buf.engine is not active
        assert buf.staged is None
        other = build_ragged_plan(syn, (4, 2), bridge_inner=np.ones((4, 4), np.int64))
        assert buf.stage(other) is False  # bridges moved: new signature
        flipped = buf.flip()
        assert flipped.tiles[1] is eng._device_tiles[1]  # tiles handed over, not re-staged
        np.testing.assert_array_equal(flipped.run(STEPS).numpy(), _jax_raster(64, 8))
        with pytest.raises(RuntimeError, match="nothing staged"):
            buf.flip()

    def test_step_profile_phases(self):
        syn = BlockSynapses.from_dense(_clustered_w(64, 8), 8)
        eng = DistributedSNN(mesh=(4, 2), params=LIFParams(), exchange="sparse",
                             i_ext=4.0, syn=syn, device=CPU)
        prof = eng.step_profile(2)
        assert {"prepare_s", "first_call_s", "steady_call_s", "bytes_per_step",
                "step_cache_hits", "step_cache_misses"} <= set(prof)
        assert prof["bytes_per_step"] == eng.exchange_stats()["sparse"]

    def test_validation(self):
        with pytest.raises(ValueError, match="w_syn or syn"):
            DistributedSNN(mesh=(1,), params=LIFParams(), device=CPU)
        with pytest.raises(ValueError, match="bogus"):
            DistributedSNN(mesh=(1,), params=LIFParams(), w_syn=np.zeros((4, 4)),
                           ragged_scatter="bogus", device=CPU)
        with pytest.raises(ValueError, match="2-D mesh"):
            DistributedSNN(mesh=(2,), params=LIFParams(), w_syn=np.zeros((4, 4)),
                           exchange="two_level", device=CPU)
        syn = BlockSynapses.from_dense(np.zeros((4, 4), np.float32), 1)
        with pytest.raises(ValueError, match="dense w_syn"):
            DistributedSNN(mesh=(1,), params=LIFParams(), exchange="flat", syn=syn,
                           device=CPU)
        with pytest.raises(ValueError, match="i_ext has 3 values for 4 neurons"):
            DistributedSNN(mesh=(1,), params=LIFParams(), w_syn=np.zeros((4, 4)),
                           i_ext=np.ones(3), device=CPU).run(1)
        with pytest.raises(ValueError, match="do not hold these synapses"):
            DistributedSNN(mesh=(1,), params=LIFParams(), exchange="sparse", syn=syn,
                           tiles=(torch.zeros(1, 1), torch.zeros(1, 1, 2, 2)), device=CPU)


# benchmarks/snn_throughput.py's configuration and the values its CI gate
# holds (benchmarks/baseline.json: snn/bytes_{sparse,ragged}_{1d,2d})
GATED_BYTES = {
    ((32,), "sparse"): 27008,
    ((8, 4), "sparse"): 55296,
    ((32,), "ragged"): 12776,
    ((8, 4), "ragged"): 5760,
}


@functools.lru_cache(maxsize=None)
def _throughput_syn() -> BlockSynapses:
    bm = generate_brain_model(n_populations=128, n_regions=16,
                              total_neurons=10**7, seed=0)
    syn, _ = expand_synapses_sparse(bm.graph, 4, 32, seed=0)
    return syn


@pytest.mark.parametrize("mesh,exchange", sorted(GATED_BYTES), ids=str)
def test_executed_bytes_match_gated_ledger(mesh, exchange):
    """The bytes the loopback communicator moves across the slow axis in
    each step equal the reference's gated values and ``exchange_volume``."""
    syn = _throughput_syn()
    eng = DistributedSNN(mesh=mesh, params=LIFParams(), exchange=exchange,
                         i_ext=4.0, syn=syn, device=CPU)
    comm = LoopbackComm(mesh, CPU)
    eng.run(2, comm=comm)
    g = mesh[0]
    r = mesh[1] if len(mesh) > 1 else 1
    plan = build_ragged_plan(syn, (g, r))
    vol = exchange_volume(syn.mask(), mesh_shape=mesh, block_bytes=syn.block_size * 4,
                          plan=plan)
    assert comm.step_bytes == [GATED_BYTES[(mesh, exchange)]] * 2
    assert vol[exchange] == GATED_BYTES[(mesh, exchange)]
    assert eng.exchange_stats()[exchange] == vol[exchange]


@pytest.mark.parametrize("mesh", [(8,), (4, 2)], ids=str)
def test_dense_exchange_bytes_match_flat_volume(mesh):
    """flat / two_level move exchange_volume's 'flat' bytes per step."""
    w = _clustered_w(64, 8)
    syn = BlockSynapses.from_dense(w, 8)
    want = exchange_volume(syn.mask(), mesh_shape=mesh, block_bytes=syn.block_size * 4)
    for exch in ("flat", "two_level") if len(mesh) == 2 else ("flat",):
        comm = LoopbackComm(mesh, CPU)
        DistributedSNN(mesh=mesh, params=LIFParams(), exchange=exch, w_syn=w,
                       i_ext=4.0, device=CPU).run(3, comm=comm)
        assert comm.step_bytes == [want["flat"]] * 3, exch
