#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on the card, with nothing of JAX or
of the JAX package ``repro``.  Each phase prints one JSON line; any failed
check raises, so the script exits nonzero.

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, the kernel build's seconds; TF32 off.
2. Kernels: each hand-written kernel against its plain PyTorch version
   at the main path's shapes (firing 0 %, 1 %, one fully active block,
   every row, weighted spikes).  The plain versions run on float64 copies
   of the inputs as the yardstick, with ``rtol=1e-5, atol=1e-4`` (the
   kernels sum in another order than the einsum); the difference from the
   float32 plain version is reported beside it.  Two runs must be
   bit-identical.  Kernel, plain, library-yardstick and bound times.
3. The launcher (``repro_torch.launch.run_brainsim.main``) for each of the
   four exchanges, at its defaults and with channel noise (``--noise 2``,
   which spreads the firing over the run so the rasters depend on the
   synapses and on every message): sparse == ragged == flat == two_level
   bit for bit, one ``spike_accum_blocks`` launch per step, and a
   communicator that loses a message changes the noisy raster.
4. Real size through the public API: 2,048 populations x 16 neurons =
   32,768 neurons on 8 ranks in a (2, 4) mesh under a per-neuron drive
   ``U(3, 8)`` (firing spread over the run, a few percent of the neurons
   per step), 200 steps of sparse, ragged/fused and ragged/per_round
   (identical rasters, executed bytes == ``exchange_volume``).  Every
   step's synaptic current equals the dense ``s @ W`` in float64; the
   raster equals the single-device engine's with the ``spike_accum``
   kernel as its current hook; a lost ragged payload changes the raster.
5. Last line: ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 before phase 3 and read after phase 4: the
main path must have launched every kernel.  Runs made only to check
(probed currents, planted faults) leave the counts as they were.  Exits 2
without CUDA.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

STEPS = 100  # the launcher's default
REAL_STEPS = 200
DRIVE = (3.0, 8.0)  # per-neuron external drive at real size, uniform
TOL = dict(rtol=1e-5, atol=1e-4)
F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores (data sheet)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mem_rate(name: str) -> tuple[float, str]:
    """Published memory rate of the card (bytes/s) and which part it is."""
    if "PCIe" in name:
        return 2.0e12, "H100 PCIe, 2.0 TB/s"
    if "NVL" in name:
        return 3.9e12, "H100 NVL, 3.9 TB/s"
    return 3.35e12, "H100 SXM, 3.35 TB/s"


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside are checks, not the main path's run:
    the launch counts are put back as they were."""
    from repro_torch.kernels import LAUNCHES

    saved = dict(LAUNCHES)
    try:
        yield
    finally:
        LAUNCHES.update(saved)


def lossy_comm(mesh, dev):
    """A planted fault: a communicator that loses the first message of
    every ``ppermute`` and every block gathered across the slow axis."""
    import torch

    from repro_torch.snn import LoopbackComm

    class Lossy(LoopbackComm):
        def ppermute(self, x, pairs, axis):
            out = super().ppermute(x, pairs, axis)
            if pairs:
                out[pairs[0][1] * (self.r if axis == "slow" else 1)] = 0
            return out

        def all_gather(self, x, axis):
            out = super().all_gather(x, axis)
            return out if axis == "inner" else torch.zeros_like(out)

    return Lossy(mesh, dev)


def sustained(raster, min_active: int) -> dict:
    """Firing spread over the run: spikes on at least ``min_active`` steps
    and after the first volley's refractory hold (20 steps)."""
    import torch

    active = torch.nonzero(raster.sum(1)).flatten()
    check(active.numel() >= min_active, f"spikes on only {active.numel()} steps")
    first = int(active[0])
    check(float(raster[first + 21:].sum()) > 0, "no spikes after the first volley")
    return {"active_steps": int(active.numel()), "first_spike_step": first}


# -- phase 2 ---------------------------------------------------------------


def _bound(nbytes: float, flops: float, rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / rate * 1e3, flops / F32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, rate: float) -> dict:
    """K1 / K2 against their plain versions at the main path's shapes."""
    import torch

    from repro_torch.kernels import spike_accum as k
    from repro_torch.kernels.ref import spike_accum_blocks_ref, spike_accum_ref

    n_dev, n_blocks, b = 8, 8, 4096
    gen = torch.Generator(device=dev).manual_seed(0)
    # dense tiles drawn like the model's weights (expand_synapses): positive
    # magnitudes, every presynaptic row inhibitory (negative) with p = 0.2
    blocks = torch.empty((n_dev, n_blocks, b, b), device=dev).exponential_(generator=gen)
    inhib = torch.rand((n_dev, n_blocks, b, 1), generator=gen, device=dev) < 0.2
    blocks.mul_(1.0 - 2.0 * inhib.float())
    src = torch.arange(n_blocks, dtype=torch.int32, device=dev).repeat(n_dev, 1)
    w2 = blocks[0].reshape(n_blocks * b, b)  # K2: W f32[32768, 4096]
    rank = torch.arange(n_dev, device=dev)[:, None]
    # the plain versions on float64 copies are the yardstick of correctness:
    # at 32,768 fired rows a float32 sum in any order drifts by about
    # sqrt(n) roundings, near the tolerance itself
    blocks64 = blocks.double()
    w2_64 = blocks64[0].reshape(n_blocks * b, b)

    def spikes(case: str, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, device=dev)
        if case == "rate_0":
            return torch.zeros(shape, device=dev)
        if case == "rate_1pct":
            return (u < 0.01).float()
        if case == "all_fire":  # the densest step there can be
            return torch.ones(shape, device=dev)
        if case == "one_active_block":
            s = torch.zeros(shape, device=dev)
            s.view(-1, b)[3] = 1.0
            return s
        return u * (torch.rand(shape, generator=gen, device=dev) < 0.05)  # weighted

    result = {}
    for name in ("spike_accum_blocks", "spike_accum"):
        cases, worst = {}, 0.0
        for case in ("rate_0", "rate_1pct", "one_active_block", "all_fire", "weighted"):
            if name == "spike_accum_blocks":
                s = spikes(case, (n_dev, n_blocks, b))
                kern = lambda: k.spike_accum_blocks(s, src, blocks)  # noqa: E731
                plain = lambda: spike_accum_blocks_ref(s, src, blocks)  # noqa: E731
                sel = s[rank, src.long()]
                lib = lambda: torch.einsum("dkb,dkbj->dj", sel, blocks)  # noqa: E731
                exact = spike_accum_blocks_ref(s.double(), src, blocks64)
                fired = float((s[rank, src.long()] != 0).sum())
                nbytes = fired * b * 4 + s.numel() * 4 + src.numel() * 4 + n_dev * b * 4
                flops = 2 * fired * b
            else:
                s = spikes(case, (n_blocks * b,))
                kern = lambda: k.spike_accum(s, w2)  # noqa: E731
                plain = lambda: spike_accum_ref(s, w2)  # noqa: E731
                lib = lambda: torch.mv(w2.t(), s)  # noqa: E731
                exact = spike_accum_ref(s.double(), w2_64)
                fired = float((s != 0).sum())
                nbytes = fired * b * 4 + s.numel() * 4 + b * 4
                flops = 2 * fired * b
            out, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"{name}/{case}: reruns differ")
            err = float((out.double() - exact).abs().max())
            check(torch.allclose(out.double(), exact, **TOL),
                  f"{name}/{case}: max err {err}")
            bound_ms, bound_by = _bound(nbytes, flops, rate)
            cases[case] = {
                "fired_rows": fired, "max_abs_err": err, "bit_identical_rerun": True,
                "max_abs_diff_vs_plain_f32": float((out - want).abs().max()),
                "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, 5),
                "library_ms": cuda_ms(lib, 5), "bound_ms": bound_ms, "bound_by": bound_by,
            }
            worst = max(worst, err)
        result[name] = {"cases": cases, "max_abs_err": worst}
    del blocks, w2, blocks64, w2_64
    torch.cuda.empty_cache()
    return result


# -- phase 3 ---------------------------------------------------------------


def phase_launcher(device: str, argv: list[str] | None = None) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import run_brainsim

    argv = list(argv or [])
    per_run_launches = device == "cuda"  # a CPU run takes the plain version
    out = {}
    for tag, extra in (("defaults", []), ("noise_2", ["--noise", "2.0"])):
        rasters, runs, engines = {}, {}, {}
        for exch in ("flat", "two_level", "sparse", "ragged"):
            before = LAUNCHES["spike_accum_blocks"]
            t0 = time.perf_counter()
            res = run_brainsim.main([*argv, *extra, "--exchange", exch, "--device", device])
            wall = time.perf_counter() - t0
            rasters[exch], engines[exch] = res["raster"], res["engine"]
            runs[exch] = {"spike_accum_blocks": LAUNCHES["spike_accum_blocks"] - before,
                          "wall_s": wall}
        steps = rasters["flat"].shape[0]
        for exch in ("two_level", "sparse", "ragged"):
            check(np.array_equal(rasters[exch], rasters["flat"]), f"{tag}: {exch} != flat")
        for exch in ("sparse", "ragged"):
            check(runs[exch]["spike_accum_blocks"] == (steps if per_run_launches else 0),
                  f"{tag}/{exch}: {runs[exch]} kernel launches for {steps} steps")
        row = {"steps": steps, "spikes": int(rasters["flat"].sum()), "runs": runs}
        if extra:
            row.update(sustained(torch.from_numpy(rasters["flat"]), steps // 2))
            with uncounted():
                for exch, eng in engines.items():
                    lost = eng.run(steps, comm=lossy_comm(eng.mesh, eng.device))
                    check(not np.array_equal(lost.cpu().numpy(), rasters[exch]),
                          f"{tag}/{exch}: a lost message left the raster unchanged")
            row["planted_faults_seen"] = True
        out[tag] = row
    return out


# -- phase 4 ---------------------------------------------------------------


def _device_profile(eng, steps: int) -> dict:
    """Where one run's time goes: device time by kernel under
    ``torch.profiler`` and the device's busy share of the run's wall time
    (the profiler's own cost is inside that wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    # kernel events only: an aten op's device time is its kernels' time again
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "kernels": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
                         "calls": e.count} for e in rows[:8]],
            "kernel_launches": sum(e.count for e in rows)}



def phase_real_size(device: str, n_pop: int = 2048, npp: int = 16,
                    steps: int = REAL_STEPS) -> dict:
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.core import (
        device_traffic_csr, greedy_partition, p2p_routing, step_latency,
        two_level_routing,
    )
    from repro_torch.kernels import LAUNCHES, spike_currents
    from repro_torch.snn import (
        DistributedSNN, LIFParams, LoopbackComm, SNNEngine,
        expand_synapses_sparse, generate_brain_model,
    )

    dev = torch.device(device)
    per_run = steps if dev.type == "cuda" else 0  # a CPU run takes the plain version
    n_dev, mesh = 8, (2, 4)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out: dict = {"populations": n_pop, "neurons_per_pop": npp, "ranks": n_dev,
                 "mesh": list(mesh), "steps": steps, "drive": list(DRIVE)}
    t0 = time.perf_counter()
    bm = generate_brain_model(n_populations=n_pop, n_regions=max(8, n_pop // 16),
                              total_neurons=1_000_000, seed=0)
    part = greedy_partition(bm.graph, n_dev, seed=0)
    t, wg = device_traffic_csr(bm.graph, part.assign, n_dev)
    tb = two_level_routing(t, wg, max(2, n_dev // 4))
    out["plan"] = {"cut": part.cut, "groups": tb.n_groups,
                   "latency_p2p_ms": step_latency(p2p_routing(t, wg)).t_total * 1e3,
                   "latency_two_level_ms": step_latency(tb).t_total * 1e3,
                   "host_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    # Algorithm 1's population partition is not equal-count: contiguous slabs
    syn, _ = expand_synapses_sparse(bm.graph, npp, n_dev, seed=0)
    np.multiply(syn.blocks, np.float32(0.05), out=syn.blocks)  # the launcher's scale
    out["expand"] = {"host_s": time.perf_counter() - t0, "tiles": syn.nnzb,
                     "block": syn.block_size, "tile_bytes": int(syn.blocks.nbytes),
                     "synapses": int(np.count_nonzero(syn.blocks))}
    m = syn.n_neurons
    drive = np.random.default_rng(0).uniform(*DRIVE, m).astype(np.float32)
    params = LIFParams(noise_sigma=0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tiles = convert.padded_tiles(syn, dev)  # one device copy, shared by every engine
    sync()
    out["stage_tiles_s"] = time.perf_counter() - t0

    def engine(exch: str, mode: str = "fused") -> DistributedSNN:
        return DistributedSNN(mesh=mesh, params=params, exchange=exch, i_ext=drive,
                              syn=syn, ragged_scatter=mode, tiles=tiles, device=dev)

    runs, rasters = {}, {}
    for tag, exch, mode in (("sparse", "sparse", "fused"),
                            ("ragged_fused", "ragged", "fused"),
                            ("ragged_per_round", "ragged", "per_round")):
        eng = engine(exch, mode)
        eng.run(2)  # warm up
        comm = LoopbackComm(mesh, dev)
        before = LAUNCHES["spike_accum_blocks"]
        sync()
        t0 = time.perf_counter()
        raster = eng.run(steps, comm=comm)
        sync()
        wall = time.perf_counter() - t0
        launched = LAUNCHES["spike_accum_blocks"] - before
        vol = eng.exchange_stats()
        check(launched == per_run, f"{tag}: {launched} kernel launches for {steps} steps")
        check(comm.step_bytes == [vol[exch]] * steps,
              f"{tag}: executed bytes {set(comm.step_bytes)} != {vol[exch]}")
        rasters[tag] = raster
        runs[tag] = {"ms_per_step": wall / steps * 1e3, "steps_per_s": steps / wall,
                     "bytes_per_step": vol[exch], "spike_accum_blocks_launches": launched}
    if dev.type == "cuda":
        out["profile"] = _device_profile(engine("sparse"), steps)
    runs["ragged_fused"]["step_profile"] = engine("ragged").step_profile(4)
    raster = rasters["sparse"]
    for tag in ("ragged_fused", "ragged_per_round"):
        check(torch.equal(rasters[tag], raster), f"{tag} != sparse")
    out.update(sustained(raster, steps // 2))
    half = steps // 2
    out.update(spikes=int(raster.sum()), mean_rate=float(raster.mean()),
               rate_second_half=float(raster[half:].mean()), runs=runs)

    # the dense synapse matrix, for the single-device engine and the yardstick
    b = syn.block_size
    w = torch.zeros((m, m), dtype=torch.float32, device=dev)
    for kk, dst in enumerate(syn.dst_of()):
        src = int(syn.src_ids[kk])
        w[src * b:(src + 1) * b, dst * b:(dst + 1) * b] = torch.from_numpy(syn.blocks[kk])
    # every step's synaptic current against the dense s @ W, in float64
    prev = torch.cat([torch.zeros_like(raster[:1]), raster[:-1]]).double()
    want = prev @ w.double()
    currents = {}
    with uncounted():
        for tag, exch in (("sparse", "sparse"), ("ragged_fused", "ragged")):
            cur = []
            again = engine(exch).run(steps, probe=lambda _t, i: cur.append(i.clone()))
            check(torch.equal(again, raster), f"{tag}: the probed run differs")
            got = torch.stack(cur).double()
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, **TOL), f"{tag}: currents off by {err}")
            currents[tag] = {"max_abs_err": err, "max_abs_current": float(want.abs().max())}
        lost = engine("ragged").run(steps, comm=lossy_comm(mesh, dev))
        check(not torch.equal(lost, raster), "a lost ragged payload left the raster unchanged")
    del want, prev
    out["currents_vs_dense_f64"] = currents
    out["planted_fault_seen"] = True
    # the raster oracle: the single-device engine, its current hook the
    # spike_accum kernel (on the card)
    before = LAUNCHES["spike_accum"]
    sync()
    t0 = time.perf_counter()
    oracle = SNNEngine(w_syn=w, params=params, i_ext=drive, device=dev).run(
        steps, current_fn=spike_currents).spikes
    sync()
    oracle_s = time.perf_counter() - t0
    check(LAUNCHES["spike_accum"] - before == per_run, "oracle did not run the kernel")
    check(torch.equal(oracle, raster), "distributed != single-device oracle")
    out["oracle"] = {"ms_per_step": oracle_s / steps * 1e3, "equal": True}
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    del w, tiles
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import LAUNCHES, _build, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    rate, rate_note = mem_rate(name)
    t0 = time.perf_counter()
    _build.load_library("spike_accum")
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0, "nvcc_s": _build.BUILD_SECONDS,
          "mem_rate": rate_note, "tf32": False})

    kern = phase_kernels(dev, rate)
    emit({"phase": "kernels_check", **kern})

    reset_launches()  # the main path starts here
    emit({"phase": "launcher", **phase_launcher("cuda")})
    emit({"phase": "real_size", **phase_real_size("cuda")})
    launches = dict(LAUNCHES)
    for kname, n in launches.items():
        check(n > 0, f"main path never launched {kname}")

    source = "src/repro_torch/kernels/csrc/spike_accum.cu"
    replaces = {"spike_accum_blocks": "src/repro/kernels/spike_accum.py:133",
                "spike_accum": "src/repro/kernels/spike_accum.py:62"}
    rows = []
    for kname in ("spike_accum_blocks", "spike_accum"):
        c = kern[kname]["cases"]["rate_1pct"]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces[kname], "launches": launches[kname],
                     "max_abs_err": kern[kname]["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
