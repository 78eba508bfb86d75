#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on the card, with nothing of JAX or
of the JAX package ``repro``: the brain simulation (phases 3-4) and LM
serving (phase 5).  Each phase prints one JSON line; any failed
check raises, so the script exits nonzero.

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, the kernel build's seconds; TF32 off.
2. Kernels: each hand-written kernel against its plain PyTorch version
   at the main path's shapes (firing 0 %, 1 %, one fully active block,
   every row, weighted spikes).  The plain versions run on float64 copies
   of the inputs as the yardstick, with ``rtol=1e-5, atol=1e-4`` (the
   kernels sum in another order than the einsum); the difference from the
   float32 plain version is reported beside it.  Two runs must be
   bit-identical.  Kernel, plain, library-yardstick and bound times; at
   the main path's shapes also their device times (``torch.profiler``).
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
5. Serving (``repro_torch.serve``, the LM path: prefill runs the
   ``flash_attention`` kernel, decode the ``decode_attention`` kernel):
   (a) phi4-mini-3.8b reduced with 2 kv heads, prefill of 64 tokens and 8
   teacher-forced decode steps on the card and on the CPU from the same
   numpy parameters, logits within two bf16 steps (bf16) and 1e-3
   (float32); (b) phi4-mini-3.8b at full width and depth, bf16, random
   weights from a seed: 8 requests (prompt lengths 64-1,000) through
   ``ServeEngine.generate`` (waves of 4) and ``generate_continuous``, 64
   greedy tokens each, the first wave's tokens equal under both, exactly
   ``n_layers`` launches of each attention kernel per prefill / decode
   step; prefill(S) + decode(S) against prefill(S + 1) within 0.05 under
   float32 compute; prefill / decode times, tokens/s, launches and device
   busy share of decode steps, peak memory; (c) the serving launcher
   ``python -m repro_torch.launch.serve`` at its defaults.
6. A ``kernels`` line (all four kernels) and the last line,
   ``{"ok": true, "device": {...}}``.

The attention kernels are checked in phase 2 too: the reference's sweep
(MQA, bidirectional, window 96, 384 tokens, ragged ``seq_lens``) and
phi4-mini's full-width shapes, float32 and bfloat16 at the reference's
tolerances, on transposed views as the model passes them.  Launch counts
are set to 0 before phase 3 and read after phase 5(b): the main paths must
have launched every kernel.  Runs made only to check (probed currents,
planted faults, the card-vs-CPU and consistency checks, the profiled
window) leave the counts as they were.  Exits 2 without CUDA.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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


def timings(kern, plain, lib, main: bool) -> dict:
    """Times of a kernel, its plain version and the library call.  ``ms``
    keys: CUDA events around back-to-back calls, which include the host's
    dispatch where the host is the slower side.  For a case of the main
    path (``main``) also ``device_ms`` keys: the device time of the kernels
    each call launches, from ``torch.profiler``."""
    out = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, 5), "library_ms": cuda_ms(lib, 5)}
    if main:
        reps = 10
        for key, fn in (("device_ms", kern), ("plain_device_ms", plain),
                        ("library_device_ms", lib)):
            prof = _device_profile(lambda n, fn=fn: [fn() for _ in range(n)], reps)
            out[key] = prof["device_busy_s"] * 1e3 / reps
    return out


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


def _bound(nbytes: float, flops: float, rate: float, peak: float = F32_PEAK) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / rate * 1e3, flops / peak * 1e3
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
                **timings(kern, plain, lib, case == "rate_1pct"),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            worst = max(worst, err)
        result[name] = {"cases": cases, "max_abs_err": worst}
    del blocks, w2, blocks64, w2_64
    torch.cuda.empty_cache()
    return result


BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
ATTN_TOL = {"float32": dict(rtol=3e-3, atol=3e-3),  # tests/test_kernels.py:19-20
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (name, b, hq, hkv, sq, sk, d, causal, window): the reference's sweep
# (tests/test_kernels.py:23-44), then phi4-mini-3.8b's prefill (a 4-slot wave
# padded to 1,024 tokens)
FLASH_CASES = [
    ("gqa", 2, 4, 2, 256, 256, 64, True, None),
    ("mqa", 1, 8, 1, 128, 128, 32, True, None),
    ("bidirectional", 2, 4, 4, 256, 256, 64, False, None),
    ("window_96", 1, 4, 2, 256, 256, 64, True, 96),
    ("seq_384", 1, 2, 2, 384, 384, 16, True, 128),
    ("phi4_prefill", 4, 24, 8, 1024, 1024, 128, True, None),
]
# (name, b, hq, hkv, s, d, valid rows or None for all / "ragged"):
# tests/test_kernels.py:47-61, then phi4-mini-3.8b's decode (4 slots, cache
# 1,088 = 1,024 + 64 rows, 1,056 of them valid half-way through the wave)
DECODE_CASES = [
    ("full_cache", 2, 4, 2, 1024, 64, None),
    ("ragged_g4", 3, 8, 2, 512, 32, "ragged"),
    ("ragged_d128", 1, 2, 1, 2048, 128, "ragged"),
    ("phi4_decode", 4, 24, 8, 1088, 128, 1056),
]


def _valid_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    import numpy as np

    qp, kp = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return int(mask.sum())


def phase_attention(dev, rate: float) -> dict:
    """K3 / K4 against their plain versions, on transposed views of
    [B, S, H, D] activations and of a [B, W, Hkv, D] cache as the model
    passes them: the reference's sweep with its tolerances, and
    phi4-mini-3.8b's full-width shapes; float32 and bfloat16; two runs
    bit-identical.  The library yardstick is one
    ``scaled_dot_product_attention`` call on KV heads repeated beforehand
    (the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import attention as k
    from repro_torch.kernels.ref import attention_ref, decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    result = {"flash_attention": {}, "decode_attention": {}}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(table, key, kern, plain, lib, nbytes, flops, dtype):
        out, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{key}: reruns differ")
        err = float((out.float() - want.float()).abs().max())
        check(torch.allclose(out.float(), want.float(), **ATTN_TOL[dtype]), f"{key}: max err {err}")
        bound_ms, bound_by = _bound(nbytes, flops, rate,
                                    BF16_PEAK if dtype == "bfloat16" else F32_PEAK)
        table[key] = {"max_abs_err": err, "bit_identical_rerun": True,
                      **timings(kern, plain, lib, key.startswith("phi4")),
                      "bound_ms": bound_ms, "bound_by": bound_by}

    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for name, b, hq, hkv, sq, sk, d, causal, window in FLASH_CASES:
            q = randn(b, sq, hq, d, dtype=td).transpose(1, 2)
            kk, v = (randn(b, sk, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
            kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kk, v))
            mask = None
            if window is not None:
                qp = torch.arange(sq, device=dev)[:, None]
                kp = torch.arange(sk, device=dev)[None, :]
                mask = kp > qp - window
                if causal:
                    mask &= kp <= qp
            lib = (lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)) \
                if mask is not None else \
                (lambda: F.scaled_dot_product_attention(q, kr, vr, is_causal=causal))
            pairs = _valid_pairs(sq, sk, causal, window)
            nbytes = (q.numel() * 2 + kk.numel() * 2) * q.element_size()  # q, k, v, out
            record(result["flash_attention"], f"{name}/{dtype}",
                   lambda: k.flash_attention(q, kk, v, causal=causal, window=window),
                   lambda: attention_ref(q, kk, v, causal=causal, window=window),
                   lib, nbytes, 4.0 * b * hq * pairs * d, dtype)
        for name, b, hq, hkv, s, d, valid in DECODE_CASES:
            q = randn(b, hq, d, dtype=td)
            kk, v = (randn(b, s, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
            if valid == "ragged":
                sl = torch.randint(1, s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
            else:
                sl = torch.full((b,), valid or s, dtype=torch.int32, device=dev)
            kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kk, v))
            mask = (torch.arange(s, device=dev)[None, :] < sl[:, None])[:, None, None, :]
            rows = float(sl.sum())
            nbytes = (2 * rows * hkv * d + 2 * q.numel()) * q.element_size() + sl.numel() * 4
            record(result["decode_attention"], f"{name}/{dtype}",
                   lambda: k.decode_attention(q, kk, v, seq_lens=sl),
                   lambda: decode_attention_ref(q, kk, v, seq_lens=sl),
                   lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr, attn_mask=mask),
                   nbytes, 4.0 * rows * hq * d, dtype)
    for table in result.values():
        table["max_abs_err"] = max(c["max_abs_err"] for c in table.values())
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


def _device_profile(run, steps: int) -> dict:
    """Where ``run(steps)``'s time goes: device time by kernel under
    ``torch.profiler`` and the device's busy share of the run's wall time
    (the profiler's own cost is inside that wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
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
        out["profile"] = _device_profile(engine("sparse").run, steps)
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


# -- phase 5 ---------------------------------------------------------------

SERVE_ARCH = "phi4-mini-3.8b"
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW = 8, 4, 64
F32_LOGIT_BOUND = 0.05  # tests/test_models.py:94-114, float32 compute


@contextlib.contextmanager
def compute_dtype(dtype):
    """The model's matmul dtype (``layers.COMPUTE_DTYPE``) for a check."""
    from repro_torch.models import layers

    saved = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = saved


def _bf16_close(got, want, n_vocab: int) -> tuple[float, float]:
    """(max |got - want|, its allowance): two bf16 steps of the reference
    value plus two steps of its rms (tests/test_torch_lm.py's bound)."""
    got, want = got[..., :n_vocab].float().cpu(), want[..., :n_vocab].float().cpu()
    rms = float(want.double().pow(2).mean().sqrt())
    excess = float(((got - want).abs() - 2**-6 * want.abs()).max())
    return float((got - want).abs().max()), excess - 2**-6 * rms


def _numpy_params(cfg, seed: int) -> dict:
    """The LM's parameter tree as numpy float32, drawn from a seed."""
    import numpy as np

    from repro_torch.models import lm

    rng = np.random.default_rng(seed)

    def build(node):
        if isinstance(node, lm.PDef):
            if node.init == "zeros":
                return np.zeros(node.shape, np.float32)
            return rng.standard_normal(node.shape, dtype=np.float32) * np.float32(node.scale)
        return {k: build(node[k]) for k in sorted(node)}

    return build(lm.param_defs(cfg))


def _card_vs_cpu(dev) -> dict:
    """(a) phi4-mini-3.8b reduced with 2 kv heads: prefill of 64 tokens and
    8 teacher-forced decode steps, on the card (kernels) and on the CPU
    (plain versions), from one set of numpy parameters; bf16 and float32
    compute."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm

    cfg = dataclasses.replace(ARCHS[SERVE_ARCH].reduced(), n_kv_heads=2)
    tree = _numpy_params(cfg, 0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 72)).astype(np.int32)
    out = {}
    for dtype, label in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        logits = {}
        with compute_dtype(dtype):
            for where in (str(dev), "cpu"):
                params = convert.lm_params(tree, cfg, where)
                t = torch.from_numpy(toks).to(where)
                lg, cache = lm.prefill(params, {"tokens": t[:, :64]}, cfg, max_len=72)
                steps = [lg]
                for i in range(8):
                    lg, cache = lm.decode_step(params, cache, {"tokens": t[:, 64 + i : 65 + i]},
                                               64 + i, cfg)
                    steps.append(lg)
                logits[where] = torch.stack(steps).cpu()
        card, cpu = logits[str(dev)], logits["cpu"]
        check(bool(torch.isfinite(card[..., : cfg.vocab_size]).all()), f"{label}: non-finite logits")
        if label == "bfloat16":
            err, over = _bf16_close(card, cpu, cfg.vocab_size)
            check(over <= 0, f"card vs CPU, bf16: {err} exceeds two bf16 steps by {over}")
            bound = "rtol 2^-6 + atol 2^-6 rms"
        else:
            err = float((card - cpu)[..., : cfg.vocab_size].abs().max())
            check(err <= 1e-3, f"card vs CPU, float32: max logits diff {err}")
            bound = "1e-3"
        out[label] = {"max_abs_logit_diff": err, "bound": bound,
                      "max_abs_logit": float(cpu[..., : cfg.vocab_size].abs().max()),
                      "same_argmax": bool(torch.equal(card[..., : cfg.vocab_size].argmax(-1),
                                                      cpu[..., : cfg.vocab_size].argmax(-1)))}
    return out


def _prefill_decode_consistency(params, cfg, prompt: list[int], dev) -> dict:
    """prefill(S) then decode_step(token S) against the last logits of
    prefill(S + 1): K3 and K4 held against each other at full width.
    float32 compute holds to the reference's 0.05; bf16 is reported."""
    import torch

    from repro_torch.models import lm

    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    s = toks.shape[1] - 1
    out = {"S": s}
    for dtype, label in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        with compute_dtype(dtype):
            _, cache = lm.prefill(params, {"tokens": toks[:, :s]}, cfg, max_len=s + 1)
            dec, _ = lm.decode_step(params, cache, {"tokens": toks[:, s:]}, s, cfg)
            full, _ = lm.prefill(params, {"tokens": toks}, cfg)
        err = float((dec - full)[:, : cfg.vocab_size].abs().max())
        out[label] = {"max_abs_logit_diff": err,
                      "max_abs_logit": float(full[:, : cfg.vocab_size].abs().max()),
                      "same_argmax": bool(torch.equal(dec[:, : cfg.vocab_size].argmax(-1),
                                                      full[:, : cfg.vocab_size].argmax(-1)))}
        del cache
    check(out["float32"]["max_abs_logit_diff"] < F32_LOGIT_BOUND,
          f"prefill+decode vs prefill(S+1): {out['float32']}")
    return out


class _Timed:
    """Counts and times (synchronised, on the host clock) calls of
    ``lm.prefill`` / ``lm.decode_step`` as the engine makes them."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, *args, **kw):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def phase_serve(dev) -> dict:
    """(b) phi4-mini-3.8b at full width and depth (bf16, random weights from
    a seed): 8 requests through ``ServeEngine.generate`` (two waves of 4)
    and ``generate_continuous``, with (a) and the consistency check run
    outside the launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine

    out: dict = {}
    with uncounted():
        out["card_vs_cpu_reduced"] = _card_vs_cpu(dev)
    cfg = ARCHS[SERVE_ARCH]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    out["init_params_s"] = time.perf_counter() - t0
    out["param_bytes"] = sum(int(t.numel() * t.element_size()) for t in _leaves(params))
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1001, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    out["prompt_lens"] = [int(n) for n in lens]
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=SERVE_SLOTS), device=dev)

    runs = {}
    results = {}
    real = lm.prefill, lm.decode_step
    for name in ("generate", "generate_continuous"):
        lm.prefill, lm.decode_step = _Timed(real[0]), _Timed(real[1])
        before = dict(LAUNCHES)
        try:
            t0 = time.perf_counter()
            results[name] = getattr(eng, name)(prompts, max_new_tokens=SERVE_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pre, dec = lm.prefill.ms, lm.decode_step.ms
        finally:
            lm.prefill, lm.decode_step = real
        k3 = LAUNCHES["flash_attention"] - before["flash_attention"]
        k4 = LAUNCHES["decode_attention"] - before["decode_attention"]
        per_call = cfg.n_layers if dev.type == "cuda" else 0  # the CPU takes the plain versions
        check(k3 == per_call * len(pre), f"{name}: {k3} K3 launches, {len(pre)} prefills")
        check(k4 == per_call * len(dec), f"{name}: {k4} K4 launches, {len(dec)} steps")
        toks = results[name]
        check(len(toks) == SERVE_REQUESTS and all(len(t) == SERVE_NEW for t in toks),
              f"{name}: {[len(t) for t in toks]} tokens per request")
        check(all(0 <= t < cfg.vocab_size for r in toks for t in r), f"{name}: token outside vocab")
        runs[name] = {"wall_s": wall, "tokens": SERVE_REQUESTS * SERVE_NEW,
                      "tokens_per_s": SERVE_REQUESTS * SERVE_NEW / wall,
                      "prefill_calls": len(pre), "prefill_ms": pre,
                      "decode_steps": len(dec), "decode_ms_per_step_mean": float(np.mean(dec)),
                      "decode_ms_per_step_median": float(np.median(dec)),
                      "decode_tokens_per_s": SERVE_SLOTS * len(dec) / (sum(dec) / 1e3),
                      "flash_attention_launches": k3, "decode_attention_launches": k4,
                      "distinct_tokens_per_request": [len(set(t)) for t in toks]}
    check(results["generate_continuous"][:SERVE_SLOTS] == results["generate"][:SERVE_SLOTS],
          "the first wave's tokens differ between the schedulers")
    out["runs"] = runs
    out["first_wave_equal"] = True
    out["peak_memory_serving"] = torch.cuda.max_memory_allocated(dev)

    with uncounted():
        out["prefill_decode_consistency"] = _prefill_decode_consistency(
            params, cfg, prompts[0] + [int(rng.integers(0, cfg.vocab_size))], dev)
        # launches and busy share of decode steps: a 4-slot wave at plen 1,024
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1024))
                                .astype(np.int32)).to(dev)
        with torch.inference_mode():
            logits, cache = lm.prefill(params, {"tokens": toks}, cfg, max_len=1024 + 16)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            pos = iter(range(1024, 1024 + 16))

            def steps(n):
                for _ in range(n):
                    lm.decode_step(params, cache, {"tokens": tok}, next(pos), cfg)

            prof = _device_profile(steps, 8)
        prof["kernel_launches_per_step"] = prof["kernel_launches"] / 8
        out["decode_profile"] = prof
        del cache, logits
    out["peak_memory"] = torch.cuda.max_memory_allocated(dev)
    del params, eng
    torch.cuda.empty_cache()
    return out


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]


def phase_serve_launcher() -> dict:
    """(c) ``python -m repro_torch.launch.serve --arch phi4-mini-3.8b`` on
    the card at its defaults."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", SERVE_ARCH],
                         capture_output=True, text=True, env=env, cwd=root, timeout=300)
    check(res.returncode == 0, f"serve launcher failed:\n{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    check(len(lines) == 2 and all(" -> [" in ln for ln in lines), f"launcher printed {lines}")
    return {"wall_s": time.perf_counter() - t0, "lines": lines}


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
    sources = ("spike_accum", "attention")
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        for fut in [pool.submit(_build.build_library, src) for src in sources]:
            fut.result()
    for src in sources:
        _build.load_library(src)
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0, "nvcc_s": _build.BUILD_SECONDS,
          "mem_rate": rate_note, "tf32": False})

    kern = phase_kernels(dev, rate)
    kern.update(phase_attention(dev, rate))
    emit({"phase": "kernels_check", **kern})

    reset_launches()  # the main paths start here
    emit({"phase": "launcher", **phase_launcher("cuda")})
    emit({"phase": "real_size", **phase_real_size("cuda")})
    emit({"phase": "serve", **phase_serve(dev)})
    launches = dict(LAUNCHES)
    emit({"phase": "serve_launcher", **phase_serve_launcher()})
    for kname, n in launches.items():
        check(n > 0, f"main path never launched {kname}")

    csrc = "src/repro_torch/kernels/csrc/"
    rows = []
    for kname, source, replaces, case in (
        ("spike_accum_blocks", "spike_accum.cu", "spike_accum.py:133", "rate_1pct"),
        ("spike_accum", "spike_accum.cu", "spike_accum.py:62", "rate_1pct"),
        ("flash_attention", "attention.cu", "flash_attention.py:116", "phi4_prefill/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94", "phi4_decode/bfloat16"),
    ):
        table = kern[kname]
        c = table["cases"][case] if "cases" in table else table[case]
        rows.append({"name": kname, "route": "cuda", "source": csrc + source,
                     "replaces": "src/repro/kernels/" + replaces, "launches": launches[kname],
                     "max_abs_err": table["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                     "device_ms": c["device_ms"]})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
