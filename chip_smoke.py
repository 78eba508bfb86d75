#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) on the card, with nothing of JAX or
of the JAX package ``repro``: the brain simulation (phases 3-4) and LM
serving of three architectures (phase 5).  Every main path runs as a user's
call runs it on the card: each step after the first replays a CUDA graph
of one step (``repro_torch.graphs``); the same run op by op
(``graph=False``, the launchers' ``--eager``) is its check.  Each phase
prints one JSON line; any failed check raises, so the script exits
nonzero.

1. Environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions, the kernel build's seconds (one ``nvcc`` per source,
   all started together); TF32 off.
2. Kernels: each hand-written kernel against its plain PyTorch version
   at the main paths' shapes, two runs bit-identical.  Spike accumulation
   (firing 0 %, 1 %, one fully active block, every row, weighted spikes;
   ``spike_accum`` also at the single-device oracle's W f32[32768, 32768]
   at 2 % firing) against the plain versions on float64 copies with
   ``rtol=1e-5, atol=1e-4`` (the kernels sum in another order than the
   einsum).
   Attention on transposed views as the model passes them, float32 and
   bfloat16 at the reference's tolerances: the reference's sweep (MQA,
   bidirectional, window 96, 384 tokens, ragged ``seq_lens``),
   phi4-mini-3.8b's shapes, recurrentgemma-9b's (MQA with 16 q heads, head
   dim 256, window 2,048; decode with ``slot_pos``, also a misaligned ring
   whose valid slots are not a prefix; the window bound ``slot_lo`` a device
   scalar, as the model passes it).  The scans against their plain
   versions on float64 copies at the reference's ``3e-3``: ``ssd_scan`` at
   the reference's sweep, chunks of 127 and 96, and mamba2-1.3b's prefill,
   its final state too; ``rglru_scan`` at the sweep and at the four shapes
   recurrentgemma-9b's prefills give it (batch 4 at 1,024 and 512 tokens,
   batch 1 at 1,024 and 4,096), each with its launch geometry
   (``rglru_plan``), the hash of its trace and the exact traces of a = b =
   1 (t + 1) and a = 0 (b).  Kernel, plain, library-yardstick (none for
   the scans) and bound times (``ssd_scan``'s 3xTF32 products at the TF32
   peak); at the main paths' shapes also their device times
   (``torch.profiler``), and for every spike-accumulation case the
   kernel's.
3. The launcher (``repro_torch.launch.run_brainsim.main``) for each of the
   four exchanges, at its defaults and with channel noise (``--noise 2``,
   which spreads the firing over the run so the rasters depend on the
   synapses and on every message): sparse == ragged == flat == two_level
   bit for bit, each replayed raster equal to the same run's with
   ``--eager``, one ``spike_accum_blocks`` launch per step, and a
   communicator that loses a message changes the noisy raster.
4. Real size through the public API: 2,048 populations x 16 neurons =
   32,768 neurons on 8 ranks in a (2, 4) mesh under a per-neuron drive
   ``U(3, 8)`` (firing spread over the run, a few percent of the neurons
   per step), 200 steps of sparse, ragged/fused and ragged/per_round
   (identical rasters, executed bytes == ``exchange_volume`` on every
   step), replayed and, uncounted, eager: rasters and ledgers equal, ms
   per step of each, capture seconds; for sparse and ragged a profile of
   each (device ms, CUDA kernels and graph launches per step, busy share,
   and whether the profiler sees the graph's kernels).  Every replayed
   step's synaptic current equals the dense ``s @ W`` in float64; the
   raster equals the single-device engine's with the ``spike_accum``
   kernel as its current hook (replayed, and eager as its check), whose
   device time per step under the raster's own spikes is profiled in a
   second, uncounted run; a lost ragged payload changes the raster.
5. Serving (``repro_torch.serve``) of phi4-mini-3.8b (attention: prefill
   runs ``flash_attention``, decode ``decode_attention``), mamba2-1.3b (48
   ssm layers: prefill runs ``ssd_scan``, decode plain recurrence steps)
   and recurrentgemma-9b (26 rglru layers running ``rglru_scan`` in
   prefill, 12 local-attention layers with a ring-buffer cache), each
   freed before the next: (a) the reduced config, prefill of 64 tokens and
   8 teacher-forced decode steps on the card and on the CPU from the same
   numpy parameters, logits within two bf16 steps (bf16) and 1e-3
   (float32); (b) full width and depth, bf16, random weights from a seed:
   8 requests (prompt lengths 64-1,000) through ``ServeEngine.generate``
   (waves of 4) and ``generate_continuous``, 64 greedy tokens each (for
   recurrentgemma-9b also one batch-1 request of 4,096 tokens, two
   windows), every prefill and every decode step launching exactly one
   kernel per layer of its mixer (no scan in decode), finite logits; the
   first wave's tokens equal under both schedulers (phi4-mini-3.8b), or,
   under float32 compute, its last request's (the only one the reference's
   initial fill of ``generate_continuous`` leaves with its own state);
   prefill(S) + decode(S) against prefill(S + 1) within 0.05 under float32
   compute (S = 861, 127, 4,096); no ssm layer recomputing its final state
   with the CPU path's closed form; prefill / decode times, tokens/s,
   launches and device busy share of decode steps, peak memory.  Decode
   replays a CUDA graph per batch; the same requests eager (uncounted) give
   the same greedy tokens under both schedulers, and a teacher-forced
   window of each (profiled: device ms, kernels and graph launches per
   step, busy share) gives logits within two bf16 steps (bit-equality
   reported); capture seconds and the peak memory of each.  (c) the
   serving launcher ``python -m repro_torch.launch.serve`` at its
   defaults.
6. The launches of ``rglru_scan`` on recurrentgemma-9b's main path by
   input shape and by batch; a ``kernels`` line (all six kernels; K2 at 1 %
   firing on W f32[32768, 4096] and at the oracle's shape, K3 and K4 at
   phi4-mini-3.8b's and at recurrentgemma-9b's shapes, K6 at the batch-4
   wave and the batch-1 prefill of 1,024 tokens), the card's name and power
   limit, and the last line, ``{"ok": true, "device": {...}}``.

Each main path (phases 3-4, and each model of phase 5) runs with the
launch counts set to 0 just before it and read just after, and must have
launched each of its kernels; the ``kernels`` line sums them.  Runs made
only to check (probed currents, planted faults, the card-vs-CPU and
consistency checks, the profiled windows) leave the counts as they were.
Exits 2 without CUDA.
"""
from __future__ import annotations

import contextlib
import hashlib
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
LONG_PROMPT = 4096  # recurrentgemma-9b's batch-1 request: two local windows
F32_PEAK = 67e12  # H100 SXM float32 FLOP/s outside the tensor cores (data sheet)
TF32_PEAK = 494.7e12  # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)


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


def timings(kern, plain, lib, main: bool, device: bool = False) -> dict:
    """Times of a kernel, its plain version and the library call (None
    where no single PyTorch call computes the function).  ``ms`` keys: CUDA
    events around back-to-back calls, which include the host's dispatch
    where the host is the slower side.  For a case of the main path
    (``main``) also ``device_ms`` keys: the device time of the kernels each
    call launches, from ``torch.profiler``; with ``device`` only the
    kernel's.  ``device_kernels``: the kernel's time per CUDA kernel.  A
    kernel launches each of its CUDA kernels once a call, so its
    ``device_ms`` sums each CUDA kernel's mean over the calls the profiler
    saw (it now and then misses some); the plain version's and the
    library's divide their window's device time by the calls made."""
    out = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, 5),
           "library_ms": None if lib is None else cuda_ms(lib, 5)}
    if main or device:
        reps = 10
        for key, fn in (("device_ms", kern), ("plain_device_ms", plain if main else None),
                        ("library_device_ms", lib if main else None)):
            if fn is None:
                out[key] = None
                continue
            for _ in range(3):  # the profiler now and then reads no device time
                prof = _device_profile(lambda n, fn=fn: [fn() for _ in range(n)], reps)
                if prof["device_busy_s"] > 0:
                    break
            out[key] = prof["device_busy_s"] * 1e3 / reps
            if key == "device_ms":
                out[key] = sum(k["device_ms"] / k["calls"] for k in prof["kernels"])
                out["device_kernels"] = [{**k, "device_ms": k["device_ms"] / k["calls"]}
                                         for k in prof["kernels"]]
    return out


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside are checks, not the main path's run:
    the launch counts are put back as they were."""
    from repro_torch.kernels import LAUNCHES

    saved, shapes = dict(LAUNCHES), dict(SHAPES)
    try:
        yield
    finally:
        LAUNCHES.update(saved)
        SHAPES.clear()
        SHAPES.update(shapes)


#: launches of ``rglru_scan`` by input shape ``(B, S, D)`` while
#: :func:`shapes_of_rglru` is on, kept like the launch counts
SHAPES: dict[tuple, int] = {}


@contextlib.contextmanager
def shapes_of_rglru():
    """Counts the shapes ``rglru_scan`` launches at, where the model's
    dispatch (``kernels.ops.rglru``) calls it; launches made inside
    :func:`uncounted` are put back as they were."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import scan

    real = scan.rglru_scan

    def counted(a, b):
        before = LAUNCHES["rglru_scan"]
        out = real(a, b)
        if LAUNCHES["rglru_scan"] > before:
            key = tuple(a.shape)
            SHAPES[key] = SHAPES.get(key, 0) + 1
        return out

    SHAPES.clear()
    scan.rglru_scan = counted
    try:
        yield SHAPES
    finally:
        scan.rglru_scan = real


@contextlib.contextmanager
def captures():
    """The seconds of every CUDA-graph capture made inside
    (``repro_torch.graphs.StepGraph``), listed as they happen."""
    from repro_torch import graphs

    real, seen = graphs.StepGraph._capture, []

    def timed(self):
        real(self)
        seen.append(self.capture_s)

    graphs.StepGraph._capture = timed
    try:
        yield seen
    finally:
        graphs.StepGraph._capture = real


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
    """K1 / K2 against their plain versions at the main path's shapes: K1
    on 8 ranks of 8 tiles of 4,096 x 4,096, K2 on one rank's W f32[32768,
    4096] and, as ``oracle_2pct``, on the single-device oracle's W
    f32[32768, 32768] (the same storage viewed whole) at 2 % firing."""
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
    w_oracle = blocks.view(n_blocks * b, n_dev * b)  # K2: W f32[32768, 32768]
    rank = torch.arange(n_dev, device=dev)[:, None]
    # the plain versions on float64 copies are the yardstick of correctness:
    # at 32,768 fired rows a float32 sum in any order drifts by about
    # sqrt(n) roundings, near the tolerance itself
    blocks64 = blocks.double()
    w2_64 = blocks64[0].reshape(n_blocks * b, b)
    w_oracle64 = blocks64.view(n_blocks * b, n_dev * b)

    def spikes(case: str, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=gen, device=dev)
        if case == "rate_0":
            return torch.zeros(shape, device=dev)
        if case == "rate_1pct":
            return (u < 0.01).float()
        if case == "oracle_2pct":  # the real-size network's firing (phase 4)
            return (u < 0.02).float()
        if case == "all_fire":  # the densest step there can be
            return torch.ones(shape, device=dev)
        if case == "one_active_block":
            s = torch.zeros(shape, device=dev)
            s.view(-1, b)[3] = 1.0
            return s
        return u * (torch.rand(shape, generator=gen, device=dev) < 0.05)  # weighted

    result = {}
    common = ("rate_0", "rate_1pct", "one_active_block", "all_fire", "weighted")
    for name in ("spike_accum_blocks", "spike_accum"):
        cases, worst = {}, 0.0
        for case in common + (("oracle_2pct",) if name == "spike_accum" else ()):
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
                w, w64 = (w_oracle, w_oracle64) if case == "oracle_2pct" else (w2, w2_64)
                s = spikes(case, (n_blocks * b,))
                kern = lambda: k.spike_accum(s, w)  # noqa: E731
                plain = lambda: spike_accum_ref(s, w)  # noqa: E731
                lib = lambda: torch.mv(w.t(), s)  # noqa: E731
                exact = spike_accum_ref(s.double(), w64)
                fired = float((s != 0).sum())
                n_cols = w.shape[1]
                nbytes = fired * n_cols * 4 + s.numel() * 4 + n_cols * 4
                flops = 2 * fired * n_cols
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
                **timings(kern, plain, lib, case in ("rate_1pct", "oracle_2pct"), device=True),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            worst = max(worst, err)
        result[name] = {"cases": cases, "max_abs_err": worst}
    del blocks, w2, w_oracle, blocks64, w2_64, w_oracle64
    torch.cuda.empty_cache()
    return result


BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
ATTN_TOL = {"float32": dict(rtol=3e-3, atol=3e-3),  # tests/test_kernels.py:19-20
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# recurrentgemma's bf16 cases average 400-4,000 keys, so their outputs are
# a few hundredths and 2e-2 would let a lost 32-key tile through.  They
# are also held to one bf16 step of the reference value plus two steps of
# the rms of its row (the head dim of one query): K3 and K4 round P to
# bf16 before P V, as the TPU kernels do (flash_attention.py:97,
# decode_attention.py:76), and that error scales with the row, not with
# the whole output.  ``bf16_row_bound_used`` is the share of the row's
# allowance the worst element takes.  A planted fault (the values of one
# 32-key tile zeroed) must fail the same bound.
BF16_REL, BF16_ROW = 2**-7, 2**-6


def _bf16_row_excess(got, want) -> float:
    """max((|got - want| - 2^-7 |want|) / rms_row(want)) - 2^-6: <= 0 passes."""
    import torch

    got, want = got.float(), want.float()
    row = want.double().pow(2).mean(-1, keepdim=True).sqrt().float()
    row = row.clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got - want).abs() - BF16_REL * want.abs()).div(row).max()) - BF16_ROW


def _zero_tile(v, start: int):
    """A copy of the [B, H, S, D] view ``v`` with rows [start, start + 32) zeroed."""
    bad = v.clone()
    bad[:, :, start:start + 32] = 0
    return bad

# (name, b, hq, hkv, sq, sk, d, causal, window): the reference's sweep
# (tests/test_kernels.py:23-44), then phi4-mini-3.8b's prefill (a 4-slot wave
# padded to 1,024 tokens) and recurrentgemma-9b's local layers (MQA, head
# dim 256, window 2,048: a 4-slot wave of 1,024 tokens, and the batch-1
# 4,096-token prompt)
FLASH_CASES = [
    ("gqa", 2, 4, 2, 256, 256, 64, True, None),
    ("mqa", 1, 8, 1, 128, 128, 32, True, None),
    ("bidirectional", 2, 4, 4, 256, 256, 64, False, None),
    ("window_96", 1, 4, 2, 256, 256, 64, True, 96),
    ("seq_384", 1, 2, 2, 384, 384, 16, True, 128),
    ("phi4_prefill", 4, 24, 8, 1024, 1024, 128, True, None),
    ("rg_prefill", 4, 16, 1, 1024, 1024, 256, True, 2048),
    ("rg_prefill_4096", 1, 16, 1, 4096, 4096, 256, True, 2048),
]
# (name, b, hq, hkv, s, d, valid): valid rows None for all, "ragged", a
# prefix length, or slot_pos handed to the kernel with slot_lo = pos -
# 2,048: ("prefix", n) fills slots [0, n) at decode position n - 1,
# ("ring", n) holds positions [n - s, n) after a prefill of n tokens, slot
# n % s then overwritten by position n.  tests/test_kernels.py:47-61, then
# phi4-mini-3.8b's decode (4 slots, cache 1,088 = 1,024 + 64 rows, 1,056 of
# them valid half-way through the wave), recurrentgemma-9b's local decode
# (the same wave: window 2,048 > 1,088, so its slot_pos is a prefix) and its
# ring after a misaligned 3,000-token prefill (slot 952 holds position
# 3,000; slot 0 holds 952, outside the window)
DECODE_CASES = [
    ("full_cache", 2, 4, 2, 1024, 64, None),
    ("ragged_g4", 3, 8, 2, 512, 32, "ragged"),
    ("ragged_d128", 1, 2, 1, 2048, 128, "ragged"),
    ("phi4_decode", 4, 24, 8, 1088, 128, 1056),
    ("rg_decode", 4, 16, 1, 1088, 256, ("prefix", 1056)),
    ("rg_ring_misaligned", 1, 16, 1, 2048, 256, ("ring", 3000)),
]
RG_WINDOW = 2048


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

    def record(table, key, kern, plain, lib, nbytes, flops, dtype, planted=None):
        out, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{key}: reruns differ")
        err = float((out.float() - want.float()).abs().max())
        check(torch.allclose(out.float(), want.float(), **ATTN_TOL[dtype]), f"{key}: max err {err}")
        extra = {}
        if planted is not None:  # recurrentgemma's bf16 cases
            excess, fault = _bf16_row_excess(out, want), _bf16_row_excess(planted(), want)
            check(excess <= 0, f"{key}: {excess} rms of its row over the bf16 bound")
            check(fault > 0, f"{key}: a zeroed 32-key tile passes the bf16 bound")
            extra = {"bf16_row_excess": excess, "planted_fault_row_excess": fault,
                     "bf16_row_bound_used": 1.0 + excess / BF16_ROW}
        bound_ms, bound_by = _bound(nbytes, flops, rate,
                                    BF16_PEAK if dtype == "bfloat16" else F32_PEAK)
        table[key] = {"max_abs_err": err, "bit_identical_rerun": True, **extra,
                      **timings(kern, plain, lib, key.startswith(("phi4", "rg_"))),
                      "bound_ms": bound_ms, "bound_by": bound_by}

    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for name, b, hq, hkv, sq, sk, d, causal, window in FLASH_CASES:
            q = randn(b, sq, hq, d, dtype=td).transpose(1, 2)
            kk, v = (randn(b, sk, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
            kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kk, v))
            mask = None
            if window is not None and window < sk:  # a window >= S cuts nothing
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
            planted = (lambda: attention_ref(q, kk, _zero_tile(v, sk // 2), causal=causal,
                                             window=window)) \
                if dtype == "bfloat16" and name.startswith("rg_") else None
            record(result["flash_attention"], f"{name}/{dtype}",
                   lambda: k.flash_attention(q, kk, v, causal=causal, window=window),
                   lambda: attention_ref(q, kk, v, causal=causal, window=window),
                   lib, nbytes, 4.0 * b * hq * pairs * d, dtype, planted)
        for name, b, hq, hkv, s, d, valid in DECODE_CASES:
            q = randn(b, hq, d, dtype=td)
            kk, v = (randn(b, s, hkv, d, dtype=td).transpose(1, 2) for _ in "kv")
            idx = torch.arange(s, dtype=torch.int32, device=dev)
            if isinstance(valid, tuple):  # slot_pos, as the windowed decode passes it
                kind, n = valid
                if kind == "prefix":
                    sp, lo = torch.where(idx < n, idx, -1).to(torch.int32), n - 1 - RG_WINDOW
                else:  # a prefill of n rows kept the last s; decode at n wrote slot n % s
                    sp, lo = idx + (n - s), n - RG_WINDOW
                    sp[n % s] = n
                # the bound as the model passes it: a device scalar
                kw = {"slot_pos": sp, "slot_lo": torch.tensor(lo, dtype=torch.int32, device=dev)}
                keep = ((sp >= 0) & (sp > lo)).expand(b, s)
            else:
                sl = (torch.randint(1, s + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
                      if valid == "ragged" else
                      torch.full((b,), valid or s, dtype=torch.int32, device=dev))
                kw = {"seq_lens": sl}
                keep = idx[None, :] < sl[:, None]
            kr, vr = (x.repeat_interleave(hq // hkv, dim=1) for x in (kk, v))
            rows = float(keep.sum())
            index_bytes = 4 * next(iter(kw.values())).numel()
            nbytes = (2 * rows * hkv * d + 2 * q.numel()) * q.element_size() + index_bytes
            planted = (lambda: decode_attention_ref(q, kk, _zero_tile(v, s // 2), **kw)) \
                if dtype == "bfloat16" and name.startswith("rg_") else None
            record(result["decode_attention"], f"{name}/{dtype}",
                   lambda: k.decode_attention(q, kk, v, **kw),
                   lambda: decode_attention_ref(q, kk, v, **kw),
                   lambda: F.scaled_dot_product_attention(q[:, :, None], kr, vr,
                                                          attn_mask=keep[:, None, None, :]),
                   nbytes, 4.0 * rows * hq * d, dtype, planted)
    for table in result.values():
        table["max_abs_err"] = max(c["max_abs_err"] for c in table.values())
    torch.cuda.empty_cache()
    return result


SCAN_TOL = dict(rtol=3e-3, atol=3e-3)  # tests/test_kernels.py:74-76, 101-103
# (name, b, s, h, g, p, n, chunk): the reference's sweep (tests/test_kernels.py:
# 64-76), chunks that are not powers of two (127 = min(128, S) at S = 127;
# 96), then mamba2-1.3b's prefill (a 4-slot wave of 1,024 tokens)
SSD_CASES = [
    ("sweep_1", 2, 256, 4, 2, 32, 16, 64),
    ("sweep_2", 1, 128, 2, 1, 16, 8, 128),
    ("sweep_3", 1, 512, 8, 2, 64, 32, 128),
    ("chunk_127", 1, 127, 64, 1, 64, 128, 128),
    ("chunk_96", 2, 384, 8, 2, 32, 16, 96),
    ("mamba2_prefill", 4, 1024, 64, 1, 64, 128, 128),
]
# (name, b, s, d): tests/test_kernels.py:94-103, then the shapes
# recurrentgemma-9b's prefills give it (lru_width 4,096): a 4-slot wave of
# 1,024 tokens and of 512 (``generate``'s two waves), a batch-1 prefill of
# 1,024 (``generate_continuous``) and the batch-1 request of 4,096 tokens
RGLRU_CASES = [
    ("sweep_1", 2, 256, 128), ("sweep_2", 1, 128, 256), ("sweep_3", 3, 512, 64),
    ("rg_prefill", 4, 1024, 4096), ("rg_wave2", 4, 512, 4096),
    ("rg_continuous", 1, 1024, 4096), ("rg_long", 1, LONG_PROMPT, 4096),
]


def phase_scans(dev, rate: float) -> dict:
    """K5 / K6 against their plain versions on float64 copies (the
    reference's tolerance), two runs bit-identical; K5 also returns its
    final state, held to the plain version's carried state.  No single
    PyTorch call computes either function, so there is no library time.

    K5's bound counts the work its design needs: per (batch, group, chunk)
    C Bᵀ, 2 T N, and per (batch, head, chunk) 2 T P + 4 L N P, where T =
    L (L + 1) / 2 are the (t, s <= t) pairs the causal mask keeps, as
    ``_valid_pairs`` counts them for K3; each product three times (3xTF32)
    at the TF32 tensor-core peak; bytes x, a, B, C and y once and the final
    state.  ``bound_ms_bytes`` is the byte term alone (what a single TF32
    pass would leave as the bound); ``bound_ms_f32`` keeps the float32
    CUDA-core bound of the kernel before it (C Bᵀ per head, no state), for
    comparison."""
    import torch

    from repro_torch.kernels import scan as k
    from repro_torch.kernels.ref import rglru_ref, ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(2)
    result = {"ssd_scan": {}, "rglru_scan": {}}

    def record(table, name, kern, plain, exact, nbytes, flops, main, peak=F32_PEAK):
        out, again = kern(), kern()
        torch.cuda.synchronize()
        out, again = (o[0] if isinstance(o, tuple) else o for o in (out, again))
        check(torch.equal(out, again), f"{name}: reruns differ")
        err = float((out.double() - exact).abs().max())
        check(torch.allclose(out.double(), exact, **SCAN_TOL), f"{name}: max err {err}")
        bound_ms, bound_by = _bound(nbytes, flops, rate, peak)
        want = plain()
        want = want[0] if isinstance(want, tuple) else want
        table[name] = {"max_abs_err": err, "bit_identical_rerun": True,
                       "max_abs_diff_vs_plain_f32": float((out - want).abs().max()),
                       **timings(kern, plain, None, main),
                       "bound_ms": bound_ms, "bound_by": bound_by}
        return table[name]

    for name, b, s, h, g, p, n, chunk in SSD_CASES:
        x = torch.randn((b, s, h, p), generator=gen, device=dev)
        a = 0.85 + 0.149 * torch.rand((b, s, h), generator=gen, device=dev)
        bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev) for _ in "bc")
        ell = min(chunk, s)
        exact, exact_state = ssd_chunked(x.double(), a.double(), bm.double(), cm.double(),
                                         chunk=chunk, return_state=True)
        pairs = _valid_pairs(ell, ell, True, None)
        nc = s // ell
        flops = 3 * (b * g * nc * 2 * pairs * n + b * h * nc * (2 * pairs * p + 4 * ell * n * p))
        nbytes = (2 * x.numel() + a.numel() + 2 * bm.numel() + b * h * n * p) * 4
        # prefill asks for the final state (models/layers.mamba2_block)
        row = record(result["ssd_scan"], name,
                     lambda: k.ssd_scan(x, a, bm, cm, chunk=chunk, return_state=True),
                     lambda: ssd_chunked(x, a, bm, cm, chunk=chunk, return_state=True),
                     exact, nbytes, flops, name.startswith("mamba2"), TF32_PEAK)
        (_, state), (_, again) = (k.ssd_scan(x, a, bm, cm, chunk=chunk, return_state=True)
                                  for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(state, again), f"{name}: final states of two runs differ")
        err = float((state.double() - exact_state).abs().max())
        check(torch.allclose(state.double(), exact_state, **SCAN_TOL),
              f"{name}: final state max err {err}")
        old_flops = b * h * nc * (2 * pairs * n + 2 * pairs * p + 4 * ell * n * p)
        row.update(state_max_abs_err=err, tf32_products=3, bound_ms_bytes=nbytes / rate * 1e3,
                   bound_ms_f32=_bound(nbytes - b * h * n * p * 4, old_flops, rate)[0],
                   plan=k.ssd_plan(b, s, h, g, p, n, chunk))
        del exact, exact_state
    for name, b, s, d in RGLRU_CASES:
        a = 0.8 + 0.199 * torch.rand((b, s, d), generator=gen, device=dev)
        bb = torch.randn((b, s, d), generator=gen, device=dev)
        row = record(result["rglru_scan"], name, lambda: k.rglru_scan(a, bb),
                     lambda: rglru_ref(a, bb), rglru_ref(a.double(), bb.double()),
                     3 * a.numel() * 4, 2 * a.numel(), name.startswith("rg"))
        # the trace's bytes, to hold it bit for bit to another build's
        row["trace_sha256"] = hashlib.sha256(
            k.rglru_scan(a, bb).cpu().numpy().tobytes()).hexdigest()
        # exact traces: with a = 1, b = 1 every h_t is t + 1 (integers below
        # 2^24); with a = 0 it is b.  A carry lost or doubled across ring
        # stages, tiles or tails fails these exactly.
        ones = torch.ones_like(a)
        steps = torch.arange(1, s + 1, device=dev, dtype=torch.float32)[None, :, None]
        check(torch.equal(k.rglru_scan(ones, ones), steps.expand(b, s, d)),
              f"{name}: a = b = 1 does not give t + 1")
        check(torch.equal(k.rglru_scan(torch.zeros_like(a), bb), bb), f"{name}: a = 0 is not b")
        row["exact_traces"] = True
        if hasattr(k, "rglru_plan"):  # absent in a tree before the channel-tile ring
            row["plan"] = k.rglru_plan(b, s, d)
    for table in result.values():
        table["max_abs_err"] = max(c["max_abs_err"] for c in table.values())
    result["ssd_scan"]["state_max_abs_err"] = max(
        c["state_max_abs_err"] for c in result["ssd_scan"].values() if isinstance(c, dict))
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
            line = [*argv, *extra, "--exchange", exch, "--device", device]
            before = LAUNCHES["spike_accum_blocks"]
            t0 = time.perf_counter()
            with captures() as caps:
                res = run_brainsim.main(line)  # replayed from a CUDA graph on the card
            wall = time.perf_counter() - t0
            rasters[exch], engines[exch] = res["raster"], res["engine"]
            runs[exch] = {"spike_accum_blocks": LAUNCHES["spike_accum_blocks"] - before,
                          "wall_s": wall, "capture_s": sum(caps), "graph": res["engine"].graph}
            with uncounted():  # the same run op by op, its check
                t0 = time.perf_counter()
                eager = run_brainsim.main([*line, "--eager"])["raster"]
                runs[exch]["eager_wall_s"] = time.perf_counter() - t0
            check(np.array_equal(eager, rasters[exch]), f"{tag}/{exch}: replayed != eager")
        steps = rasters["flat"].shape[0]
        for exch in ("two_level", "sparse", "ragged"):
            check(np.array_equal(rasters[exch], rasters["flat"]), f"{tag}: {exch} != flat")
        for exch in ("sparse", "ragged"):
            check(runs[exch]["spike_accum_blocks"] == (steps if per_run_launches else 0),
                  f"{tag}/{exch}: {runs[exch]} kernel launches for {steps} steps")
        row = {"steps": steps, "spikes": int(rasters["flat"].sum()), "runs": runs,
               "replayed_equals_eager": True}
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


def _device_profile(run, steps: int, match: tuple[str, ...] = ()) -> dict:
    """Where ``run(steps)``'s time goes: device time by kernel under
    ``torch.profiler`` and the device's busy share of the run's wall time
    (the profiler's own cost is inside that wall time; a CUDA-graph capture
    made inside is not: ``capture_s``), CUDA kernels and graph launches
    (``cudaGraphLaunch`` calls).  With ``match``, also the device time and
    calls of every kernel whose name contains one of its strings."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(2)
    torch.cuda.synchronize()
    with captures() as caps, profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - sum(caps)

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    # kernel events only: an aten op's device time is its kernels' time again
    events = prof.key_averages()
    rows = sorted((e for e in events if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e6
    out = {"wall_s": wall, "capture_s": sum(caps), "device_busy_s": busy,
           "device_busy_share": busy / wall,
           "kernels": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
                        "calls": e.count} for e in rows[:8]],
           "kernel_launches": sum(e.count for e in rows),
           "graph_launches": sum(e.count for e in events if "cudaGraphLaunch" in e.key)}
    if match:
        hit = [e for e in rows if any(s in e.key for s in match)]
        out["matched"] = {"device_ms": sum(dev_us(e) for e in hit) / 1e3,
                          "calls": sum(e.count for e in hit)}
    return out



def _per_step(prof: dict, steps: int) -> dict:
    """A profile of ``steps`` steps with its per-step rates."""
    return {**prof, "device_ms_per_step": prof["device_busy_s"] * 1e3 / steps,
            "kernels_per_step": prof["kernel_launches"] / steps,
            "graph_launches_per_step": prof["graph_launches"] / steps}


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

    def engine(exch: str, mode: str = "fused", graph: bool | None = None) -> DistributedSNN:
        return DistributedSNN(mesh=mesh, params=params, exchange=exch, i_ext=drive,
                              syn=syn, ragged_scatter=mode, tiles=tiles, device=dev,
                              graph=graph)

    def timed(run):
        """(result, wall seconds, seconds of the captures inside)."""
        sync()
        t0 = time.perf_counter()
        with captures() as caps:
            res = run()
        sync()
        return res, time.perf_counter() - t0, sum(caps)

    # the counted runs replay a CUDA graph of one step (the engines' default
    # on the card); the same runs op by op are their checks, uncounted
    runs, rasters, profiles = {}, {}, {}
    for tag, exch, mode in (("sparse", "sparse", "fused"),
                            ("ragged_fused", "ragged", "fused"),
                            ("ragged_per_round", "ragged", "per_round")):
        eng = engine(exch, mode)
        with uncounted():  # warm up, the card's clocks too
            eng.run(steps)
        comm = LoopbackComm(mesh, dev)
        before = LAUNCHES["spike_accum_blocks"]
        raster, wall, capture_s = timed(lambda: eng.run(steps, comm=comm))
        launched = LAUNCHES["spike_accum_blocks"] - before
        vol = eng.exchange_stats()
        check(launched == per_run, f"{tag}: {launched} kernel launches for {steps} steps")
        check(comm.step_bytes == [vol[exch]] * steps,
              f"{tag}: executed bytes {set(comm.step_bytes)} != {vol[exch]}")
        with uncounted():
            eager, eager_comm = engine(exch, mode, graph=False), LoopbackComm(mesh, dev)
            eager.run(steps)
            eager_raster, eager_wall, _ = timed(lambda: eager.run(steps, comm=eager_comm))
        check(torch.equal(eager_raster, raster), f"{tag}: replayed raster != eager")
        check(eager_comm.step_bytes == comm.step_bytes, f"{tag}: eager bytes differ")
        rasters[tag] = raster
        replay_s = wall - capture_s
        runs[tag] = {"graph": eng.graph, "ms_per_step": replay_s / steps * 1e3,
                     "steps_per_s": steps / replay_s, "capture_s": capture_s,
                     "wall_ms_per_step_with_capture": wall / steps * 1e3,
                     "eager_ms_per_step": eager_wall / steps * 1e3,
                     "bytes_per_step": vol[exch], "spike_accum_blocks_launches": launched,
                     "replayed_equals_eager": True}
        if dev.type == "cuda" and mode == "fused":
            profiles[tag] = {"replayed": _per_step(_device_profile(engine(exch).run, steps),
                                                   steps)}
            with uncounted():
                profiles[tag]["eager"] = _per_step(
                    _device_profile(engine(exch, graph=False).run, steps), steps)
    for prof in profiles.values():  # the profiler sees a graph's kernel nodes
        prof["profiler_sees_graph_kernels"] = (
            prof["replayed"]["kernels_per_step"] >= 0.9 * prof["eager"]["kernels_per_step"])
    if profiles:
        out["profile"] = profiles
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
    # spike_accum kernel (on the card), replayed; op by op as its check
    before = LAUNCHES["spike_accum"]
    res, oracle_s, capture_s = timed(lambda: SNNEngine(
        w_syn=w, params=params, i_ext=drive, device=dev).run(steps, current_fn=spike_currents))
    oracle = res.spikes
    check(LAUNCHES["spike_accum"] - before == per_run, "oracle did not run the kernel")
    check(torch.equal(oracle, raster), "distributed != single-device oracle")
    with uncounted():
        eager = SNNEngine(w_syn=w, params=params, i_ext=drive, device=dev, graph=False)
        res, eager_s, _ = timed(lambda: eager.run(steps, current_fn=spike_currents))
    check(torch.equal(res.spikes, oracle), "oracle: replayed raster != eager")
    out["oracle"] = {"ms_per_step": (oracle_s - capture_s) / steps * 1e3,
                     "capture_s": capture_s, "eager_ms_per_step": eager_s / steps * 1e3,
                     "equal": True, "replayed_equals_eager": True}
    if dev.type == "cuda":
        # the spike_accum kernel's device time per step (one call a step)
        # under the raster's own spikes: its two CUDA kernels, compaction
        # and ring, averaged over the calls the profiler saw
        from repro_torch.kernels.spike_accum import dense_plan
        with uncounted():
            eng = SNNEngine(w_syn=w, params=params, i_ext=drive, device=dev)
            prof = _device_profile(lambda n: eng.run(n, current_fn=spike_currents), steps,
                                   match=("compact_tiles_kernel", "spike_accum_ring_kernel"))
            eager_prof = _device_profile(lambda n: eager.run(n, current_fn=spike_currents),
                                         steps)
        k2 = prof.pop("matched")
        calls = k2["calls"] / 2  # the profiler may miss a launch of the window
        out["oracle"].update(profile={"replayed": _per_step(prof, steps),
                                      "eager": _per_step(eager_prof, steps)},
                             plan=dense_plan(m, m), spike_accum_calls_seen=calls,
                             spike_accum_device_ms_per_step=k2["device_ms"] / calls if calls
                             else None,
                             fired_rows_per_step=float(raster.sum(1).mean()))
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    del w, tiles
    return out


# -- phase 5 ---------------------------------------------------------------

SERVE_ARCH = "phi4-mini-3.8b"
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW = 8, 4, 64
F32_LOGIT_BOUND = 0.05  # tests/test_models.py:94-114, float32 compute
# per serving path: n_kv_heads of the reduced config checked card vs CPU (phi4
# with 2 for GQA), the prompt length S + 1 of the prefill(S) + decode vs
# prefill(S + 1) check (None: the first request's prompt plus one token;
# mamba2: S = 127, since prefill(S) needs min(128, S) to divide S), and
# whether the first wave's tokens must agree between the schedulers
SERVE_PATHS = {
    "phi4-mini-3.8b": {"kv": 2, "consistency_len": None, "first_wave": True},
    "mamba2-1.3b": {"kv": None, "consistency_len": 128, "first_wave": False},
    "recurrentgemma-9b": {"kv": None, "consistency_len": LONG_PROMPT + 1, "first_wave": False},
}


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
    """The LM's parameter tree as numpy float32, drawn from a seed (on the
    host, with the model's own initialisers)."""
    from repro_torch.models import lm

    def to_np(node):
        return {k: to_np(v) for k, v in node.items()} if isinstance(node, dict) \
            else node.float().numpy()

    return to_np(lm.init_params(cfg, seed, device="cpu"))


def _card_vs_cpu(dev, arch: str, kv) -> dict:
    """(a) ``arch`` reduced: prefill of 64 tokens and 8 teacher-forced
    decode steps, on the card (kernels) and on the CPU (plain versions),
    from one set of numpy parameters; bf16 and float32 compute."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.models import lm

    cfg = ARCHS[arch].reduced()
    if kv:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
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
    prefill(S + 1): the prefill kernels held against the decode path at
    full width.  float32 compute holds to the reference's 0.05; bf16 is
    reported."""
    import torch

    from repro_torch.models import lm

    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    s = toks.shape[1] - 1
    out = {"S": s}
    for dtype, label in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        with compute_dtype(dtype), torch.inference_mode():
            _, cache = lm.prefill(params, {"tokens": toks[:, :s]}, cfg, max_len=s + 1)
            dec, _ = lm.decode_step(params, cache, {"tokens": toks[:, s:]}, s, cfg)
            del cache
            full, _ = lm.prefill(params, {"tokens": toks}, cfg)
        check(bool(torch.isfinite(dec[:, : cfg.vocab_size]).all()
                   and torch.isfinite(full[:, : cfg.vocab_size]).all()),
              f"{label}: non-finite logits")
        err = float((dec - full)[:, : cfg.vocab_size].abs().max())
        out[label] = {"max_abs_logit_diff": err,
                      "max_abs_logit": float(full[:, : cfg.vocab_size].abs().max()),
                      "same_argmax": bool(torch.equal(dec[:, : cfg.vocab_size].argmax(-1),
                                                      full[:, : cfg.vocab_size].argmax(-1)))}
    check(out["float32"]["max_abs_logit_diff"] < F32_LOGIT_BOUND,
          f"prefill+decode vs prefill(S+1): {out['float32']}")
    return out


def _launches_per_call(cfg) -> tuple[dict, dict]:
    """The kernel launches one prefill and one decode step must make: one
    per layer of the kernel its mixer runs, nothing else."""
    pat = cfg.layer_pattern
    n_attn = sum(m in ("full", "swa", "local") for m in pat)
    zero = {"spike_accum_blocks": 0, "spike_accum": 0}
    prefill = {**zero, "flash_attention": n_attn, "decode_attention": 0,
               "ssd_scan": pat.count("ssm"), "rglru_scan": pat.count("rglru")}
    decode = {**zero, "flash_attention": 0, "decode_attention": n_attn,
              "ssd_scan": 0, "rglru_scan": 0}
    return prefill, decode


class _Timed:
    """Counts and times (synchronised, on the host clock) calls of
    ``lm.prefill`` and of a batch's decode step (``serve.engine._Decode``:
    the first eager, the second capturing its CUDA graph and replaying it,
    the rest replaying) as the engine makes them, records each call's kernel
    launches and checks its logits are finite."""

    def __init__(self, fn, n_vocab: int):
        self.fn, self.n_vocab, self.ms, self.launches = fn, n_vocab, [], []

    def __call__(self, *args, **kw):
        import torch

        from repro_torch.kernels import LAUNCHES

        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.launches.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        logits = out[0] if isinstance(out, tuple) else out
        check(bool(torch.isfinite(logits[..., : self.n_vocab]).all()), "non-finite logits")
        return out


def _serve_timed(eng, name: str, prompts, cfg, per_call) -> dict:
    """One scheduler of ``eng`` over ``prompts``, every prefill and decode
    call timed and its launches held to ``per_call``."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.serve import engine as serve_engine

    real = lm.prefill, serve_engine._Decode.__call__
    pre, dec = _Timed(real[0], cfg.vocab_size), _Timed(real[1], cfg.vocab_size)
    lm.prefill, serve_engine._Decode.__call__ = pre, lambda self, tokens: dec(self, tokens)
    try:
        t0 = time.perf_counter()
        with captures() as caps:
            toks = getattr(eng, name)(prompts, max_new_tokens=SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        lm.prefill, serve_engine._Decode.__call__ = real
    for kind, timed, want in (("prefill", pre, per_call[0]), ("decode", dec, per_call[1])):
        for i, got in enumerate(timed.launches):
            check(got == want, f"{name}: {kind} call {i} launched {got}, expected {want}")
    check(len(toks) == len(prompts) and all(len(t) == SERVE_NEW for t in toks),
          f"{name}: {[len(t) for t in toks]} tokens per request")
    check(all(0 <= t < cfg.vocab_size for r in toks for t in r), f"{name}: token outside vocab")
    slots = eng.sc.batch_slots
    return {"tokens_out": toks, "graph": eng.graph, "captures": len(caps),
            "capture_s": caps, "wall_s": wall, "tokens": len(prompts) * SERVE_NEW,
            "tokens_per_s": len(prompts) * SERVE_NEW / wall,
            "prefill_calls": len(pre.ms), "prefill_ms": pre.ms,
            "decode_steps": len(dec.ms), "decode_ms_per_step_mean": float(np.mean(dec.ms)),
            "decode_ms_per_step_median": float(np.median(dec.ms)),
            "decode_tokens_per_s": slots * len(dec.ms) / (sum(dec.ms) / 1e3),
            "launches_per_prefill": per_call[0], "launches_per_decode_step": per_call[1],
            "distinct_tokens_per_request": [len(set(t)) for t in toks]}


def phase_serve(dev, arch: str) -> dict:
    """(b) ``arch`` at full width and depth (bf16, random weights from a
    seed): 8 requests through ``ServeEngine.generate`` (two waves of 4) and
    ``generate_continuous``, every prefill and decode step launching exactly
    its layers' kernels; for recurrentgemma-9b also one batch-1 request of
    4,096 tokens.  Decode replays a CUDA graph per batch (the engine's
    default on the card); the same requests op by op (``graph=False``) must
    give the same greedy tokens.  (a), the eager runs, the prefill + decode
    consistency and the profiled decode windows (eager and replayed, their
    logits compared) run outside the launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve import engine as serve_engine

    opts = SERVE_PATHS[arch]
    out: dict = {"arch": arch}
    with uncounted():
        out["card_vs_cpu_reduced"] = _card_vs_cpu(dev, arch, opts["kv"])
    cfg = ARCHS[arch]
    per_call = _launches_per_call(cfg)
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

    schedulers = ("generate", "generate_continuous")
    runs = {name: _serve_timed(eng, name, prompts, cfg, per_call) for name in schedulers}
    out["peak_memory_replayed"] = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with uncounted():  # the same requests op by op: the replayed tokens' check
        eager = ServeEngine(cfg, params, ServeConfig(batch_slots=SERVE_SLOTS), device=dev,
                            graph=False)
        eager_runs = {name: _serve_timed(eager, name, prompts, cfg, per_call)
                      for name in schedulers}
    out["peak_memory_eager"] = torch.cuda.max_memory_allocated(dev)
    for name in schedulers:
        check(eager_runs[name]["tokens_out"] == runs[name]["tokens_out"],
              f"{name}: replayed greedy tokens differ from eager")
    out["replayed_tokens_equal_eager"] = True
    same = [runs["generate_continuous"]["tokens_out"][i] == runs["generate"]["tokens_out"][i]
            for i in range(SERVE_SLOTS)]
    if opts["first_wave"]:
        check(all(same), "the first wave's tokens differ between the schedulers")
    else:
        # the reference's quirk: generate_continuous's initial fill leaves
        # every slot with the last prefilled request's state, so only that
        # request decodes as in a wave (phi4's requests each repeat one token
        # and agree all the same).  Under float32 compute, where bf16
        # rounding of a batch-4 against a batch-1 prefill cannot flip a
        # token, that request must agree between the schedulers.
        with uncounted(), compute_dtype(torch.float32):
            first = prompts[:SERVE_SLOTS]
            f32 = [eng.generate(first, max_new_tokens=8)[-1],
                   eng.generate_continuous(first, max_new_tokens=8)[-1]]
        check(f32[0] == f32[1], f"float32: the first wave's last request differs: {f32}")
        out["first_wave_last_equal_float32"] = True
    out["first_wave_equal"] = same
    if opts["consistency_len"] == LONG_PROMPT + 1:
        long_prompt = rng.integers(0, cfg.vocab_size, LONG_PROMPT).tolist()
        one = ServeEngine(cfg, params, ServeConfig(batch_slots=1), device=dev)
        runs["long_prompt_batch1"] = _serve_timed(one, "generate", [long_prompt], cfg, per_call)
    for run in (*runs.values(), *eager_runs.values()):
        run.pop("tokens_out")
    out["runs"] = runs
    out["eager_runs"] = eager_runs

    with uncounted():
        n = opts["consistency_len"]
        prompt = (prompts[0] + [int(rng.integers(0, cfg.vocab_size))] if n is None
                  else rng.integers(0, cfg.vocab_size, n).tolist())
        out["prefill_decode_consistency"] = _prefill_decode_consistency(params, cfg, prompt, dev)
        # launches and busy share of decode steps, eager and replayed, and
        # their logits: a 4-slot wave at plen 1,024, teacher-forced, each
        # mode on its own copy of the caches (the profile's steps 3-10; the
        # capture is the second step)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, 1024 + 16))
                                .astype(np.int32)).to(dev)
        modes = {}
        with torch.inference_mode():
            _, cache0 = lm.prefill(params, {"tokens": toks[:, :1024]}, cfg, max_len=1024 + 16)
            for graph in (False, True):
                cache = _clone(cache0)
                decode = serve_engine._Decode(ServeEngine(cfg, params, device=dev, graph=graph),
                                              cache, SERVE_SLOTS, 1024)
                seen = []

                def steps(n, decode=decode, seen=seen):
                    for _ in range(n):
                        seen.append(decode(toks[:, 1024 + len(seen)]).clone())

                modes[graph] = (_per_step(_device_profile(steps, 8), 8), torch.stack(seen))
                del cache, decode
            del cache0
        (eager_prof, want), (prof, got) = modes[False], modes[True]
        err, over = _bf16_close(got, want, cfg.vocab_size)
        check(over <= 0, f"replayed vs eager decode logits: {err} exceeds two bf16 steps")
        out["decode_profile"] = {
            "replayed": prof, "eager": eager_prof, "logits_bit_equal": bool(torch.equal(got, want)),
            "max_abs_logit_diff": err, "bound": "rtol 2^-6 + atol 2^-6 rms",
            "profiler_sees_graph_kernels":
                prof["kernels_per_step"] >= 0.9 * eager_prof["kernels_per_step"]}
        del got, want
    out["peak_memory"] = torch.cuda.max_memory_allocated(dev)
    del params, eng
    torch.cuda.empty_cache()
    return out


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]


def _clone(tree):
    """A copy of a nested cache (lists and dicts of tensors)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


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
    t_start = time.perf_counter()
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
    sources = ("spike_accum", "attention", "scan")
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
    kern.update(phase_scans(dev, rate))
    emit({"phase": "kernels_check", **kern})

    # each main path runs with the counts set to 0 just before it and read
    # just after, and must have launched each of its kernels
    launches = dict.fromkeys(LAUNCHES, 0)

    results = {}

    def path(kernels, *phases):
        reset_launches()
        for phase, fn in phases:
            results[phase] = fn()
            emit({"phase": phase, **results[phase]})
        got = dict(LAUNCHES)
        for kname in kernels:
            check(got[kname] > 0, f"{phases[0][0]}: main path never launched {kname}")
        for kname, n in got.items():
            launches[kname] += n
        return got

    path(("spike_accum_blocks", "spike_accum"),
         ("launcher", lambda: phase_launcher("cuda")),
         ("real_size", lambda: phase_real_size("cuda")))
    path(("flash_attention", "decode_attention"), ("serve", lambda: phase_serve(dev, SERVE_ARCH)))
    path(("ssd_scan",), ("serve_mamba2", lambda: phase_serve(dev, "mamba2-1.3b")))
    with shapes_of_rglru() as shapes:
        got = path(("rglru_scan", "flash_attention", "decode_attention"),
                   ("serve_recurrentgemma", lambda: phase_serve(dev, "recurrentgemma-9b")))
    by_batch: dict[int, int] = {}
    for (b, _, _), n in shapes.items():
        by_batch[b] = by_batch.get(b, 0) + n
    check(sum(shapes.values()) == got["rglru_scan"],
          f"rglru_scan shapes {shapes} do not add up to the path's launches")
    emit({"phase": "rglru_scan_shapes", "path": "serve_recurrentgemma",
          "launches_by_shape": {"x".join(map(str, k)): n for k, n in sorted(shapes.items())},
          "launches_by_batch": by_batch})
    emit({"phase": "serve_launcher", **phase_serve_launcher()})

    csrc = "src/repro_torch/kernels/csrc/"
    rows = []
    for kname, source, replaces, case in (
        ("spike_accum_blocks", "spike_accum.cu", "spike_accum.py:133", "rate_1pct"),
        ("spike_accum", "spike_accum.cu", "spike_accum.py:62", "rate_1pct"),
        ("spike_accum", "spike_accum.cu", "spike_accum.py:62", "oracle_2pct"),
        ("flash_attention", "attention.cu", "flash_attention.py:116", "phi4_prefill/bfloat16"),
        ("flash_attention", "attention.cu", "flash_attention.py:116", "rg_prefill/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94", "phi4_decode/bfloat16"),
        ("decode_attention", "attention.cu", "decode_attention.py:94",
         "rg_ring_misaligned/bfloat16"),
        ("ssd_scan", "scan.cu", "ssd_scan.py:81", "mamba2_prefill"),
        ("rglru_scan", "scan.cu", "rglru_scan.py:53", "rg_prefill"),
        ("rglru_scan", "scan.cu", "rglru_scan.py:53", "rg_continuous"),
    ):
        table = kern[kname]
        c = table["cases"][case] if "cases" in table else table[case]
        if case == "oracle_2pct":  # the device time it took on the main path
            c = {**c, "main_path_device_ms":
                 results["real_size"]["oracle"]["spike_accum_device_ms_per_step"]}
        rows.append({"name": kname, "route": "cuda", "source": csrc + source,
                     "replaces": "src/repro/kernels/" + replaces, "launches": launches[kname],
                     "max_abs_err": table["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                     "device_ms": c["device_ms"], "case": case,
                     **{key: c[key] for key in ("bound_ms_bytes", "main_path_device_ms")
                        if key in c}})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
