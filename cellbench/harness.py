"""One run of one cell: set up, measure or trace, check, print.

The order is fixed.  Set-up (the traffic driver's: inputs made from the
seed, the program built, every shape the traffic uses warmed up) ends at
the first measured step, which is where ``setup_s`` is read.  Then either
the measured window (``--trace 0``: the cell's end-to-end metrics) or the
traced one (``--trace 1``: its per-layer metrics, each read by its own
reader from the trace and the driver's counters).  The device's peak memory
is read next, then the driver frees the program's state and holds what the
program produced to the plain reference.  Last, the run refuses to print a
result if JAX or the JAX package was loaded, and otherwise prints each
number compared beside its limit on standard error and the result line on
standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from pathlib import Path

from cellbench import spec

#: top-level module names the process must not hold (the JAX package's name
#: is ``repro``; the port's, ``repro_torch``, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (``sys.modules``),
    each module name cut at its first dot and compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One number compared with the plain reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class RunContext:
    cell: spec.Cell
    seed: int
    device: object  # torch.device
    t0: float  # the process's start on the host clock (perf_counter)

    def log(self, msg: str) -> None:
        print(f"[{time.perf_counter() - self.t0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Time one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True, help="the cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="seed of the inputs and weights")
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: profile a window and print the per-layer metrics")
    return ap.parse_args(argv)


def _device(cell: spec.Cell, device):
    """The card the cell runs on; refuses to run without enough of them."""
    import torch

    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise SystemExit("cellbench: no CUDA device (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < cell.chips:
        raise SystemExit(f"cellbench: the cell asks for {cell.chips} cards, "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def _device_record(ctx: RunContext, peak: int) -> dict:
    import torch

    from cellbench import peaks

    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
            "count": ctx.cell.chips, "memory_peak_bytes": peak, **peaks.card()}


def run(argv=None, *, t0: float | None = None, bench_file: Path | None = None,
        bench_dir: Path | None = None, device=None, out=None, err=None) -> int:
    """One run; returns the exit code.  ``device`` (tests only) skips the
    look for a card and runs there; ``bench_file`` / ``bench_dir`` point
    at another benchmark's list and files."""
    out, err = out or sys.stdout, err or sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = spec.find_cell(args.workload, bench_file=bench_file, bench_dir=bench_dir)
    dev = _device(cell, device)
    import torch

    ctx = RunContext(cell=cell, seed=args.seed, device=dev, t0=t0)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        ctx_ready = time.perf_counter() - t0
    else:
        ctx_ready = 0.0
    driver = spec.traffic_driver(cell)
    units = {m.name: m.unit for m in (*cell.end_to_end, *cell.per_layer)}
    ctx.log(f"device ready ({ctx_ready:.3f} s)")
    state = driver.setup(ctx)
    setup_s = time.perf_counter() - t0
    ctx.log(f"set-up done: {setup_s:.3f} s")
    result: dict = {}
    if args.trace:
        from cellbench import trace as tr

        tr_data, attempted, failed = driver.traced(state)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m.name).read(tr_data)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": units[m.name]}
        extra = {"busy_s": tr_data.busy_s, "window_s": tr_data.window_s}
        result["breakdown"] = tr.breakdown(tr_data)
    else:
        e2e, attempted, failed = driver.window(state, args.seconds)
        e2e["setup_s"] = setup_s
        metrics = {m.name: {"value": float(e2e[m.name]), "unit": m.unit}
                   for m in cell.end_to_end}
        extra = {}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    ctx.log("window closed; checking against the plain reference")
    checks = driver.check(state)
    del state
    bad = forbidden_modules()
    if bad:
        print(f"cellbench: the process holds {', '.join(bad)}: no result", file=err)
        return 5
    correct = bool(checks) and all(c.ok for c in checks)
    device_rec = {**_device_record(ctx, peak), **extra}
    line = {"correct": correct, "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device_rec, **result,
            "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


def main(argv=None, t0: float | None = None) -> int:
    try:
        return run(argv, t0=t0)
    except SystemExit as e:
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            return 3
        raise
    except Exception:
        traceback.print_exc()
        return 1
