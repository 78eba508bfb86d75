"""The traced run: ``torch.profiler`` over a window of whole units of
work, reduced to device time by kernel, the device's busy seconds, and the
longest idle gaps by what the host was doing.

The reduction reads the profiler's raw events (``kineto_results``), not
its per-op tree, so that a window of a million kernels reads in seconds.
A device event is a kernel, a copy or a fill on the card; busy seconds are
the union of their intervals.  A gap between device events is named by
the innermost host event that spans its middle (an op, a runtime call, or
a span the benchmark opened around a call into the program).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "cellbench.window"


@dataclasses.dataclass
class Trace:
    """What one traced window showed, and the driver's counters of it."""

    window_s: float
    busy_s: float
    kernels: dict[str, tuple[float, int]]  # name -> (device seconds, launches)
    copies: dict[str, tuple[float, int]]  # memcpy / memset events, likewise
    gaps: dict[str, float]  # host activity -> idle seconds
    counters: dict = dataclasses.field(default_factory=dict)

    def device_s(self, *parts: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold one
        of ``parts``."""
        hit = [v for k, v in self.kernels.items() if any(p in k for p in parts)]
        return sum(s for s, _ in hit), sum(n for _, n in hit)

    @property
    def kernel_launches(self) -> int:
        return sum(n for _, n in self.kernels.values())


@contextlib.contextmanager
def traced(device: torch.device, counters: dict | None = None):
    """Profile the block on ``device`` (the host's ops and, on a card, the
    card's); yields a list that holds the :class:`Trace` once the block has
    ended and the device has finished."""
    out: list[Trace] = []
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        with record_function(WINDOW):
            yield out
            sync()
        window_s = time.perf_counter() - t0
    out.append(reduce(prof, window_s, {} if counters is None else counters))


SHORT_NS = 10_000  # gaps shorter than this are named together


def _is_device(e) -> bool:
    """A kernel, copy or fill on the card (not the card's copy of a span)."""
    annotation = getattr(e, "is_user_annotation", None)
    return (e.device_type() != torch.autograd.DeviceType.CPU
            and not (annotation is not None and annotation()))


def reduce(prof, window_s: float, counters: dict) -> Trace:
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    lo = hi = None
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        if _is_device(e):
            dev.append((e.name(), start, end))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((e.name(), start, end))
            if e.name() == WINDOW:
                lo, hi = start, end
    kernels: dict[str, list] = {}
    copies: dict[str, list] = {}
    for name, start, end in dev:
        table = copies if name.startswith(("Memcpy", "Memset")) else kernels
        row = table.setdefault(name, [0.0, 0])
        row[0] += (end - start) / 1e9
        row[1] += 1
    spans = np.array([(s, e) for _, s, e in dev], dtype=np.int64).reshape(-1, 2)
    busy_ns, gaps = _union_and_gaps(spans, lo, hi)
    return Trace(window_s=window_s, busy_s=busy_ns / 1e9,
                 kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                 copies={k: (v[0], v[1]) for k, v in copies.items()},
                 gaps=_name_gaps(gaps, host), counters=counters)


def _union_and_gaps(spans: np.ndarray, lo, hi) -> tuple[int, list[tuple[int, int]]]:
    """Length of the union of ``spans`` inside ``[lo, hi]`` and the gaps
    between them there."""
    if spans.size == 0:
        return 0, [] if lo is None else [(lo, hi)]
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    lo = spans[0, 0] if lo is None else lo
    hi = spans[:, 1].max() if hi is None else hi
    busy, gaps, cur = 0, [], lo
    run_s, run_e = None, None
    for s, e in spans:
        s, e = max(int(s), lo), min(int(e), hi)
        if e <= s:
            continue
        if run_e is None or s > run_e:
            if run_e is not None:
                busy += run_e - run_s
            if s > cur:
                gaps.append((cur, s))
            run_s, run_e = s, e
        else:
            run_e = max(run_e, e)
        cur = max(cur, run_e)
    if run_e is not None:
        busy += run_e - run_s
        if hi > run_e:
            gaps.append((run_e, hi))
    return busy, gaps


def _name_gaps(gaps, host) -> dict[str, float]:
    """Idle seconds by the innermost host event over each gap's middle;
    gaps under ``SHORT_NS`` together."""
    out: dict[str, float] = {}
    short = sum(e - s for s, e in gaps if e - s < SHORT_NS)
    if short:
        out["between device ops (gaps under 10 us)"] = short / 1e9
    gaps = [(s, e) for s, e in gaps if e - s >= SHORT_NS]
    names = [n for n, _, _ in host if n != WINDOW]
    if not names:
        if gaps:
            out["host"] = sum(e - s for s, e in gaps) / 1e9
        return out
    arr = np.array([(s, e) for n, s, e in host if n != WINDOW], dtype=np.int64)
    for s, e in gaps:
        mid = (s + e) // 2
        inside = np.nonzero((arr[:, 0] <= mid) & (arr[:, 1] >= mid))[0]
        if inside.size:
            k = inside[np.argmin(arr[inside, 1] - arr[inside, 0])]
            name = names[k]
        else:
            name = "python (no op traced)"
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def breakdown(t: Trace) -> dict:
    """The ten device operations that took most time and the ten host
    activities under the longest idle time, each with its seconds."""
    ops = sorted(((k, v[0]) for k, v in {**t.kernels, **t.copies}.items()),
                 key=lambda kv: kv[1], reverse=True)[:10]
    gaps = sorted(t.gaps.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k[:120], v] for k, v in gaps]}
