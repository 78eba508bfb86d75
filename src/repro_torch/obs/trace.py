"""The zero-dependency tracer: spans, instants, counters, metrics.

One process-global collector (:data:`TRACER`), **off by default**.  The
disabled path is a single attribute check — ``span()`` returns a shared
no-op context manager and ``instant()``/``counter()`` return
immediately — so instrumentation left in hot paths (the planner, the
supervisor retry loop, ``netsim.simulate``) costs one branch when
nobody asked for a trace.

Events use the Chrome trace-event vocabulary directly (``ph`` = ``X``
complete span / ``i`` instant / ``C`` counter) with *string* pid/tid
labels ("dev3", "link7:leaf_up", "planner"); the exporter in
:mod:`repro_torch.obs.export` maps labels to the integer ids the format
requires and emits the matching ``process_name`` / ``thread_name``
metadata, so traces load in Perfetto / ``chrome://tracing`` with
human-readable lanes.

Timestamps are microseconds on one shared clock: wall time
(``time.perf_counter``) relative to the moment the tracer was enabled.
Simulated-time producers (:mod:`repro.obs.timeline`) anchor sim second
0 at the wall-clock moment the simulation ran — one time axis for
planner spans, supervisor events, and simulated transmissions.  Tests
inject a deterministic clock via ``enable(clock=...)``.

Separately from the event stream, a tiny always-on metrics registry
(:data:`METRICS`) accumulates named counters and gauges (compile-cache
hits, recovery retries); ``metrics_snapshot()`` merges into the
``benchmarks.run --json`` artifact.
"""
from __future__ import annotations

import time

__all__ = [
    "Tracer",
    "TRACER",
    "Metrics",
    "METRICS",
    "enable",
    "disable",
    "is_enabled",
    "clear",
    "events",
    "now_us",
    "span",
    "instant",
    "counter",
    "complete",
    "metric_inc",
    "metric_gauge",
    "metrics_snapshot",
    "metrics_reset",
]


class _NoopSpan:
    """Shared do-nothing context manager returned while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:  # mirror _Span.set
        return None


_NOOP = _NoopSpan()


class _Span:
    """A live span: records one ``X`` (complete) event on exit."""

    __slots__ = ("_tracer", "name", "cat", "pid", "tid", "args", "_ts")

    def __init__(self, tracer, name, cat, pid, tid, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.pid = pid
        self.tid = tid
        self.args = dict(args) if args else {}
        self._ts = 0.0

    def set(self, **args) -> None:
        """Attach result arguments discovered while the span is open."""
        self.args.update(args)

    def __enter__(self):
        self._ts = self._tracer.now_us()
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        ev = {
            "ph": "X",
            "name": self.name,
            "cat": self.cat,
            "ts": self._ts,
            "dur": max(tr.now_us() - self._ts, 0.0),
            "pid": self.pid,
            "tid": self.tid,
        }
        if self.args:
            ev["args"] = self.args
        tr._events.append(ev)
        return False


class Tracer:
    """Process-global event collector (see module docstring)."""

    def __init__(self) -> None:
        self.enabled = False
        self._events: list[dict] = []
        self._clock = time.perf_counter
        self._t0 = 0.0
        self._anchored = False

    # -- lifecycle ----------------------------------------------------
    def enable(self, *, clock=None) -> None:
        """Start collecting; ``clock`` (seconds, monotone) is injectable
        for deterministic tests.  The time origin anchors on the first
        enable (or after ``clear()``), so disable/enable pauses keep one
        coherent axis."""
        if clock is not None:
            self._clock = clock
            self._anchored = False
        if not self._anchored:
            self._t0 = self._clock()
            self._anchored = True
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Drop collected events and restart the time origin."""
        self._events = []
        self._t0 = self._clock()

    def events(self) -> list[dict]:
        """The collected events (live list — copy before mutating)."""
        return self._events

    def now_us(self) -> float:
        """Microseconds since ``enable()`` on the shared clock."""
        return (self._clock() - self._t0) * 1e6

    # -- emission -----------------------------------------------------
    def span(self, name: str, *, cat: str = "span", pid: str = "main",
             tid: str = "main", args: dict | None = None):
        if not self.enabled:
            return _NOOP
        return _Span(self, name, cat, pid, tid, args)

    def instant(self, name: str, *, cat: str = "event", pid: str = "main",
                tid: str = "main", args: dict | None = None,
                ts_us: float | None = None) -> None:
        if not self.enabled:
            return
        ev = {
            "ph": "i",
            "name": name,
            "cat": cat,
            "ts": self.now_us() if ts_us is None else float(ts_us),
            "pid": pid,
            "tid": tid,
            "s": "t",  # thread-scoped instant
        }
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)

    def counter(self, name: str, values: dict | float, *, cat: str = "counter",
                pid: str = "main", tid: str = "main",
                ts_us: float | None = None) -> None:
        """A labeled counter sample; ``values`` is a number or a dict of
        series-name → number (Chrome ``C`` events stack dict series)."""
        if not self.enabled:
            return
        if not isinstance(values, dict):
            values = {"value": float(values)}
        self._events.append({
            "ph": "C",
            "name": name,
            "cat": cat,
            "ts": self.now_us() if ts_us is None else float(ts_us),
            "pid": pid,
            "tid": tid,
            "args": {k: float(v) for k, v in values.items()},
        })

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "span", pid: str = "main", tid: str = "main",
                 args: dict | None = None) -> None:
        """An explicit-timestamp complete event — how simulated
        transmissions (which carry their own clock) enter the trace."""
        if not self.enabled:
            return
        ev = {
            "ph": "X",
            "name": name,
            "cat": cat,
            "ts": float(ts_us),
            "dur": max(float(dur_us), 0.0),
            "pid": pid,
            "tid": tid,
        }
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)


TRACER = Tracer()


# -- module-level conveniences (the instrumentation API) ---------------
def enable(*, clock=None) -> None:
    TRACER.enable(clock=clock)


def disable() -> None:
    TRACER.disable()


def is_enabled() -> bool:
    return TRACER.enabled


def clear() -> None:
    TRACER.clear()


def events() -> list[dict]:
    return TRACER.events()


def now_us() -> float:
    return TRACER.now_us()


def span(name: str, **kw):
    if not TRACER.enabled:  # the single-branch disabled path
        return _NOOP
    return TRACER.span(name, **kw)


def instant(name: str, **kw) -> None:
    if not TRACER.enabled:
        return
    TRACER.instant(name, **kw)


def counter(name: str, values, **kw) -> None:
    if not TRACER.enabled:
        return
    TRACER.counter(name, values, **kw)


def complete(name: str, ts_us: float, dur_us: float, **kw) -> None:
    if not TRACER.enabled:
        return
    TRACER.complete(name, ts_us, dur_us, **kw)


class Metrics:
    """Named monotone counters + last-value gauges.

    Always on — an increment is one dict add, so call sites (compile-
    cache hit/miss, supervisor retries) need no gating.  ``snapshot()``
    returns a plain sorted dict for the bench JSON artifact.
    """

    def __init__(self) -> None:
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def get(self, name: str) -> float:
        return self._counters.get(name, self._gauges.get(name, 0))

    def snapshot(self) -> dict:
        return {
            "counters": dict(sorted(self._counters.items())),
            "gauges": dict(sorted(self._gauges.items())),
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()


METRICS = Metrics()


def metric_inc(name: str, value: float = 1) -> None:
    METRICS.inc(name, value)


def metric_gauge(name: str, value: float) -> None:
    METRICS.gauge(name, value)


def metrics_snapshot() -> dict:
    return METRICS.snapshot()


def metrics_reset() -> None:
    METRICS.reset()
