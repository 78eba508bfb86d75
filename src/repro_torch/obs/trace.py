"""The port's tracer: spans, instants, counters, and a metrics registry,
on the profiler's timeline.

One process-global collector (:data:`TRACER`), **off by default**.  It
collects while ``enable()`` holds it on, or while a ``torch.profiler``
session records (``torch.autograd.profiler._is_profiler_enabled``, which
the profiler sets on start and clears on stop), so a profiled run records
the port's spans without asking.  The off path is two attribute reads:
``span()`` returns a shared no-op context manager and ``instant()`` /
``counter()`` / ``complete()`` return at once, so spans left on the hot
paths (the SNN run, every decode step of the serving engine) cost a branch
when nobody traces.

While the profiler records, a span also opens and closes a profiler user
annotation of its name (``torch.profiler.record_function``): the span is
then a host event of the profiler's trace, over the ops, runtime calls and
idle gaps of the device it encloses.  ``instant``, ``counter`` and
``complete`` events go to the tracer's list only: the profiler holds
nested intervals, and an interval given by its times need not nest.  Each
span records its own id (``sid``) and the id of the span open around it
on the same thread when it began (``parent``).

Events use the Chrome trace-event vocabulary directly (``ph`` = ``X``
complete span / ``i`` instant / ``C`` counter) with *string* pid/tid
labels ("dev3", "link7:leaf_up", "planner"); the exporter in
:mod:`repro_torch.obs.export` maps labels to the integer ids the format
requires and emits the matching ``process_name`` / ``thread_name``
metadata, so traces load in Perfetto / ``chrome://tracing`` with
human-readable lanes.

Timestamps are microseconds on one clock: ``time.perf_counter`` relative
to the tracer's origin, which anchors on the first ``enable()``, or on the
first event a profiler session turns the tracer on for, and restarts at
``clear()``.  Beside the origin the tracer keeps ``origin_ns``, the
profiler's timestamp of the same moment (``time.time_ns()``, the clock of
the profiler's host events), and the exporter writes it into the trace's
metadata: an event's ``ts`` plus ``origin_ns / 1000`` is the profiler's
timestamp, in microseconds, of the same moment.  Simulated-time producers
(:mod:`repro_torch.obs.timeline`) anchor sim second 0 at the moment the
simulation ran.  Tests inject a deterministic clock via
``enable(clock=...)`` (no ``origin_ns`` then).

The spans of the port's main paths, and what reads them
(``cellbench/metrics/``):

* ``snn.run`` (``DistributedSNN.run``) over ``snn.init`` (the step's
  state, previous spikes and raster), then ``graph.warmup``,
  ``graph.capture`` and ``graph.steps`` (:mod:`repro_torch.graphs`: the
  eager first step, the capture, and the steps after them):
  ``sim_start_ms.sim``;
* ``serve.call`` (one ``generate_continuous`` or wave of ``generate``)
  over ``serve.prefill`` (a prefill, its sample and the first token's
  readback), ``serve.decode`` (a decode step to its tokens' readback) and
  ``serve.schedule`` (the slot bookkeeping and refills after a decode
  step): ``prefill_share.serve``, ``host_share.serve``,
  ``prefill_useful.serve``.

Separately from the event stream, a tiny always-on metrics registry
(:data:`METRICS`) accumulates named counters and gauges (the
supervisor's retries and failures); ``metrics_snapshot()`` returns them.
"""
from __future__ import annotations

import itertools
import threading
import time

from torch.autograd import profiler as _profiler

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
    """A live span: records one ``X`` (complete) event on exit, and is a
    profiler user annotation while the profiler records."""

    __slots__ = ("_tracer", "name", "cat", "pid", "tid", "args", "_ts", "sid", "parent",
                 "_annotation")

    def __init__(self, tracer, name, cat, pid, tid, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.pid = pid
        self.tid = tid
        self.args = dict(args) if args else {}
        self._ts = 0.0
        self.sid = next(tracer._sids)
        self.parent = None
        self._annotation = None

    def set(self, **args) -> None:
        """Attach result arguments discovered while the span is open."""
        self.args.update(args)

    def __enter__(self):
        tr = self._tracer
        stack = tr._open()
        self.parent = stack[-1].sid if stack else None
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self._annotation = _profiler.record_function(self.name)
            self._annotation.__enter__()
        self._ts = tr.now_us()  # inside the annotation's interval
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        end = tr.now_us()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        tr._open().pop()
        ev = {
            "ph": "X",
            "name": self.name,
            "cat": self.cat,
            "ts": self._ts,
            "dur": max(end - self._ts, 0.0),
            "pid": self.pid,
            "tid": self.tid,
            "sid": self.sid,
        }
        if self.parent is not None:
            ev["parent"] = self.parent
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
        self.origin_ns: int | None = None
        self._anchored = False
        self._sids = itertools.count()
        self._local = threading.local()

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
            self._set_origin()
            self._anchored = True
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def on(self) -> bool:
        """Whether events are collected now: held on by ``enable()``, or a
        profiler session records (the origin anchors then if it has not)."""
        if self.enabled:
            return True
        if not _profiler._is_profiler_enabled:
            return False
        if not self._anchored:
            self._set_origin()
            self._anchored = True
        return True

    def clear(self) -> None:
        """Drop collected events and restart the time origin."""
        self._events = []
        self._set_origin()

    def _set_origin(self) -> None:
        self._t0 = self._clock()
        self.origin_ns = time.time_ns() if self._clock is time.perf_counter else None

    def _open(self) -> list[_Span]:
        """The spans open on the calling thread, innermost last."""
        try:
            return self._local.open
        except AttributeError:
            self._local.open = []
            return self._local.open

    def events(self) -> list[dict]:
        """The collected events (live list — copy before mutating)."""
        return self._events

    def now_us(self) -> float:
        """Microseconds since the origin on the shared clock."""
        return (self._clock() - self._t0) * 1e6

    # -- emission -----------------------------------------------------
    def span(self, name: str, *, cat: str = "span", pid: str = "main",
             tid: str = "main", args: dict | None = None):
        if not self.on():
            return _NOOP
        return _Span(self, name, cat, pid, tid, args)

    def instant(self, name: str, *, cat: str = "event", pid: str = "main",
                tid: str = "main", args: dict | None = None,
                ts_us: float | None = None) -> None:
        if not self.on():
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
        if not self.on():
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
        if not self.on():
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
    """Whether events are collected now (``enable()`` or a profiler)."""
    return TRACER.on()


def clear() -> None:
    TRACER.clear()


def events() -> list[dict]:
    return TRACER.events()


def now_us() -> float:
    return TRACER.now_us()


def span(name: str, **kw):
    if not (TRACER.enabled or _profiler._is_profiler_enabled):  # the off path
        return _NOOP
    return TRACER.span(name, **kw)


def instant(name: str, **kw) -> None:
    if not (TRACER.enabled or _profiler._is_profiler_enabled):
        return
    TRACER.instant(name, **kw)


def counter(name: str, values, **kw) -> None:
    if not (TRACER.enabled or _profiler._is_profiler_enabled):
        return
    TRACER.counter(name, values, **kw)


def complete(name: str, ts_us: float, dur_us: float, **kw) -> None:
    if not (TRACER.enabled or _profiler._is_profiler_enabled):
        return
    TRACER.complete(name, ts_us, dur_us, **kw)


class Metrics:
    """Named monotone counters + last-value gauges.

    Always on — an increment is one dict add, so call sites (supervisor
    retries) need no gating.  ``snapshot()`` returns a plain sorted dict.
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
