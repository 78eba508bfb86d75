"""repro_torch.obs — tracing, metrics and critical-path attribution for
the port (grown from the reference's ``repro.obs``).

* :mod:`~repro_torch.obs.trace` — the tracer (nestable spans, instants,
  labeled counters; process-global, off by default, two attribute reads
  when off) plus the always-on metrics registry.  It follows
  ``torch.profiler``: while a profiler session records, the tracer
  collects and each span is also a profiler user annotation, so the
  port's spans (``snn.run``, ``snn.init``, ``graph.warmup``,
  ``graph.capture``, ``graph.steps``, ``serve.call``,
  ``serve.prefill``, ``serve.decode``, ``serve.schedule``) name what the
  host did in the profiler's trace;
* :mod:`~repro_torch.obs.export` — Chrome-trace-event JSON (Perfetto-
  loadable, deterministic bytes, the tracer's origin on the profiler's
  clock in its metadata) and schema validation;
* :mod:`~repro_torch.obs.timeline` — simulated transmissions as trace
  events and the *exact* critical-path decomposition of a
  :class:`~repro_torch.netsim.SimResult` into serialization /
  propagation / queueing / outage-stall per round and per link kind.

``python -m repro_torch.obs validate|summarize TRACE.json`` inspects an
exported trace; ``--trace PATH`` on
``python -m repro_torch.launch.run_brainsim`` produces one.
"""
from repro_torch.obs.export import (
    chrome_trace,
    dumps_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.timeline import (
    CATEGORIES,
    CriticalPathAttribution,
    CriticalSegment,
    attribute_critical_path,
    emit_simulation,
    export_simulation_trace,
    trace_events,
)
from repro_torch.obs.trace import (
    METRICS,
    TRACER,
    Metrics,
    Tracer,
    clear,
    complete,
    counter,
    disable,
    enable,
    events,
    instant,
    is_enabled,
    metric_gauge,
    metric_inc,
    metrics_reset,
    metrics_snapshot,
    now_us,
    span,
)

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
    "chrome_trace",
    "dumps_chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "CATEGORIES",
    "CriticalSegment",
    "CriticalPathAttribution",
    "attribute_critical_path",
    "trace_events",
    "emit_simulation",
    "export_simulation_trace",
]
