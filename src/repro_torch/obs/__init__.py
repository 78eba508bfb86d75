"""repro_torch.obs — tracing and metrics for the port (copy of ``repro.obs``).

* :mod:`~repro_torch.obs.trace` — the zero-dependency tracer (nestable
  spans, instants, labeled counters; process-global, off by default, one
  branch when disabled) plus the always-on metrics registry;
* :mod:`~repro_torch.obs.export` — Chrome-trace-event JSON (Perfetto-
  loadable, deterministic bytes) and schema validation.

The reference's ``timeline`` module (netsim critical-path attribution)
is not ported yet.  ``--trace PATH`` on
``python -m repro_torch.launch.run_brainsim`` produces a trace.
"""
from repro_torch.obs.export import (
    chrome_trace,
    dumps_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
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
]
