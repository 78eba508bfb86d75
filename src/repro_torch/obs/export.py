"""Chrome-trace-event JSON export + schema validation.

:func:`chrome_trace` turns the tracer's label-addressed events into the
`Trace Event Format <https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
object Perfetto and ``chrome://tracing`` load:

* string pid/tid labels are mapped to dense integer ids in sorted label
  order (deterministic: same events → byte-identical JSON);
* ``process_name`` / ``thread_name`` / sort-index ``M`` metadata events
  are emitted so lanes show the original labels;
* events are sorted ``(pid, tid, ts, insertion)`` so ``ts`` is
  monotone within every thread lane (a property
  :func:`validate_chrome_trace` checks and tests pin);
* the global tracer's own events carry its origin on the profiler's
  clock in the metadata (``otherData.origin_ns``): ``ts`` plus
  ``origin_ns / 1000`` is a ``torch.profiler`` host event's timestamp
  in microseconds.

The export is pure — the exporter never looks at the
clock, so exporting the same event list twice gives identical bytes
(the golden-determinism guarantee ``tests/test_obs.py`` gates).
"""
from __future__ import annotations

import json

from repro_torch.obs import trace as _trace

__all__ = ["chrome_trace", "dumps_chrome_trace", "write_chrome_trace",
           "validate_chrome_trace"]

_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def chrome_trace(events: list[dict] | None = None) -> dict:
    """Build the ``{"traceEvents": [...]}`` payload from ``events``
    (default: the global tracer's collected events, with its origin on
    the profiler's clock as ``otherData.origin_ns``)."""
    origin_ns = None
    if events is None:
        events = _trace.events()
        origin_ns = _trace.TRACER.origin_ns
    pids = sorted({str(e.get("pid", "main")) for e in events})
    pid_id = {p: i + 1 for i, p in enumerate(pids)}
    tid_id: dict[tuple[str, str], int] = {}
    for p in pids:
        tids = sorted({
            str(e.get("tid", "main")) for e in events
            if str(e.get("pid", "main")) == p
        })
        for j, t in enumerate(tids):
            tid_id[(p, t)] = j + 1

    meta: list[dict] = []
    for p, i in pid_id.items():
        meta.append({"ph": "M", "name": "process_name", "pid": i, "tid": 0,
                     "ts": 0, "args": {"name": p}})
        meta.append({"ph": "M", "name": "process_sort_index", "pid": i,
                     "tid": 0, "ts": 0, "args": {"sort_index": i}})
    for (p, t), j in sorted(tid_id.items()):
        meta.append({"ph": "M", "name": "thread_name", "pid": pid_id[p],
                     "tid": j, "ts": 0, "args": {"name": t}})

    def _key(item):
        i, e = item
        p = str(e.get("pid", "main"))
        return (pid_id[p], tid_id[(p, str(e.get("tid", "main")))],
                float(e.get("ts", 0.0)), i)

    body = []
    for _, e in sorted(enumerate(events), key=_key):
        p = str(e.get("pid", "main"))
        out = dict(e)
        out["pid"] = pid_id[p]
        out["tid"] = tid_id[(p, str(e.get("tid", "main")))]
        body.append(out)
    payload = {"traceEvents": meta + body, "displayTimeUnit": "ms"}
    if origin_ns is not None:
        payload["otherData"] = {"origin_ns": origin_ns}
    return payload


def dumps_chrome_trace(events: list[dict] | None = None) -> str:
    """Deterministic serialization (sorted keys, no whitespace)."""
    return json.dumps(chrome_trace(events), sort_keys=True,
                      separators=(",", ":"))


def write_chrome_trace(path: str, events: list[dict] | None = None) -> str:
    """Write the trace JSON to ``path``; returns ``path``."""
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(dumps_chrome_trace(events))
    return path


def validate_chrome_trace(payload: dict) -> list[str]:
    """Schema check; returns a list of problems (empty ⇔ valid).

    Checks the keys Perfetto requires per phase and that ``ts`` is
    monotone non-decreasing within every ``(pid, tid)`` lane.
    """
    errors: list[str] = []
    evs = payload.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    last_ts: dict[tuple, float] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph is None:
            errors.append(f"event {i}: missing ph")
            continue
        for k in _REQUIRED:
            if k not in e:
                errors.append(f"event {i} ({ph}): missing {k}")
        if ph == "X" and "dur" not in e:
            errors.append(f"event {i}: X event missing dur")
        if ph == "X" and float(e.get("dur", 0)) < 0:
            errors.append(f"event {i}: negative dur")
        if ph in ("C", "M") and "args" not in e:
            errors.append(f"event {i}: {ph} event missing args")
        if ph == "M":
            continue  # metadata carries ts=0 by convention
        lane = (e.get("pid"), e.get("tid"))
        ts = float(e.get("ts", 0.0))
        if lane in last_ts and ts < last_ts[lane]:
            errors.append(
                f"event {i}: ts {ts} < {last_ts[lane]} in lane {lane}"
            )
        last_ts[lane] = ts
    return errors
