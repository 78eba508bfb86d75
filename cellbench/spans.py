"""The program's own spans in a traced window, for the per-layer metrics
that read them (``metrics/prefill_share.serve.py`` and its neighbours).

The program's tracer (``repro_torch.obs``) collects while the profiler
records, so in a traced run its list holds the spans of the profiled
window: set-up and the untraced twin run with the profiler off and the
tracer disabled.  A program without the spans leaves the list empty, and
every reader then returns ``None``.  Each span is a Chrome ``X`` event:
``name``, ``ts`` and ``dur`` in microseconds of the host's clock,
``sid`` and ``parent`` (the ``sid`` of the span open around it), and
``args``.
"""
from __future__ import annotations


def events() -> list[dict]:
    """The events the program's tracer collected."""
    from repro_torch import obs

    return list(obs.events())


def spans(name: str, evs: list[dict] | None = None) -> list[dict]:
    """The complete events called ``name`` among ``evs`` (:func:`events`)."""
    evs = events() if evs is None else evs
    return [e for e in evs if e.get("ph") == "X" and e.get("name") == name]


def total_us(name: str, evs: list[dict] | None = None) -> float:
    """The summed duration of the complete events called ``name``."""
    return sum(float(e["dur"]) for e in spans(name, evs))
