"""planlint Layer 2 — lints over the executed distributed step, the port of
the reference's ``repro.analysis.traced``.

Layer 1 checks the plan artifacts against each other; this layer checks
the plan against what the executor actually does.  The reference counts
the equations of the compiled step's jaxpr; the port has no jaxpr, so
:meth:`~repro_torch.snn.distributed.DistributedSNN.trace_step` runs eager
steps through a :class:`RecordingComm` under a :class:`HostSyncs` dispatch
mode and returns a :class:`StepTrace` — what each step called.

* :func:`lint_traced_step` — **PL201**: count the collective calls
  (``ppermute`` / ``psum`` / ``all_gather``) of a step and pin them against
  what the engine's schedule says the step emits
  (:func:`expected_collectives`); a divergence means executor and plan
  disagree — the bug class the parity tests only catch dynamically.
  **PL202**: no op on the hot path that reads the device from the host
  (``.item()``, a copy from the card to the host, ``nonzero`` of a CUDA
  tensor) — the counterpart of the reference's host callbacks.
* :func:`swap_recompile_hazard` — **PL203**: compare the ``_StepKey``
  statics across a plan swap; unequal statics mean the flip builds a new
  prepared step (and captures a new graph) instead of reusing the active
  one.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from collections.abc import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.rules import RULES, Finding

__all__ = [
    "RecordingComm",
    "HostSyncs",
    "StepTrace",
    "trace_run",
    "count_collectives",
    "expected_collectives",
    "host_syncs",
    "lint_traced_step",
    "swap_recompile_hazard",
]

COLLECTIVES = ("ppermute", "psum", "all_gather")

_aten = torch.ops.aten


class RecordingComm:
    """Any communicator, its collective calls counted per step (a step
    starts at :meth:`new_step`); every other attribute is the wrapped
    communicator's."""

    def __init__(self, comm):
        self.comm = comm
        self.calls: list[Counter] = []
        self.syncs: list[Counter] = []

    def __getattr__(self, name):
        if name == "comm":
            raise AttributeError(name)
        return getattr(self.comm, name)

    def new_step(self) -> None:
        self.calls.append(Counter())
        self.syncs.append(Counter())
        self.comm.new_step()

    def _count(self, name: str) -> None:
        if self.calls:
            self.calls[-1][name] += 1

    def all_gather(self, x, axis):
        self._count("all_gather")
        return self.comm.all_gather(x, axis)

    def ppermute(self, x, pairs, axis):
        self._count("ppermute")
        return self.comm.ppermute(x, pairs, axis)

    def psum(self, x, axis="inner"):
        self._count("psum")
        return self.comm.psum(x, axis)

    def all_to_all(self, x, axis):
        self._count("all_to_all")
        return self.comm.all_to_all(x, axis)

    def psum_scatter(self, x, axis):
        self._count("psum_scatter")
        return self.comm.psum_scatter(x, axis)


def _host_sync(func, args, kwargs) -> str | None:
    """The name of a host read of the device, or None."""
    op = func.overloadpacket
    if not args or not isinstance(args[0], torch.Tensor):
        return None
    if op is _aten._local_scalar_dense:  # every .item(), int(t), float(t)
        return "_local_scalar_dense"
    if op is _aten.nonzero and args[0].is_cuda:
        return "nonzero"
    if op is _aten._to_copy and args[0].is_cuda:
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cpu":
            return "device_to_host_copy"
    if (op is _aten.copy_ and isinstance(args[1], torch.Tensor) and args[1].is_cuda
            and args[0].device.type == "cpu"):
        return "device_to_host_copy"
    return None


class HostSyncs(TorchDispatchMode):
    """Counts, in the current step of a :class:`RecordingComm`, every op
    that makes the host wait for the device.  A CPU ``nonzero`` (a plain
    kernel version's) waits for nothing and is not counted."""

    def __init__(self, rec: RecordingComm):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.rec.syncs:
            name = _host_sync(func, args, kwargs)
            if name is not None:
                self.rec.syncs[-1][name] += 1
        return func(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class StepTrace:
    """What each traced step did: its collective calls and host reads."""

    calls: tuple[dict[str, int], ...]
    syncs: tuple[dict[str, int], ...]


def trace_run(run: Callable[[RecordingComm], object], comm) -> StepTrace:
    """``run(rec)`` with ``rec`` a :class:`RecordingComm` over ``comm``,
    under :class:`HostSyncs`; what happens before the first step is not
    counted."""
    rec = RecordingComm(comm)
    with HostSyncs(rec):
        run(rec)
    return StepTrace(calls=tuple(dict(c) for c in rec.calls),
                     syncs=tuple(dict(c) for c in rec.syncs))


def _per_step(steps) -> dict[str, int]:
    out: dict[str, int] = {}
    for step in steps:
        for name, n in step.items():
            out[name] = max(out.get(name, 0), n)
    return out


def count_collectives(trace: StepTrace) -> dict[str, int]:
    """Collective name → calls in a step (the most any traced step made):
    counts are per simulation step, as the reference's ``scan`` body
    gives them."""
    return _per_step(trace.calls)


def host_syncs(trace: StepTrace) -> dict[str, int]:
    """Host-read op → calls in a step (the most any traced step made)."""
    return _per_step(trace.syncs)


def expected_collectives(engine) -> dict[str, int]:
    """Collective-eqn counts the engine's schedule implies for one step.

    * ``'sparse'`` — one slow-axis ``ppermute`` per non-empty masked
      round; one fast-axis ``all_gather`` (the level-1 group gather)
      when R > 1; no ``psum``.
    * ``'ragged'`` — one joint-axis ``ppermute`` per live round; when
      R > 1, additionally the level-1 ``all_gather`` and one fast-axis
      ``psum`` per live round (the intra-group bridge re-broadcast).
    """
    kind, schedule = engine.step_signature()
    _g, r = engine._mesh_groups()
    live = sum(1 for entry in schedule if entry)
    if kind == "ragged":
        return {
            "ppermute": live,
            "psum": live if r > 1 else 0,
            "all_gather": 1 if r > 1 else 0,
        }
    return {
        "ppermute": live,
        "psum": 0,
        "all_gather": 1 if r > 1 else 0,
    }


def _finding(rule_id: str, message: str, ctx: str) -> Finding:
    return Finding(
        rule_id=rule_id,
        severity=RULES[rule_id].severity,
        message=message,
        context=ctx,
    )


def lint_traced_step(
    engine, *, n_steps: int = 2, name: str = ""
) -> list[Finding]:
    """Run PL201 + PL202 over the engine's traced step."""
    label = name or f"{engine.exchange}@{tuple(engine.mesh)}"
    trace = engine.trace_step(n_steps)
    counts = count_collectives(trace)
    out: list[Finding] = []
    expect = expected_collectives(engine)
    for prim in COLLECTIVES:
        got = counts.get(prim, 0)
        want = expect[prim]
        if got != want:
            out.append(
                _finding(
                    "PL201",
                    f"traced step emits {got} {prim} eqn(s), schedule "
                    f"implies {want} (executor and plan disagree)",
                    label,
                )
            )
    for op, got in sorted(host_syncs(trace).items()):
        out.append(
            _finding(
                "PL202",
                f"hot path contains {got} {op} eqn(s) — host "
                "round-trips serialize every simulation step",
                label,
            )
        )
    return out


def swap_recompile_hazard(engine, plan, *, name: str = "") -> list[Finding]:
    """PL203 — does flipping ``engine`` to ``plan`` keep the prepared
    step?  Compares the full ``_StepKey`` statics (what the
    :func:`~repro_torch.snn.distributed._sparse_step` cache keys on), not
    just the signature, across the swap."""
    label = name or "plan-swap"
    staged = engine.with_plan(plan)
    k0, k1 = engine._step_key(), staged._step_key()
    if hash(k0) == hash(k1) and k0 == k1:
        return []
    sig_changed = k0.signature != k1.signature
    detail = (
        "exchange signature changed (round widths/pairs differ)"
        if sig_changed
        else "non-signature statics changed"
    )
    return [
        _finding(
            "PL203",
            f"plan swap changes the _StepKey statics — {detail}; the "
            "flip will stall on a recompile unless warmed up off-path",
            label,
        )
    ]
