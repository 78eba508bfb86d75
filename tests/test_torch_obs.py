"""The port's tracer (``repro_torch.obs``) and its spans on the main paths.

The tracer is off until ``obs.enable()`` or a ``torch.profiler`` session:
off, a span is the shared no-op and a serving call records nothing; under
the profiler each span is also a host event of the profiler's trace, at
the same moment once the tracer's origin (``origin_ns``) is added.  A
continuous call records one ``serve.call``, a ``serve.prefill`` per
request and a ``serve.decode`` per decode step, as the engine's schedule
runs them, and a wave a ``serve.prefill`` of its batch; a simulation
records ``snn.run`` over ``snn.init`` and ``graph.steps``.  This file
imports no JAX: its card test runs where JAX is not installed.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import ARCHS
from repro_torch.models import lm
from repro_torch.obs import trace
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import engine as serve_engine
from repro_torch.snn import DistributedSNN, LIFParams, LoopbackComm
from repro_torch.snn.sparse import BlockSynapses

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8], [9], [10, 11, 12, 13, 14, 15, 16, 17, 18]]
NEW = 4


@pytest.fixture
def tracer():
    """The global tracer, off and empty before and after the test."""
    obs.disable()
    obs.clear()
    yield obs
    obs.disable()
    obs.clear()


@pytest.fixture(scope="module")
def engine_parts():
    cfg = ARCHS["deepseek-7b"].reduced()
    return cfg, lm.init_params(cfg, 0, device="cpu")


def _named(name: str) -> list[dict]:
    return [e for e in obs.events() if e["name"] == name]


def _by_sid() -> dict[int, dict]:
    return {e["sid"]: e for e in obs.events() if "sid" in e}


def _counted(monkeypatch) -> dict[str, int]:
    """Counts of the engine's prefill and decode calls, as it makes them."""
    calls = {"prefill": 0, "decode": 0}
    real_prefill, real_decode = ServeEngine._prefill, serve_engine._Decode.__call__

    def prefill(self, toks, max_len):
        calls["prefill"] += 1
        return real_prefill(self, toks, max_len)

    def decode(self, tokens):
        calls["decode"] += 1
        return real_decode(self, tokens)

    monkeypatch.setattr(ServeEngine, "_prefill", prefill)
    monkeypatch.setattr(serve_engine._Decode, "__call__", decode)
    return calls


def test_off_the_tracer_records_nothing(tracer, engine_parts):
    cfg, params = engine_parts
    assert not obs.is_enabled()
    assert obs.span("serve.call") is trace._NOOP
    obs.instant("x")
    obs.counter("x", 1.0)
    obs.complete("x", 0.0, 1.0)
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2), device="cpu")
    out = eng.generate_continuous(PROMPTS, max_new_tokens=NEW)
    assert all(len(o) == NEW for o in out)
    assert obs.events() == []


def test_spans_are_host_events_of_the_profiler(tracer):
    """Under the profiler alone (no ``enable()``) each span is a user
    annotation of the profiler's trace, and its ``ts`` plus the tracer's
    origin is the profiler's timestamp of the same moment.  The first
    annotation of a process pays the profiler's one-time set-up (about
    1.5 ms on this CPU) after its start is taken: one span goes first."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.is_enabled()
        with obs.span("first"):
            pass
        with obs.span("outer", args={"k": 1}):
            with obs.span("inner"):
                torch.ones(8).sum()
            with obs.span("second"):
                torch.ones(8).sum()
        obs.complete("lifetime", 0.0, 1.0)  # the tracer's list only
    assert obs.span("after") is trace._NOOP  # the profiler stopped
    host = {e.name(): e for e in prof.profiler.kineto_results.events()
            if e.name() in ("outer", "inner", "second", "lifetime")}
    assert set(host) == {"outer", "inner", "second"}
    origin_us = trace.TRACER.origin_ns / 1e3
    mine = {e["name"]: e for e in obs.events()}
    for name, e in host.items():
        assert abs(mine[name]["ts"] + origin_us - e.start_ns() / 1e3) < 50, name
    assert mine["inner"]["parent"] == mine["second"]["parent"] == mine["outer"]["sid"]
    assert "parent" not in mine["outer"] and mine["outer"]["args"] == {"k": 1}
    assert "lifetime" in mine
    payload = obs.chrome_trace()
    assert payload["otherData"] == {"origin_ns": trace.TRACER.origin_ns}
    assert not obs.validate_chrome_trace(payload)
    assert "otherData" not in obs.chrome_trace(list(obs.events()))


def test_an_injected_clock_has_no_profiler_origin(tracer):
    ticks = iter(range(100))
    obs.enable(clock=lambda: float(next(ticks)))
    try:
        with obs.span("a"):
            pass
        assert obs.events()[0]["ts"] == 1e6 and obs.events()[0]["dur"] == 1e6
        assert trace.TRACER.origin_ns is None and "otherData" not in obs.chrome_trace()
    finally:
        obs.enable(clock=time.perf_counter)


def test_a_continuous_call_records_its_schedule(tracer, engine_parts, monkeypatch):
    cfg, params = engine_parts
    calls = _counted(monkeypatch)
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2), device="cpu")
    obs.enable()
    out = eng.generate_continuous(PROMPTS, max_new_tokens=NEW)
    obs.disable()
    assert all(len(o) == NEW for o in out)
    sid = _by_sid()
    (call,) = _named("serve.call")
    plen = 16  # the prompts' longest, 9, to a power of two
    assert call["args"] == {"requests": 5, "slots": 2, "plen": plen, "max_new_tokens": NEW}
    prefills = _named("serve.prefill")
    assert len(prefills) == calls["prefill"] == len(PROMPTS)
    assert [p["args"]["req"] for p in sorted(prefills, key=lambda e: e["ts"])] == [0, 1, 2, 3, 4]
    for p in prefills:
        a = p["args"]
        assert a["prompt_tokens"] == len(PROMPTS[a["req"]]) and a["padded_tokens"] == plen
        assert a["refill"] == (a["req"] >= 2)
        # the first fill inside the call, each refill inside the slot loop after a decode step
        assert sid[p["parent"]]["name"] == ("serve.schedule" if a["refill"] else "serve.call")
    decodes = sorted(_named("serve.decode"), key=lambda e: e["ts"])
    assert len(decodes) == calls["decode"] == len(_named("serve.schedule")) > 0
    assert [d["args"]["step"] for d in decodes] == list(range(len(decodes)))
    assert decodes[0]["args"]["live"] == 2 and decodes[-1]["args"]["live"] >= 1
    assert all(sid[e["parent"]] is call for e in decodes + _named("serve.schedule"))
    inside = call["ts"], call["ts"] + call["dur"]
    assert all(inside[0] <= e["ts"] and e["ts"] + e["dur"] <= inside[1] + 1e-3
               for e in obs.events() if e is not call)


def test_a_wave_call_records_its_schedule(tracer, engine_parts, monkeypatch):
    cfg, params = engine_parts
    calls = _counted(monkeypatch)
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=2), device="cpu")
    obs.enable()
    out = eng.generate(PROMPTS, max_new_tokens=NEW)
    obs.disable()
    assert all(len(o) == NEW for o in out)
    waves = sorted(_named("serve.call"), key=lambda e: e["ts"])
    assert [w["args"]["requests"] for w in waves] == [2, 2, 1]
    prefills = sorted(_named("serve.prefill"), key=lambda e: e["ts"])
    assert len(prefills) == calls["prefill"] == 3
    assert [p["args"] for p in prefills] == [
        {"requests": 2, "prompt_tokens": 5, "padded_tokens": 16},
        {"requests": 2, "prompt_tokens": 4, "padded_tokens": 16},
        {"requests": 1, "prompt_tokens": 9, "padded_tokens": 16}]
    sid = _by_sid()
    assert all(sid[p["parent"]] is w for p, w in zip(prefills, waves))
    assert len(_named("serve.decode")) == calls["decode"] == 3 * NEW


@pytest.mark.parametrize("exchange", ["sparse", "flat"])
def test_a_simulation_records_its_start_and_its_steps(tracer, exchange):
    rng = np.random.default_rng(0)
    w = (rng.random((32, 32)) < 0.2).astype(np.float32) * 2.0
    kw = ({"syn": BlockSynapses.from_dense(w, 4)} if exchange == "sparse" else {"w_syn": w})
    eng = DistributedSNN(mesh=(2, 2), params=LIFParams(), exchange=exchange, i_ext=4.0,
                         device="cpu", **kw)
    obs.enable()
    raster = eng.run(12, comm=LoopbackComm((2, 2), torch.device("cpu")))
    obs.disable()
    assert raster.shape == (12, 32)
    (run,) = _named("snn.run")
    (init,) = _named("snn.init")
    (steps,) = _named("graph.steps")
    assert run["args"] == {"exchange": exchange, "steps": 12, "ranks": 4}
    assert init["parent"] == steps["parent"] == run["sid"]
    assert run["ts"] <= init["ts"] < steps["ts"] <= run["ts"] + run["dur"]
    assert steps["args"] == {"graph": "snn.step", "steps": 12}  # eagerly every step
    assert not any(k.startswith("snn.") for part in obs.metrics_snapshot().values()
                   for k in part)


@pytest.mark.cuda
def test_a_replayed_simulation_records_its_warm_up_and_capture(tracer):
    """On the card: ``snn.run`` over ``snn.init``, ``graph.warmup``,
    ``graph.capture`` and ``graph.steps`` of the steps after them, in that
    order, and each is a host event of the profiler's trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph is captured on the card)")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    w = (rng.random((64, 64)) < 0.2).astype(np.float32) * 2.0
    eng = DistributedSNN(mesh=(2, 2), params=LIFParams(), exchange="sparse", i_ext=4.0,
                         syn=BlockSynapses.from_dense(w, 4), device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run(20, comm=LoopbackComm((2, 2), dev))
        torch.cuda.synchronize(dev)
    (run,) = _named("snn.run")
    kids = sorted((e for e in obs.events() if e.get("parent") == run["sid"]),
                  key=lambda e: e["ts"])
    assert [e["name"] for e in kids] == ["snn.init", "graph.warmup", "graph.capture",
                                         "graph.steps"]
    assert kids[1]["args"] == kids[2]["args"] == {"graph": "snn.step"}
    assert kids[3]["args"] == {"graph": "snn.step", "steps": 19}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"snn.run", "snn.init", "graph.warmup", "graph.capture", "graph.steps"} <= names
