"""The readers of the program's own spans (``metrics/prefill_share.serve.py``,
``host_share.serve``, ``prefill_useful.serve``, ``sim_start_ms.sim``):
hand-built event lists give hand-worked values and nothing where the spans
are absent; a traced run of each tiny cell prints them, and
``prefill_useful.serve`` is the traced call's exact share of real prompt
tokens."""
from __future__ import annotations

import io
import json

import pytest
from conftest import DATA, ROOT

from cellbench import harness, prompts, spans
from cellbench.spec import metric_reader

SERVE = ("prefill_share.serve", "host_share.serve", "prefill_useful.serve")
NEW = (*SERVE, "sim_start_ms.sim")


def _x(name, ts, dur, sid=None, parent=None, **args):
    e = {"ph": "X", "name": name, "ts": float(ts), "dur": float(dur), "pid": "main",
         "tid": "main"}
    if sid is not None:
        e["sid"] = sid
    if parent is not None:
        e["parent"] = parent
    if args:
        e["args"] = args
    return e


#: two calls: 1,000 + 500 us; prefills 200 + 100 + 50 us of 3 + 5 + 4 real
#: tokens in buckets of 16, 16 and 8; decode steps 500 + 300 us; two
#: simulations starting 2.0 and 4.0 ms before their replays
EVENTS = [
    _x("serve.call", 0, 1000, 0),
    _x("serve.prefill", 10, 200, 1, 0, req=0, prompt_tokens=3, padded_tokens=16),
    _x("serve.decode", 300, 500, 2, 0, step=0, live=1),
    _x("serve.schedule", 800, 150, 3, 0),
    _x("serve.prefill", 810, 100, 4, 3, req=1, prompt_tokens=5, padded_tokens=16),
    _x("serve.call", 2000, 500, 5),
    _x("serve.prefill", 2010, 50, 6, 5, req=0, prompt_tokens=4, padded_tokens=8),
    _x("serve.decode", 2100, 300, 7, 5, step=0, live=1),
    _x("snn.run", 100, 5000, 10),
    _x("snn.init", 110, 40, 11, 10),
    _x("graph.steps", 2100, 2000, 12, 10, graph="snn.step", steps=9),
    _x("snn.run", 10_000, 9000, 20),
    _x("graph.steps", 14_000, 4000, 21, 20, graph="snn.step", steps=9),
    _x("graph.steps", 30_000, 100, 30, graph="snn.engine.step", steps=5),  # in no snn.run
    {"ph": "i", "name": "serve.prefill", "ts": 5.0, "pid": "main", "tid": "main"},
]


def _read(name, events, monkeypatch):
    monkeypatch.setattr(spans, "events", lambda: list(events))
    return metric_reader(name).read(None)


def test_hand_built_spans_give_hand_worked_values(monkeypatch):
    got = {name: _read(name, EVENTS, monkeypatch) for name in NEW}
    assert got == {"prefill_share.serve": 100.0 * 350 / 1500,
                   "host_share.serve": 100.0 * (1500 - 350 - 800) / 1500,
                   "prefill_useful.serve": 100.0 * 12 / 40,
                   "sim_start_ms.sim": 3.0}


@pytest.mark.parametrize("events", [[], [e for e in EVENTS
                                         if e["name"].startswith(("snn.", "graph."))],
                                    [e for e in EVENTS if e["name"].startswith("serve.")]],
                         ids=["none", "simulations only", "calls only"])
def test_absent_spans_read_nothing(monkeypatch, events):
    for name in NEW:
        kind = "snn." if name.endswith(".sim") else "serve."
        if not any(e["name"].startswith(kind) for e in events):
            assert _read(name, events, monkeypatch) is None, name


def test_the_program_without_spans_reads_nothing():
    """A program whose tracer collected nothing (as one without the spans)."""
    from repro_torch import obs

    obs.disable()
    obs.clear()
    assert all(metric_reader(name).read(None) is None for name in NEW)


def _bench_with_the_readers(tmp_path):
    """The tests' benchmark with this benchmark's span readers added, listed
    for the tiny cells."""
    bench = json.loads((DATA / "benchmark.json").read_text())
    ours = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in ours["per_layer"]:
        if m["name"] in NEW:
            cell = "tiny-brain.sparse" if m["name"].endswith(".sim") else "tiny-lm.serve-chat"
            bench["per_layer"].append({**m, "workloads": [cell]})
    path = tmp_path / "benchmark.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.mark.parametrize("cell", ["tiny-brain.sparse", "tiny-lm.serve-chat"])
def test_a_traced_tiny_run_prints_the_span_metrics(tmp_path, cell):
    from repro_torch import obs

    obs.disable()
    obs.clear()
    seed = 3_000_000_021
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
                      "--trace", "1"], bench_file=_bench_with_the_readers(tmp_path),
                     bench_dir=DATA, device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    if cell == "tiny-brain.sparse":
        assert m["sim_start_ms.sim"] > 0
        assert not set(SERVE) & set(m)
        return
    assert 0 < m["prefill_share.serve"] < 100 and 0 <= m["host_share.serve"] < 100
    assert m["prefill_share.serve"] + m["host_share.serve"] < 100
    prm = json.loads((DATA / "workloads" / f"{cell}.json").read_text())["params"]
    cfg = json.loads((DATA / "configs" / "tiny-lm.json").read_text())
    p = prm["prompt"]
    lens = [len(x) for x in prompts.call(seed, 0, prm["requests"], p["median"], p["sigma"],
                                         p["lo"], p["hi"], cfg["vocab_size"])]
    plen = max(8, 1 << (max(lens) - 1).bit_length())
    assert m["prefill_useful.serve"] == 100.0 * sum(lens) / (prm["requests"] * plen)
    assert "sim_start_ms.sim" not in m
