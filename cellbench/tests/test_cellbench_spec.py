"""The harness finds a cell, its configuration, its traffic driver and its
metrics by name, a new cell made only of added files among them; and
``BENCHMARK.json`` keeps to the benchmark's contract."""
from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import ROOT

from cellbench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.find_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    driver = spec.traffic_driver(c)
    for fn in ("setup", "window", "traced", "check", "readings"):
        assert callable(getattr(driver, fn))
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m.name).read)
        assert m.moves in names


def test_a_cell_of_added_files_is_found(tmp_path):
    """A cell added by files alone: a workload file and a line in the list."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "brain131k.sparse-short", "config": "brain131k",
                               "traffic": "sim-short", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "sim_step_ms":
            m["workloads"].append("brain131k.sparse-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(ROOT / "cellbench" / "configs", tmp_path / "configs")
    shutil.copytree(ROOT / "cellbench" / "workloads", tmp_path / "workloads")
    wl = json.loads((tmp_path / "workloads" / "brain131k.sparse.json").read_text())
    wl.update(traffic="sim-short")
    wl["params"]["steps"] = 500
    (tmp_path / "workloads" / "brain131k.sparse-short.json").write_text(json.dumps(wl))
    c = spec.find_cell("brain131k.sparse-short", bench_file=tmp_path / "BENCHMARK.json",
                       bench_dir=tmp_path)
    assert c.params["steps"] == 500 and c.kind == "snn_sim"
    assert {m.name for m in c.end_to_end} == {"sim_step_ms", "setup_s"}
    # the per-layer metrics that list their cells leave the new one out until listed
    assert not c.per_layer
    with pytest.raises(KeyError):
        spec.find_cell("no-such-cell", bench_file=tmp_path / "BENCHMARK.json",
                       bench_dir=tmp_path)


def test_a_workload_file_must_agree_with_the_list(tmp_path):
    shutil.copytree(ROOT / "cellbench" / "configs", tmp_path / "configs")
    shutil.copytree(ROOT / "cellbench" / "workloads", tmp_path / "workloads")
    path = tmp_path / "workloads" / "brain131k.sparse.json"
    wl = json.loads(path.read_text())
    path.write_text(json.dumps({**wl, "traffic": "other"}))
    with pytest.raises(ValueError, match="traffic"):
        spec.find_cell("brain131k.sparse", bench_dir=tmp_path)


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cellbench"]
    assert BENCH["command"][1] == "cellbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("cellbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert all(w in cells for w in m["workloads"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    assert all("\n" not in k and len(k) <= 200 for k in layers)
