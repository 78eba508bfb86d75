"""Finding a cell, its configuration, its traffic driver and its metrics by
name.

``BENCHMARK.json`` lists the cells and the metrics; each cell's own files
hold the rest.  Nothing here names a cell, a configuration or a metric: a
cell made of added files is found as the others are.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    moves: str | None = None  # a per-layer metric's end-to-end metric


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything its files hold."""

    name: str
    chips: int
    config: dict
    traffic: str
    kind: str
    params: dict
    end_to_end: tuple[Metric, ...]
    per_layer: tuple[Metric, ...]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(bench_file: Path | None = None) -> dict:
    return _load_json(bench_file or ROOT / "BENCHMARK.json")


def _applies(entry: dict, cell: str) -> bool:
    """A metric without ``workloads`` applies to every cell (an end-to-end
    one) or to every cell that reports what it moves (a per-layer one)."""
    return "workloads" not in entry or cell in entry["workloads"]


def _metric(entry: dict) -> Metric:
    return Metric(name=entry["name"], unit=entry["unit"], moves=entry.get("moves"))


def find_cell(name: str, *, bench_file: Path | None = None,
              bench_dir: Path | None = None) -> Cell:
    """The cell ``name`` of ``bench_file`` (the root's ``BENCHMARK.json``),
    with its files read from ``bench_dir`` (this folder)."""
    spec = benchmark(bench_file)
    bench_dir = bench_dir or HERE
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if len(entries) != 1:
        known = ", ".join(w["name"] for w in spec["workloads"])
        raise KeyError(f"no cell {name!r} in the benchmark (cells: {known})")
    entry = entries[0]
    wl = _load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json says {key} {wl[key]!r}, "
                             f"the benchmark {entry[key]!r}")
    config = _load_json(bench_dir / "configs" / f"{entry['config']}.json")
    e2e = tuple(_metric(m) for m in spec["end_to_end"] if _applies(m, name))
    reported = {m.name for m in e2e}
    per_layer = tuple(_metric(m) for m in spec["per_layer"]
                      if _applies(m, name) and m["moves"] in reported)
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=entry["traffic"],
                kind=wl["kind"], params=wl["params"], end_to_end=e2e, per_layer=per_layer)


def _load_file(path: Path, tag: str) -> ModuleType:
    """A module from ``path``; names may hold dots, so by file, not import."""
    if not path.is_file():
        raise FileNotFoundError(f"no {tag} at {path}")
    name = f"cellbench_{tag}_{path.stem}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def traffic_driver(cell: Cell) -> ModuleType:
    """``traffic/<kind>.py``: ``setup(ctx)``, ``window(state, seconds)``,
    ``traced(state)``, ``check(state)`` and ``readings(ctx, control)``."""
    if not (HERE / "traffic" / f"{cell.kind}.py").is_file():
        raise FileNotFoundError(f"no traffic driver {cell.kind!r} in {HERE / 'traffic'}")
    return importlib.import_module(f"cellbench.traffic.{cell.kind}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: ``read(trace) -> float | None``."""
    return _load_file(HERE / "metrics" / f"{name}.py", "metric")
