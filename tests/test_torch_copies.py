"""Drift guard: each numpy module the port copies from the JAX package
stays equal to its reference after the import rewrite ``repro.`` →
``repro_torch.``.

A copy is compared as text (read back with ``repro_torch`` → ``repro``)
unless an allowance is listed for it:

* ``docstrings`` — the code (the module's ``ast`` with every docstring
  removed; comments never reach the ``ast``) must be equal, the prose
  may differ: the port's docstrings name the port, leave out the
  reference's PR numbers and (``netsim/topology.py``) its word for the
  topology constructors;
* ``exports`` — a package ``__init__`` that exports less: its code must
  equal the reference's with the imports of the modules not ported yet
  and their names in ``__all__`` taken out, and nothing else;
* ``numpy half`` — the listed numpy functions are copied, each equal to
  the reference's function, docstring included; beside them the module
  defines only the ported collective half (over a communicator where the
  reference uses ``jax.lax``), and it imports nothing;
* ``support`` — code-equal (as ``docstrings``) once each import from the
  port's ``analysis/_support.py`` is read back as the import from the
  ``benchmarks`` module it was copied from (the port imports no
  ``benchmarks``); the support module itself holds only those functions,
  each code-equal to its source.

* ``defs`` — every top-level function, class and assignment of the
  reference's module (docstrings removed) is in the port's, equal; the port
  imports its own modules in place of the reference's and may define the
  names listed in ``EXTRA_DEFS`` beside them (``roofline/analysis.py``: the
  H100 beside the TPU v5e, its totals from the dispatch count, not HLO), and
  may change the code of the names listed in ``CHANGED_DEFS``, which must
  still be there (``obs/trace.py``: the tracer follows ``torch.profiler``
  and keeps its origin on the profiler's clock; ``obs/export.py``: the
  export writes that origin into the trace's metadata).

A ``docstrings`` copy listed in ``RENAMED`` also renames one keyword
inside one function (``restore``'s ``shardings=`` is the port's
``device=``): its code is compared with the port's name read back.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: package ``__init__``s that leave out modules not ported yet (none since
#: the training slice ported the optimizer, compression and train step)
NOT_PORTED: dict[str, set[str]] = {}
#: ``docstrings`` copies with a keyword renamed in one function:
#: (function, {port's name: reference's name})
RENAMED: dict[str, tuple[str, dict[str, str]]] = {
    "train/fault_tolerance.py": ("resume_with", {"device": "shardings"}),
}
#: the port's copies of the benchmark helpers the scenarios import, by source module
SUPPORT = {"build_device_traffic": "benchmarks.common", "paper_fabric": "benchmarks.common",
           "_edit_batch": "benchmarks.replan_bench"}
#: ``defs`` copies: the top-level names the port's module adds
EXTRA_DEFS = {"roofline/analysis.py": {"H100"}, "obs/trace.py": set(), "obs/export.py": set()}
#: ``defs`` copies: the reference's top-level names whose code the port changes
CHANGED_DEFS = {
    "obs/trace.py": {"_Span", "Tracer", "is_enabled", "span", "instant", "counter", "complete"},
    "obs/export.py": {"chrome_trace"},
}
HIERARCHICAL_NUMPY = ("dispatch_bytes", "dispatch_messages", "dispatch_rounds",
                      "dispatch_messages_from_table")
HIERARCHICAL_COLLECTIVE = ("flat_all_to_all", "two_level_all_to_all", "two_level_all_gather",
                           "flat_psum", "hierarchical_psum", "make_exchange_fns")

COPIES = {
    # ported before the planning layer
    "core/graph.py": None,
    "core/partition.py": None,
    "core/traffic.py": None,
    "core/routing.py": "docstrings",
    "core/latency.py": "docstrings",
    "snn/sparse.py": None,
    "snn/model.py": None,
    "snn/ragged.py": "docstrings",
    "analysis/invariants.py": None,
    "obs/trace.py": "defs",
    "obs/export.py": "defs",
    "configs/base.py": "docstrings",
    # the planning layer
    "core/routing_dense.py": None,
    "core/multilevel.py": None,
    "core/outofcore.py": None,
    "core/hierarchical.py": "numpy half",
    "obs/timeline.py": None,
    "obs/__main__.py": None,
    "obs/__init__.py": "docstrings",
    "netsim/__init__.py": None,
    "netsim/topology.py": "docstrings",
    "netsim/events.py": None,
    "netsim/simulate.py": None,
    "netsim/adapters.py": None,
    "netsim/shards.py": None,
    "netsim/whatif.py": None,
    "analysis/context.py": None,
    "analysis/rules.py": None,
    "analysis/__init__.py": "docstrings",
    # replanning and recovery
    "core/replan.py": None,
    "core/placement.py": None,
    "core/__init__.py": "docstrings",
    "train/fault_tolerance.py": "docstrings",
    "train/__init__.py": None,
    "chaos/schedule.py": None,
    "chaos/inject.py": "docstrings",
    "chaos/__init__.py": "docstrings",
    "analysis/scenarios.py": "support",
    "analysis/cli.py": "docstrings",
    "analysis/__main__.py": None,
    # training
    "data/pipeline.py": None,
    "data/__init__.py": None,
    # the roofline
    "roofline/analysis.py": "defs",
}


def _sources(rel: str) -> tuple[str, str]:
    """(the port's source read back to the reference's names, the reference's)."""
    port = (PORT / rel).read_text(encoding="utf-8")
    ref = (REF / rel).read_text(encoding="utf-8")
    assert "repro_torch" not in ref
    return port.replace("repro_torch", "repro"), ref


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _renamed(tree: ast.AST, rel: str) -> ast.AST:
    func, names = RENAMED.get(rel, (None, {}))
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) and fn.name == func:
            for node in ast.walk(fn):
                if isinstance(node, (ast.arg, ast.keyword)) and node.arg in names:
                    node.arg = names[node.arg]
                elif isinstance(node, ast.Name) and node.id in names:
                    node.id = names[node.id]
    return tree


def _code(src: str, rel: str = "") -> str:
    return ast.dump(_renamed(_strip_docstrings(ast.parse(src)), rel))


def _from_support(src: str) -> str:
    """``src`` with each import from ``analysis/_support.py`` read back as
    the import from the benchmark module it was copied from."""
    def source(m: re.Match) -> str:
        mods = {SUPPORT[n.strip()] for n in m.group(2).split(",")}
        assert len(mods) == 1, m.group(0)
        return f"{m.group(1)}from {mods.pop()} import {m.group(2)}"

    return re.sub(r"^( *)from repro\.analysis\._support import (.+)$", source, src,
                  flags=re.M)


def _without_modules(src: str, modules: set[str]) -> str:
    """The reference ``__init__``'s code without the imports of
    ``modules`` and without their names in ``__all__``."""
    tree = _strip_docstrings(ast.parse(src))
    dropped = {a.asname or a.name for node in tree.body
               if isinstance(node, ast.ImportFrom) and node.module in modules
               for a in node.names}
    assert dropped, f"none of {modules} imported"
    tree.body = [node for node in tree.body
                 if not (isinstance(node, ast.ImportFrom) and node.module in modules)]
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets if isinstance(t, ast.Name)] == ["__all__"]):
            node.value.elts = [e for e in node.value.elts if e.value not in dropped]
    return ast.dump(tree)


def _code_only(src: str) -> str:
    """``src`` without its docstrings (comments never reach the ``ast``)."""
    return ast.unparse(_strip_docstrings(ast.parse(src)))


def _defs(src: str) -> dict[str, str]:
    """Top-level functions, classes and single-name assignments (but
    ``__all__``), docstrings removed, by name."""
    out = {}
    for node in _strip_docstrings(ast.parse(src)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name) and node.targets[0].id != "__all__"):
            out[node.targets[0].id] = ast.dump(node)
    return out


def _functions(src: str) -> dict[str, str]:
    return {node.name: ast.dump(node) for node in ast.parse(src).body
            if isinstance(node, ast.FunctionDef)}


def test_every_copy_exists():
    missing = [rel for rel in COPIES if not (PORT / rel).exists() or not (REF / rel).exists()]
    assert not missing


@pytest.mark.parametrize("rel", list(COPIES), ids=list(COPIES))
def test_copy_equals_reference(rel):
    port, ref = _sources(rel)
    allowance = COPIES[rel]
    if allowance is None:
        assert port == ref, f"{rel} drifted from src/repro/{rel}"
    elif allowance == "docstrings":
        assert _code(port, rel) == _code(ref), f"{rel}: code drifted from src/repro/{rel}"
    elif allowance == "support":
        assert _code(_from_support(port)) == _code(ref), (
            f"{rel}: code drifted from src/repro/{rel}")
    elif allowance == "defs":
        mine, theirs = _defs(port), _defs(ref)
        assert set(mine) - set(theirs) == EXTRA_DEFS[rel], f"{rel}: extra names"
        changed = CHANGED_DEFS.get(rel, set())
        assert changed <= set(mine), f"{rel}: {sorted(changed - set(mine))} gone"
        for name, node in theirs.items():
            if name not in changed:
                assert mine.get(name) == node, f"{rel}:{name} drifted from src/repro/{rel}"
    elif allowance == "exports":
        assert _code(port) == _without_modules(ref, NOT_PORTED[rel]), (
            f"{rel}: code drifted from src/repro/{rel}")
    else:
        assert allowance == "numpy half"
        mine, theirs = _functions(port), _functions(ref)
        both = HIERARCHICAL_NUMPY + HIERARCHICAL_COLLECTIVE
        assert sorted(mine) == sorted(both)
        assert sorted(theirs) == sorted(both)
        for name in HIERARCHICAL_NUMPY:
            assert mine[name] == theirs[name], f"{rel}:{name} drifted"
        ns: dict = {}
        exec(compile(port, rel, "exec"), ns)  # needs neither jax nor torch
        assert sorted(ns["__all__"]) == sorted(both)


def test_support_module_holds_only_the_copied_helpers():
    src = (PORT / "analysis" / "_support.py").read_text(encoding="utf-8")
    assert sorted(_functions(src)) == sorted(SUPPORT)


@pytest.mark.parametrize("name", list(SUPPORT))
def test_support_function_equals_benchmark_source(name):
    port = (PORT / "analysis" / "_support.py").read_text(encoding="utf-8")
    bench = ROOT / (SUPPORT[name].replace(".", "/") + ".py")
    mine = _functions(_code_only(port.replace("repro_torch", "repro")))[name]
    theirs = _functions(_code_only(bench.read_text(encoding="utf-8")))[name]
    assert mine == theirs, f"{name}: code drifted"
