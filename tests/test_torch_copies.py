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
  reference uses ``jax.lax``), and it imports nothing.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: package ``__init__``s that leave out modules not ported yet
NOT_PORTED: dict[str, set[str]] = {}
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
    "obs/trace.py": None,
    "obs/export.py": None,
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


def _code(src: str) -> str:
    return ast.dump(_strip_docstrings(ast.parse(src)))


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
        assert _code(port) == _code(ref), f"{rel}: code drifted from src/repro/{rel}"
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
