"""The import check: top-level module names compared whole, so that the
port (``repro_torch``) passes where the JAX package (``repro``) and JAX do
not; and the plain references import nothing of the program."""
from __future__ import annotations

import subprocess
import sys

import pytest
from conftest import ROOT

from cellbench.harness import forbidden_modules


@pytest.mark.parametrize("names, found", [
    ({"jax", "jax.numpy"}, ["jax"]),
    ({"jaxlib.xla_client"}, ["jaxlib"]),
    ({"flax.linen"}, ["flax"]),
    ({"repro", "repro.core.graph"}, ["repro"]),
    ({"repro_torch", "repro_torch.snn", "reprox", "jaxtyping", "torch"}, []),
])
def test_names_are_compared_whole(names, found):
    assert forbidden_modules(names) == found


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted(sys.modules)))"],
        capture_output=True, text=True, check=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    return {n.split(".", 1)[0] for n in out.stdout.split()}


def test_references_import_nothing_of_the_program():
    top = _modules_after(
        "import cellbench.reference.lif, cellbench.reference.lm, cellbench.reference.schedule")
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of both tiny cells, traced, in a fresh process."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'cellbench' / 'tests')!r})\n"
        "from conftest import run_tiny\n"
        "for cell in ('tiny-brain.sparse', 'tiny-lm.serve-chat'):\n"
        "    rc, line, _ = run_tiny(cell, 12, trace=1)\n"
        "    assert rc == 0 and line['correct'], line\n")
    top = _modules_after(code)
    assert "repro_torch" in top
    assert not top & {"repro", "jax", "jaxlib", "flax"}
