"""How the port names its CUDA libraries (``repro_torch.kernels._build``),
on the CPU: the name hashes everything a build reads, so an edited source,
an edited shared header (``csrc/*.cuh``) or other flags give another
library, and an unchanged tree loads the one it built before."""
from __future__ import annotations

import shutil

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.attention import decode_splits

SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path):
    out = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, out)
    return out


def test_sources_and_headers_found():
    assert SOURCES == ["attention", "scan", "spike_accum"]
    assert (_build.CSRC / "hopper.cuh").exists()
    assert '#include "hopper.cuh"' in (_build.CSRC / "attention.cu").read_text()


@pytest.mark.parametrize("name", SOURCES)
def test_library_stem_hashes_source_headers_and_flags(csrc, name, monkeypatch):
    stem = _build.library_stem(name, csrc)
    assert stem.startswith(f"{name}-") and stem == _build.library_stem(name, _build.CSRC)
    assert _build.library_stem(name, csrc) == stem  # unchanged tree: the same library
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    edited = _build.library_stem(name, csrc)
    assert edited != stem
    (csrc / "extra.cuh").write_text("#pragma once\n")  # a new header counts too
    assert _build.library_stem(name, csrc) not in (stem, edited)
    src = csrc / f"{name}.cu"
    before = _build.library_stem(name, csrc)
    src.write_text(src.read_text() + "\n")
    assert _build.library_stem(name, csrc) != before
    before = _build.library_stem(name, csrc)
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_stem(name, csrc) != before


@pytest.mark.parametrize(
    "b,hkv,s,group,per_block,want",
    [(1, 1, 2048, 16, 32, (32, 64)),  # recurrentgemma's ring: one block per kv head
     (1, 1, 2048, 16, 8, (32, 64)),  # float32: two blocks per kv head, same splits
     (4, 8, 1088, 3, 32, (9, 121)),  # phi4-mini's decode
     (4, 1, 1088, 16, 32, (17, 64)),
     (64, 8, 4096, 3, 32, (1, 4096))],  # enough blocks without a split
)
def test_decode_splits(b, hkv, s, group, per_block, want):
    n_split, chunk = decode_splits(b, hkv, s, 132, group, per_block)
    assert (n_split, chunk) == want and n_split * chunk >= s
