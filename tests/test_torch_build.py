"""How the port names its CUDA libraries (``repro_torch.kernels._build``),
on the CPU: the name hashes everything a build reads, so an edited source,
an edited shared header (``csrc/*.cuh``) or other flags give another
library, and an unchanged tree loads the one it built before.  Also the
wrappers' launch geometry (split counts, tiles, stages, shared memory and
workspaces), which is plain Python."""
from __future__ import annotations

import shutil

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.attention import decode_splits
from repro_torch.kernels.scan import SSD_HEAD_DIMS, ssd_plan
from repro_torch.kernels.spike_accum import blocks_plan

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


# mamba2-1.3b's prefill wave (B 4, S 1,024, H 64, G 1, P 64, N 128, chunk 128)
MAMBA2 = dict(bs=4, s=1024, h=64, g=1, p=64, n=128, chunk=128)


def test_ssd_plan_at_mamba2_prefill():
    plan = ssd_plan(**MAMBA2)
    assert (plan["chunk"], plan["n_chunks"]) == (128, 8)
    # one state walker per (batch, head); the chunk scan's 2,048 (batch,
    # chunk, head) items in runs of 8, 256 blocks, two an SM; C Bᵀ once per
    # (batch, group, chunk)
    assert plan["grid"] == {"cb": 32, "state": 256, "scan": 256}
    assert plan["items_per_scan_block"] == 8
    assert plan["workspace"] == {"cum": 4 * 4 * 64 * 1024, "cb": 4 * 4 * 8 * 128 * 128,
                                 "states": 2048 * 32 * 1024}  # 67 MB of chunk states
    assert plan["blocks_per_sm"]["state"] >= 2 and plan["blocks_per_sm"]["scan"] >= 2
    assert plan["grid"]["scan"] <= 2 * _build.SMS  # one wave


@pytest.mark.parametrize("p", SSD_HEAD_DIMS)
@pytest.mark.parametrize("chunk,s", [(128, 1024), (127, 127), (96, 384), (64, 256)])
def test_ssd_plan_fits_shared_memory(p, chunk, s):
    plan = ssd_plan(bs=2, s=s, h=8, g=2, p=p, n=128, chunk=chunk)
    assert all(0 < v <= _build.SMEM_LIMIT for v in plan["smem"].values())
    assert all(v >= 1 for v in plan["blocks_per_sm"].values())
    assert plan["n_chunks"] * plan["chunk"] == s
    items = 2 * plan["n_chunks"] * 8
    assert (plan["grid"]["scan"] - 1) * plan["items_per_scan_block"] < items
    assert plan["grid"]["scan"] * plan["items_per_scan_block"] >= items


@pytest.mark.parametrize("k_tiles", [8, 1, 64])
def test_blocks_plan_at_the_snn_real_size(k_tiles):
    """8 ranks of 4,096-column tiles (phase 2's and the real-size run's
    shape): 128-column tiles, 256 blocks, two an SM, at least 32 KB of
    weights in flight per block."""
    plan = blocks_plan(8, k_tiles, 4096)
    assert plan["threads"] == 128
    assert plan["grid"] == (32, 8) and plan["compact_grid"] == (k_tiles, 8)
    assert plan["blocks_per_sm"] >= 2
    assert plan["bytes_in_flight"] >= 32 * 1024
    assert plan["smem"] <= _build.SMEM_LIMIT


@pytest.mark.parametrize("n_dev,bj", [(4, 384), (1, 24), (8, 64), (2, 8192), (4, 8192),
                                      (33, 512)])
def test_blocks_plan_covers_every_column(n_dev, bj):
    """Small grids (the launcher's networks) and ragged widths: one
    128-column block per started tile of every rank, two an SM."""
    plan = blocks_plan(n_dev, 4, bj)
    cols, ranks = plan["grid"]
    assert ranks == n_dev and cols * 128 >= bj > (cols - 1) * 128
    assert plan["blocks_per_sm"] >= 2 and plan["smem"] <= _build.SMEM_LIMIT


def test_blocks_plan_counts_the_tile_offsets():
    small, big = blocks_plan(8, 8, 4096), blocks_plan(8, 40_000, 4096)
    assert big["smem"] - small["smem"] == 4 * (40_000 - 8)
    assert big["smem"] > _build.SMEM_LIMIT  # the wrapper raises before launch
