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
from repro_torch.kernels.scan import RG_WIDTHS, SSD_HEAD_DIMS, rglru_plan, ssd_plan
from repro_torch.kernels.spike_accum import DENSE_SLAB, blocks_plan, dense_plan

SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path):
    out = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, out)
    return out


def test_sources_and_headers_found():
    assert SOURCES == ["attention", "random", "scan", "spike_accum"]
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


@pytest.mark.parametrize("bs,width", [(1, 32), (4, 128)])
@pytest.mark.parametrize("s", [512, 1024, 4096])
def test_rglru_plan_fills_the_card(bs, width, s):
    """recurrentgemma-9b's prefills (lru_width 4,096; batch 1 and 4, S 512
    to 4,096): channel tiles narrow enough that the grid covers at least
    120 of the 132 SMs, in at most two waves, with at least 32 KB of a and
    b in flight per block."""
    plan = rglru_plan(bs, s, 4096)
    blocks = plan["grid"][0] * plan["grid"][1]
    assert plan["width"] == width and plan["grid"] == (4096 // width, bs)
    assert min(blocks, _build.SMS) >= 120
    assert plan["waves"] <= 2 and blocks <= 2 * plan["blocks_per_sm"] * _build.SMS
    assert plan["bytes_in_flight"] >= 32 * 1024
    assert plan["smem"] <= _build.SMEM_LIMIT and plan["blocks_per_sm"] >= 1


@pytest.mark.parametrize("bs", [1, 2, 4, 64])
@pytest.mark.parametrize("s", [1, 37, 1000, 4096])
@pytest.mark.parametrize("d", [33, 100, 4096, 4100])
def test_rglru_plan_covers_every_step_and_channel(bs, s, d):
    """Tails of S and of D: one block per started channel tile of every
    batch row, enough ring stages for every step, the ring in shared
    memory."""
    plan = rglru_plan(bs, s, d)
    width, steps = plan["width"], plan["steps"]
    assert width in RG_WIDTHS and width * steps == 2048
    tiles, rows = plan["grid"]
    assert rows == bs and tiles * width >= d > (tiles - 1) * width
    assert plan["n_stages"] * steps >= s > (plan["n_stages"] - 1) * steps
    assert 0 < plan["smem"] <= _build.SMEM_LIMIT and plan["blocks_per_sm"] >= 1


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


@pytest.mark.parametrize("n,blocks", [(4096, 32), (32768, 256)])
def test_dense_plan_at_the_oracle_shapes(n, blocks):
    """The single-device oracle's shapes (W f32[32768, n]): eight row
    slabs, K1's 128-column blocks, two an SM, so N = 32,768 runs in one
    wave and N = 4,096's 32 blocks, each bound by its columns' chains over
    the fired rows, run at once."""
    plan = dense_plan(32768, n)
    assert plan == {**blocks_plan(1, 8, n), "k_tiles": 8, "last_rows": 4096}
    assert plan["threads"] == 128 and plan["grid"] == (blocks, 1)
    assert plan["compact_grid"] == (8, 1) and plan["blocks_per_sm"] == 2
    assert blocks <= plan["blocks_per_sm"] * _build.SMS


@pytest.mark.parametrize("m", [1, 1000, 4096, 4097, 5000, 32768, 100_000])
@pytest.mark.parametrize("n", [1, 30, 200, 4096, 8449, 32768])
def test_dense_plan_covers_every_row_and_column(m, n):
    """K = ceil(M / 4,096) row slabs, the last one short where 4,096 does
    not divide M; one 128-column block per started column tile; the shared
    memory fits."""
    plan = dense_plan(m, n)
    k = plan["k_tiles"]
    assert k == -(-m // DENSE_SLAB) and plan["compact_grid"] == (k, 1)
    assert (k - 1) * DENSE_SLAB + plan["last_rows"] == m and 0 < plan["last_rows"] <= DENSE_SLAB
    tiles = plan["grid"][0]
    assert tiles * 128 >= n > (tiles - 1) * 128 and plan["grid"][1] == 1
    assert plan["smem"] <= _build.SMEM_LIMIT and plan["blocks_per_sm"] >= 2
