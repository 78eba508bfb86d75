"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use, and
count their launches.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so <src>

Sources include the shared headers ``csrc/*.cuh`` (``hopper.cuh``: the
mbarrier, TMA and ``wgmma`` helpers).  The library lands in
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``) under a name carrying the hash of the source, of every
header and of the flags (:func:`library_stem`), so an edited source or
header is rebuilt and an unchanged one is loaded as it is.  Nothing here
runs at import time: the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = [
    "NVCC_FLAGS", "build_dir", "library_stem", "build_library", "load_library", "BUILD_SECONDS",
    "LAUNCHES", "reset_launches", "raise_on", "SMS", "SMEM_LIMIT", "blocks_per_sm",
]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: seconds spent compiling each library in this process (0.0 when loaded
#: from an earlier build)
BUILD_SECONDS: dict[str, float] = {}

#: kernel launches per kernel name, counted where each wrapper launches
LAUNCHES: dict[str, int] = {
    "spike_accum_blocks": 0, "spike_accum": 0,
    "flash_attention": 0, "decode_attention": 0,
    "ssd_scan": 0, "rglru_scan": 0, "threefry": 0,
}

# an H100 SXM, for the wrappers' launch geometry (NVIDIA's H100 specifications)
SMS = 132  # streaming multiprocessors
SMEM_LIMIT = 232_448  # shared memory one block may opt into
SMEM_PER_SM = 233_472  # shared memory of one SM (228 KB)
SMEM_PER_BLOCK_RESERVED = 1_024  # what the card keeps per resident block

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's "
        "CUDA kernels are built on the machine with the card"
    )


def library_stem(name: str, csrc: Path = CSRC) -> str:
    """``<name>-<hash>``, the hash over what a build of ``<name>.cu`` reads:
    the source, every header ``*.cuh`` beside it (any may be included) and
    the flags."""
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return f"{name}-{digest.hexdigest()[:16]}"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source,
    these headers and these flags exists; returns the library's path."""
    src = CSRC / f"{name}.cu"
    out_dir = build_dir()
    out = out_dir / f"{library_stem(name)}.so"
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {res.returncode}):\n"
                f"{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name)))
            _LIBS[name] = lib
        return lib


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def raise_on(err: int, name: str) -> None:
    """Raise when a launcher returned a nonzero CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def blocks_per_sm(smem_bytes: int, threads: int) -> int:
    """Blocks of ``threads`` threads using ``smem_bytes`` of shared memory
    that one SM holds at once: by shared memory, by threads (2,048) and
    by blocks (32); registers are not counted."""
    return min(SMEM_PER_SM // (smem_bytes + SMEM_PER_BLOCK_RESERVED), 2048 // threads, 32)
