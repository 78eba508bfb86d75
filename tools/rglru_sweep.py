#!/usr/bin/env python3
"""Device time of the port's K6 ``rglru_scan`` (``csrc/scan.cu``) at
recurrentgemma-9b's prefill shapes, at every channel tile the kernel is
built for and for variants of its ring, on one NVIDIA GPU:

    python3 tools/rglru_sweep.py [--out FILE]

Each variant is a copy of ``src/repro_torch/kernels/csrc/scan.cu`` (and
``hopper.cuh``) under ``build/rglru_sweep/<name>/`` with text
substitutions, built by ``nvcc`` with the port's flags (all builds at
once) and launched through its C interface at widths 32, 64 and 128.  A
time is the profiler's device time per call, the mean over 20 calls.
Every variant's trace must equal the shipped build's bit for bit.  Prints
the card's name and power limit, then one JSON object per shape (and
writes them all to ``--out``).  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"rg_prefill": (4, 1024, 4096), "rg_wave2": (4, 512, 4096),
          "rg_continuous": (1, 1024, 4096), "rg_long": (1, 4096, 4096)}
WIDTHS = (32, 64, 128)
_STAGES, _FLOATS = "kRgStages = 4;", "kRgStageFloats = 2048;"
_STORE = "out[static_cast<long long>(r0 + u) * d] = state;"
VARIANTS = {
    "shipped": (),
    "stages3": ((_STAGES, "kRgStages = 3;"),),
    "stages6": ((_STAGES, "kRgStages = 6;"),),
    "stages8": ((_STAGES, "kRgStages = 8;"),),
    "stage32k_stages3": ((_FLOATS, "kRgStageFloats = 4096;"), (_STAGES, "kRgStages = 3;")),
    "stage32k": ((_FLOATS, "kRgStageFloats = 4096;"),),
    "stage32k_stages6": ((_FLOATS, "kRgStageFloats = 4096;"), (_STAGES, "kRgStages = 6;")),
    "streaming_stores": ((_STORE, "__stcs(out + static_cast<long long>(r0 + u) * d, state);"),),
}


def build(name: str, subs) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "rglru_sweep" / name
    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "hopper.cuh", out)
    text = (_build.CSRC / "scan.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in scan.cu")
        text = text.replace(old, new)
    (out / "scan.cu").write_text(text)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "scan.so"),
                          str(out / "scan.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out / "scan.so"))
    lib.rglru_scan_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.rglru_scan_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("rglru_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda kv: build(*kv), VARIANTS.items())))

    def launch(lib, a, b, width):
        h = torch.empty_like(a)
        err = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(), *a.shape, width,
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return h

    def device_ms(fn, calls: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # the profiler now and then reads no device time
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages() if "rglru" in e.key and e.count]
            if evs:
                return sum(e.self_device_time_total for e in evs) / sum(e.count for e in evs) / 1e3
        raise RuntimeError("the profiler saw no rglru kernel")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case, shape in SHAPES.items():
        a = 0.8 + 0.199 * torch.rand(shape, generator=gen, device="cuda")
        b = torch.randn(shape, generator=gen, device="cuda")
        row = {"case": case, "shape": list(shape), "bound_ms": 12 * a.numel() / 3.35e12 * 1e3}
        for width in WIDTHS:
            want = launch(libs["shipped"], a, b, width)
            for name, lib in libs.items():
                if not torch.equal(launch(lib, a, b, width), want):
                    raise AssertionError(f"{case}: {name} at width {width} differs")
                row[f"{name}/w{width}"] = device_ms(
                    lambda lib=lib, a=a, b=b, width=width: launch(lib, a, b, width))
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
