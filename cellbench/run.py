#!/usr/bin/env python3
"""Time one cell of ``BENCHMARK.json`` on the card and check its outputs.

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (``src/repro_torch``).
Prints one JSON line last on standard output (see ``README.md``) and, last on
standard error, each number compared with the plain reference beside its
limit.  Exits non-zero, printing no result, without a CUDA device (or
fewer than the cell asks for), without the program, or if the process
loaded JAX or the JAX package.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """The checkout's root (for ``cellbench``) and its ``src`` (for the
    program) first on the path.  Any build cache the program or PyTorch
    keeps (an extension's, Triton's, Inductor's) goes inside the checkout
    at a fixed path, so only a checkout's first run builds; the port's own
    ``nvcc`` builds already land in ``build/repro_torch_kernels``."""
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    cache = ROOT / "build" / "cellbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"


if __name__ == "__main__":
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"cellbench: no program at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        sys.exit(2)
    _paths()
    from cellbench.harness import main

    sys.exit(main(t0=T0))
