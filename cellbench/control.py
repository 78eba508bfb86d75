#!/usr/bin/env python3
"""Readings that set a cell's limit: the number its check compares, from
the program over many seeds, and from the control over some of them.

    python3 cellbench/control.py --workload <cell> --seeds 11 12 ... --control 11 12 13

One process, one seed after another, each at the cell's own size and load
(one simulation, one call).  The control is the plain reference put in the
program's place in the next precision below the configuration's (the
traffic driver's ``readings``).  Prints one JSON line a seed.  The
benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from cellbench import harness, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    driver = spec.traffic_driver(cell)
    for seed in args.seeds:
        t = time.perf_counter()
        ctx = harness.RunContext(cell=cell, seed=seed, device=torch.device("cuda"), t0=T0)
        got = driver.readings(ctx, control=seed in args.control)
        print(json.dumps({"workload": cell.name, "seed": seed, **got,
                          "seconds": time.perf_counter() - t}), flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
