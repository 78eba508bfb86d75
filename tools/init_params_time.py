#!/usr/bin/env python3
"""Seconds of ``lm.init_params(cfg, 0)`` on one NVIDIA GPU, at full width
and depth, for the served models:

    python3 tools/init_params_time.py [--src DIR] [--arch NAME ...] [--reps N]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default
this checkout's), so that another tree's initialiser (say, a ``git
archive`` of the parent commit unpacked under ``build/``) can be timed in
the same call on the same card.  Each model is drawn ``--reps`` times
(each draw freed before the next); a time is the host clock from the
call to ``torch.cuda.synchronize()``, the kernels' build excluded (one
draw of a small leaf first).  Prints the card's name and power limit,
then one JSON object: seconds per arch and draw, the parameter bytes,
and the ``threefry`` launches of one draw where the tree counts them.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("phi4-mini-3.8b", "mamba2-1.3b", "recurrentgemma-9b", "qwen3-moe-30b-a3b")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("init_params_time: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import ARCHS as CONFIGS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    dev = torch.device("cuda")
    lm.init_params(CONFIGS[args.arch[0]].reduced(), 0, device=dev)  # builds what it needs
    torch.cuda.synchronize()
    out = {"src": args.src, "seconds": {}, "param_bytes": {}, "threefry_launches": {}}
    for arch in args.arch:
        cfg, times = CONFIGS[arch], []
        for _ in range(args.reps):
            before = dict(LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = lm.init_params(cfg, 0, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            leaves = [params]
            nbytes = 0
            while leaves:
                node = leaves.pop()
                if isinstance(node, dict):
                    leaves.extend(node.values())
                else:
                    nbytes += node.numel() * node.element_size()
            out["param_bytes"][arch] = nbytes
            if "threefry" in LAUNCHES:
                out["threefry_launches"][arch] = LAUNCHES["threefry"] - before["threefry"]
            del params, leaves, node
            torch.cuda.empty_cache()
        out["seconds"][arch] = times
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
