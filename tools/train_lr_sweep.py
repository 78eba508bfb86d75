#!/usr/bin/env python3
"""The losses of ``chip_smoke.py``'s full-width training paths
(``TRAIN_FULL``) at several AdamW peak learning rates, on one NVIDIA GPU:

    python3 tools/train_lr_sweep.py [--lr 1e-5 2e-5 ...]

Each path trains ``TRAIN_STEPS`` steps from ``init_params(cfg, 0)`` on its
``SyntheticLM`` batches in phase ``train``'s plain loop (2 microbatches,
one warmup step, AdamW's default ``min_lr``), every gradient leaf checked.
Prints the card's name and power limit, then one JSON object per (path,
learning rate): the losses a step and the seconds.  Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts the port's src/ on the path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="+", default=[chip_smoke.TRAIN_FULL_LR, 2e-5])
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels import _build
    from repro_torch.train import AdamWConfig, TrainStepConfig

    if not torch.cuda.is_available():
        print("train_lr_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_library("random")
    _build.load_library("random")
    print(chip_smoke.nvidia_smi(), flush=True)
    for phase, (arch, n_layers, batch, seq) in chip_smoke.TRAIN_FULL.items():
        cfg = chip_smoke._depth_cut(arch, n_layers)
        data = chip_smoke._train_data(cfg, batch, seq)
        for lr in args.lr:
            t0 = time.perf_counter()
            ts = TrainStepConfig(n_microbatches=chip_smoke.TRAIN_MICROBATCHES, adamw=AdamWConfig(
                peak_lr=lr, warmup_steps=1, total_steps=chip_smoke.TRAIN_STEPS))
            step, params, opt, hist, _ = chip_smoke._train_loop(dev, cfg, data, ts,
                                                                chip_smoke.TRAIN_STEPS)
            print(json.dumps({"phase": phase, "lr": lr, "losses": [h.loss for h in hist],
                              "s": time.perf_counter() - t0}), flush=True)
            del step, params, opt, hist
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
