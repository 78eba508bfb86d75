"""Training launcher.  Port of ``repro.launch.train``: the same flags and
lines, plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --reduced --steps 50 [--resume] [--microbatches 2] [--device cpu]

The reference trains the reduced config with ``--reduced`` or on one
device (``repro/launch/train.py:50-51``); the port runs on one device, so
it always trains the reduced config.  Batches come from ``SyntheticLM``
(numpy, seeded), are put on the device, and go through
``make_train_step`` under the fault-tolerant ``Supervisor``, which writes
a checkpoint every ``--ckpt-every`` steps (and at step 0) to
``--ckpt-dir`` (default: ``repro_torch_ckpt`` in the system's temporary
directory); ``--resume`` restarts from the newest intact one.

``--arch`` takes every text architecture without experts: the dense ones,
``mamba2-1.3b`` and ``recurrentgemma-9b``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.train import (
    AdamWConfig,
    StepResult,
    Supervisor,
    SupervisorConfig,
    TrainStepConfig,
    init_opt_state,
    make_train_step,
)


def main(argv: list[str] | None = None) -> list[StepResult]:
    """Run the launcher; returns the supervisor's history of this run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compression", choices=["none", "int8_ef", "topk_ef"], default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M devices=1")

    params = lm.init_params(cfg, args.seed, device=device)
    opt = init_opt_state(params)
    data = SyntheticLM(cfg, DataConfig(seq_len=args.seq, global_batch=args.batch, seed=args.seed))
    step = make_train_step(
        cfg,
        TrainStepConfig(
            n_microbatches=args.microbatches,
            adamw=AdamWConfig(warmup_steps=10, total_steps=args.steps),
            compression=args.compression,
        ),
    )
    sup = Supervisor(
        step,
        params,
        opt,
        lambda s: {k: torch.from_numpy(v).to(device) for k, v in data(s).items()},
        SupervisorConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
    )
    if args.resume:
        try:
            sup.params, sup.opt_state, sup.step = sup.resume_with(params, opt)
            print(f"resumed from step {sup.step}")
        except RuntimeError:
            print("no checkpoint found; starting fresh")
    hist = sup.run(args.steps)
    losses = [h.loss for h in hist]
    print(
        f"steps {hist[0].step}..{hist[-1].step}: loss {losses[0]:.4f} → {losses[-1]:.4f}"
        f"  (restarts={sum(h.restarted for h in hist)},"
        f" stragglers={sum(h.straggler for h in hist)})"
    )
    return hist


if __name__ == "__main__":
    main()
