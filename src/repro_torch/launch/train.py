"""Training launcher.  Port of ``repro.launch.train``: the same flags and
lines, plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --reduced --steps 50 [--resume] [--microbatches 2] [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch phi4-mini-3.8b --reduced --steps 3 --device cpu

Run as it is, the launcher trains on one device, and then always the
reduced config, as the reference does on one device
(``repro/launch/train.py:50-51``).  Started by ``torch.distributed.run``
with ``WORLD_SIZE`` n > 1 (n even), it builds the reference's mesh,
``init_device_mesh`` of ``(n // 2, 2)`` ``("data", "model")``, and
``make_policy(mesh)``: gloo on the CPU with ``--device cpu``, NCCL on
``cuda:LOCAL_RANK`` otherwise.  Every rank makes the same parameters and
batches from the seed, the parameters from ``PRNGKey(--seed)`` as the
reference's (``repro_torch.random``: the same values within an ulp); they
are laid out by
``lm.distribute_params`` (FSDP over ``data``, TP/EP over ``model``) and the
step is ``make_train_step(cfg, ts, pol)``, eager.  On one device the step is
``compile_train_step``'s: replayed from a CUDA graph on the card, eager
with ``--device cpu``, as the reference's launcher jits the step whatever
its backend (``repro/launch/train.py:62``).  There, as in the reference, the
full config trains unless ``--reduced`` is given.  Only rank 0 prints.
Batches come from ``SyntheticLM`` (numpy, seeded), are put on the device,
and go through the step under the fault-tolerant ``Supervisor``, which
writes a checkpoint every ``--ckpt-every`` steps (and at step 0) to
``--ckpt-dir`` (default: ``repro_torch_ckpt`` in the system's temporary
directory; over several ranks rank 0 writes it); ``--resume`` restarts
from the newest intact one.

``--arch`` takes every architecture of the zoo: the dense ones, the
mixtures of experts, ``mamba2-1.3b``, ``recurrentgemma-9b``, and the vlm
and audio configs (``SyntheticLM`` makes their patch embeddings and
codebook streams).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.multiproc import rank_device
from repro_torch.sharding import ShardingPolicy, make_policy
from repro_torch.train import (
    AdamWConfig,
    StepResult,
    Supervisor,
    SupervisorConfig,
    TrainStepConfig,
    init_opt_state,
)
from repro_torch.train.train_step import compile_train_step


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

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return _train(args, resolve_device(args.device), ShardingPolicy())
    if world % 2:
        raise ValueError(f"WORLD_SIZE {world} is odd: the mesh is (n // 2, 2) (data, model)")
    backend = "gloo" if args.device == "cpu" else "nccl"
    device = rank_device(backend, args.device, int(os.environ.get("LOCAL_RANK", "0")))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    made_group = not dist.is_initialized()
    if made_group:
        dist.init_process_group(backend)
    try:
        mesh = init_device_mesh(device.type, (world // 2, 2), mesh_dim_names=("data", "model"))
        return _train(args, device, make_policy(mesh))
    finally:
        if made_group:
            dist.destroy_process_group()


def _train(args, device: torch.device, pol: ShardingPolicy) -> list[StepResult]:
    lead = pol.mesh is None or dist.get_rank() == 0
    n_dev = 1 if pol.mesh is None else pol.mesh.size()
    cfg = ARCHS[args.arch]
    if args.reduced or n_dev == 1:
        cfg = cfg.reduced()
    if lead:
        print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M devices={n_dev}")

    params = lm.distribute_params(lm.init_params(cfg, args.seed, device=device), cfg, pol)
    opt = init_opt_state(params)
    data = SyntheticLM(cfg, DataConfig(seq_len=args.seq, global_batch=args.batch, seed=args.seed))
    step = compile_train_step(
        cfg,
        TrainStepConfig(
            n_microbatches=args.microbatches,
            adamw=AdamWConfig(warmup_steps=10, total_steps=args.steps),
            compression=args.compression,
        ),
        pol,
        device=device,
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
            if lead:
                print(f"resumed from step {sup.step}")
        except RuntimeError:
            if lead:
                print("no checkpoint found; starting fresh")
    hist = sup.run(args.steps)
    losses = [h.loss for h in hist]
    if lead:
        print(
            f"steps {hist[0].step}..{hist[-1].step}: loss {losses[0]:.4f} → {losses[-1]:.4f}"
            f"  (restarts={sum(h.restarted for h in hist)},"
            f" stragglers={sum(h.straggler for h in hist)})"
        )
    return hist


if __name__ == "__main__":
    main()
