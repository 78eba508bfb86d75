"""Serving launcher.  Port of ``repro.launch.serve``: the same flags and
``prompt -> tokens`` lines, plus ``--device``.  The port runs on one
device, so it serves the reduced config, the reference's rule for one
device (``repro/launch/serve.py:27``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --prompts "1,2,3" "4,5" --max-new 16 [--device cpu] [--eager]

On the card decode steps replay a CUDA graph of one step; ``--eager`` runs
them op by op.

``--arch`` takes every text architecture: the dense ones, the mixtures of
experts (``qwen3-moe-30b-a3b``, ``mixtral-8x22b``), ``mamba2-1.3b`` and
``recurrentgemma-9b``; the engine refuses the vlm and audio configs
(``NotImplementedError``), as the reference's does.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv: list[str] | None = None) -> list[list[int]]:
    """Run the launcher; returns the generated tokens per prompt."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--prompts", nargs="+", default=["1,2,3", "4,5,6,7"])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run every decode step op by op instead of replaying a CUDA graph")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    params = lm.init_params(cfg, 0, device=device)
    eng = ServeEngine(
        cfg,
        params,
        ServeConfig(batch_slots=args.batch_slots, temperature=args.temperature),
        device=device,
        graph=False if args.eager else None,
    )
    prompts = [[int(t) for t in p.split(",")] for p in args.prompts]
    outs = eng.generate(prompts, max_new_tokens=args.max_new)
    for p, o in zip(prompts, outs):
        print(f"{p} -> {o}")
    return outs


if __name__ == "__main__":
    main()
