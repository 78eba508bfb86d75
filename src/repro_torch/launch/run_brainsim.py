"""Brain-simulation launcher: partition (Alg. 1) → route (Alg. 2) →
distributed spiking run with the chosen exchange schedule.  Port of
``repro.launch.run_brainsim``: the same flags and output lines, with
``--ranks`` ranks (default 8), ``--device`` and ``--eager``.

Run as it is, all ranks live in one process on one device behind a
``LoopbackComm``.  Started by ``torch.distributed.run`` (``WORLD_SIZE`` >
1), each process runs one rank behind a ``ProcessGroupComm`` — NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``, or with ``--backend
gloo`` gloo on the card staged through the host, the ranks sharing the
cards round robin (all of them the one card of a one-card machine) — and
``--ranks`` must equal ``WORLD_SIZE``; rank 0 prints the lines, the
gathered raster's, and the executed ledger summed over the ranks.  On the
card the steps replay a CUDA graph of one step (the counterpart of the
reference's ``jax.jit``) where the communicator can be captured (the
loopback; NCCL at one rank); ``--eager`` runs them op by op, as the checks
do.  ``--save`` writes what a check compares.

    PYTHONPATH=src python -m repro_torch.launch.run_brainsim \\
        --populations 256 --steps 100 --exchange sparse [--device cpu] [--eager]
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.run_brainsim --device cpu --ranks 4 --exchange ragged
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.run_brainsim --backend gloo --ranks 4 --exchange ragged
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import (
    device_traffic_csr,
    greedy_partition,
    p2p_routing,
    step_latency,
    two_level_routing,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.multiproc import rank_device
from repro_torch.snn import (
    DistributedSNN, LIFParams, LoopbackComm, ProcessGroupComm, expand_synapses,
    gather_raster, generate_brain_model,
)
from repro_torch.snn.distributed import partition_permutation


def main(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns ``{"raster", "engine", "stats", "ledger"}``
    (``raster`` the global one; ``stats`` the slow-axis byte ledger for
    sparse/ragged, else ``None``; ``ledger`` the executed bytes per step,
    summed over the ranks)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--populations", type=int, default=128)
    ap.add_argument("--neurons-per-pop", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument(
        "--exchange",
        choices=["flat", "two_level", "sparse", "ragged"],
        default="two_level",
    )
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks of the mesh: all on one device, or under "
                         "torch.distributed.run one per process (= WORLD_SIZE)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"],
                    help="under torch.distributed.run: the process group's backend "
                         "(default nccl on cuda, gloo on cpu)")
    ap.add_argument("--eager", action="store_true",
                    help="run every step op by op instead of replaying a CUDA graph")
    ap.add_argument("--trace", metavar="PATH",
                    help="export a Chrome-trace JSON of the whole run "
                         "(planner spans + executor profile)")
    ap.add_argument("--save", metavar="PATH",
                    help="write the global raster, the executed ledger and each "
                         "rank's kernel launches and raster digest to PATH "
                         "(.npz; rank 0 writes it)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n_dev = args.ranks
    world = int(os.environ.get("WORLD_SIZE", "1"))
    backend = None
    if world > 1:
        if n_dev != world:
            raise ValueError(f"--ranks {n_dev} != WORLD_SIZE {world}: one rank per process")
        backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
        device = rank_device(backend, device.type, int(os.environ.get("LOCAL_RANK", "0")))
        if device.type == "cuda":
            torch.cuda.set_device(device)
    made_group = backend is not None and not dist.is_initialized()
    if made_group:
        dist.init_process_group(backend)
    try:
        return _run(args, device, backend)
    finally:
        if made_group:
            dist.destroy_process_group()


def _run(args, device: torch.device, backend: str | None) -> dict:
    lead = backend is None or dist.get_rank() == 0
    say = print if lead else (lambda *_a, **_k: None)
    if args.trace:
        obs.enable()
    n_dev = args.ranks
    bm = generate_brain_model(
        n_populations=args.populations,
        n_regions=max(8, args.populations // 16),
        total_neurons=1_000_000,
        seed=args.seed,
    )
    with obs.span("launch.partition", cat="plan", tid="launch"):
        part = greedy_partition(bm.graph, n_dev, seed=args.seed)
    t, wg = device_traffic_csr(bm.graph, part.assign, n_dev)  # sparse CSR
    with obs.span("launch.route", cat="plan", tid="launch"):
        tb = two_level_routing(t, wg, max(2, n_dev // 4))
    say(
        f"devices={n_dev} cut={part.cut:.1f} groups={tb.n_groups} "
        f"latency p2p={step_latency(p2p_routing(t, wg)).t_total*1e3:.2f}ms "
        f"two-level={step_latency(tb).t_total*1e3:.2f}ms"
    )

    w, pop_of = expand_synapses(bm.graph, args.neurons_per_pop, seed=args.seed)
    m = w.shape[0]
    n_assign = part.assign[pop_of]
    order = np.argsort(n_assign, kind="stable")
    eq = np.empty(m, np.int64)
    eq[order] = np.arange(m) // (m // n_dev)
    perm = partition_permutation(eq, n_dev)
    wp = w[np.ix_(perm, perm)].astype(np.float32) * 0.05

    mesh_shape = (2, n_dev // 2) if n_dev % 2 == 0 and n_dev > 2 else (1, n_dev)
    comm = (LoopbackComm(mesh_shape, device) if backend is None
            else ProcessGroupComm(mesh_shape, backend, device))
    eng = DistributedSNN(
        mesh=mesh_shape,
        w_syn=wp,
        params=LIFParams(noise_sigma=args.noise),
        exchange=args.exchange,
        i_ext=3.5,
        device=device,
        graph=False if args.eager or not comm.capturable else None,
    )
    if args.trace and args.exchange in ("sparse", "ragged") and backend is None:
        prof = eng.step_profile(min(args.steps, 4), seed=args.seed)
        say("step profile: " + "  ".join(
            f"{k}={v:.4g}" for k, v in sorted(prof.items())))
    with obs.span("launch.run", cat="exec", tid="launch",
                  args={"exchange": args.exchange, "steps": args.steps}):
        raster = eng.run(args.steps, seed=args.seed, comm=comm)
    raster = gather_raster(raster, comm).cpu().numpy()
    ledger = comm.ledger_total()
    say(
        f"simulated {m} neurons × {args.steps} steps ({args.exchange} exchange): "
        f"{int(raster.sum())} spikes, mean rate {raster.mean():.4f}"
    )
    vol = None
    if args.exchange in ("sparse", "ragged"):
        vol = eng.exchange_stats()
        say(
            "slow-axis bytes/step: "
            + "  ".join(f"{k}={v}" for k, v in sorted(vol.items()))
        )
    if backend is not None:
        per_step = sorted(set(ledger))
        say(f"executed slow-axis bytes/step over {n_dev} processes ({backend}): "
            + " ".join(map(str, per_step)))
    if args.save:
        _save(args.save, raster, ledger, backend, lead)
    if args.trace:
        obs.disable()
        if lead:
            obs.write_chrome_trace(args.trace)
        say(f"trace written to {args.trace}")
    return {"raster": raster, "engine": eng, "stats": vol, "ledger": ledger}


def _save(path: str, raster: np.ndarray, ledger: list[int], backend: str | None,
          lead: bool) -> None:
    """``raster``, ``ledger`` and every rank's ``LAUNCHES`` and raster
    digest (rank order), gathered to rank 0, which writes them."""
    mine = (dict(LAUNCHES), hashlib.sha256(raster.tobytes()).hexdigest())
    ranks = [mine]
    if backend is not None:
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
    if lead:
        np.savez(path, raster=raster, ledger=np.asarray(ledger, dtype=np.int64),
                 launches=np.asarray(json.dumps([launches for launches, _ in ranks])),
                 digests=np.asarray([digest for _, digest in ranks]))


if __name__ == "__main__":
    main()
