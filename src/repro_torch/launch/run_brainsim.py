"""Brain-simulation launcher: partition (Alg. 1) → route (Alg. 2) →
distributed spiking run with the chosen exchange schedule.  Port of
``repro.launch.run_brainsim``: the same flags and output lines, with
``--ranks`` logical ranks on one device (default 8) and ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.run_brainsim \\
        --populations 256 --steps 100 --exchange sparse [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import obs
from repro_torch.core import (
    device_traffic_csr,
    greedy_partition,
    p2p_routing,
    step_latency,
    two_level_routing,
)
from repro_torch.device import resolve_device
from repro_torch.snn import DistributedSNN, LIFParams, expand_synapses, generate_brain_model
from repro_torch.snn.distributed import partition_permutation


def main(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns ``{"raster", "engine", "stats"}``
    (``stats`` is the slow-axis byte ledger for sparse/ragged, else
    ``None``)."""
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
                    help="logical ranks of the mesh, all on one device")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--trace", metavar="PATH",
                    help="export a Chrome-trace JSON of the whole run "
                         "(planner spans + executor profile)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
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
    print(
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
    eng = DistributedSNN(
        mesh=mesh_shape,
        w_syn=wp,
        params=LIFParams(noise_sigma=args.noise),
        exchange=args.exchange,
        i_ext=3.5,
        device=device,
    )
    if args.trace and args.exchange in ("sparse", "ragged"):
        prof = eng.step_profile(min(args.steps, 4), seed=args.seed)
        print("step profile: " + "  ".join(
            f"{k}={v:.4g}" for k, v in sorted(prof.items())))
    with obs.span("launch.run", cat="exec", tid="launch",
                  args={"exchange": args.exchange, "steps": args.steps}):
        raster = eng.run(args.steps, seed=args.seed).cpu().numpy()
    print(
        f"simulated {m} neurons × {args.steps} steps ({args.exchange} exchange): "
        f"{int(raster.sum())} spikes, mean rate {raster.mean():.4f}"
    )
    vol = None
    if args.exchange in ("sparse", "ragged"):
        vol = eng.exchange_stats()
        print(
            "slow-axis bytes/step: "
            + "  ".join(f"{k}={v}" for k, v in sorted(vol.items()))
        )
    if args.trace:
        obs.disable()
        obs.write_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return {"raster": raster, "engine": eng, "stats": vol}


if __name__ == "__main__":
    main()
