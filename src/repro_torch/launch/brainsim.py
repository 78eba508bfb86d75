"""Distributed brain simulation — the paper's system end to end.  Port of
the reference's ``examples/brainsim.py``: the same flags and output lines,
plus ``--device``, ``--eager`` and ``--exchanges``.

    PYTHONPATH=src python -m repro_torch.launch.brainsim \\
        [--method {greedy,multilevel}] [--steps 100] [--device cpu] [--eager]

Builds a brain model, partitions it with Algorithm 1 (or the multilevel
scheme), derives the Algorithm 2 routing table, then runs the distributed
spiking engine on 8 logical ranks (2 pods × 4) on one device with the
flat all-gather (the paper's P2P baseline) and the two-level bridge
schedule — verifying they produce identical spike rasters while the
traffic model shows the latency gap.  ``--exchanges`` adds the ``sparse``
and ``ragged`` schedules (the block-CSR kernel's path) to the comparison.
On the card the steps replay a CUDA graph of one step; ``--eager`` runs
them op by op.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (
    device_traffic_csr,
    greedy_partition,
    multilevel_partition,
    p2p_routing,
    step_latency,
    two_level_routing,
)
from repro_torch.device import resolve_device
from repro_torch.snn import DistributedSNN, LIFParams, expand_synapses, generate_brain_model
from repro_torch.snn.distributed import partition_permutation

EXCHANGES = ("flat", "two_level", "sparse", "ragged")


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns ``{"rasters", "partition", "table",
    "latency_s"}`` — the raster of each exchange (numpy ``[T, M]``), the
    population partition, the routing table and the modeled step latency
    of P2P and two-level routing.  Raises if the rasters differ."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--neurons-per-pop", type=int, default=4)
    ap.add_argument(
        "--method",
        choices=["greedy", "multilevel"],
        default="greedy",
        help="partitioner: Algorithm 1 greedy or the multilevel scheme",
    )
    ap.add_argument("--exchanges", nargs="+", choices=EXCHANGES,
                    default=["flat", "two_level"],
                    help="exchange schedules to run and compare (first is the yardstick)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run every step op by op instead of replaying a CUDA graph")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n_dev = 8

    print(f"=== model + partition (Algorithm 1, method={args.method}) ===")
    bm = generate_brain_model(
        n_populations=128, n_regions=8, total_neurons=1_000_000, seed=0
    )
    partition_fn = greedy_partition if args.method == "greedy" else multilevel_partition
    part = partition_fn(bm.graph, n_dev)
    print(f"populations={bm.n_populations} devices={n_dev} cut={part.cut:.1f} "
          f"loads={np.round(part.loads, 1)}")

    print("\n=== routing (Algorithm 2) + latency model ===")
    t, wg = device_traffic_csr(bm.graph, part.assign, n_dev)  # sparse CSR
    tb = two_level_routing(t, wg, 2)
    lat_p2p = step_latency(p2p_routing(t, wg)).t_total
    lat_two = step_latency(tb).t_total
    print(f"groups={tb.n_groups} bridges=\n{tb.bridge}")
    print(f"modeled step latency: p2p {lat_p2p*1e3:.2f} ms → two-level {lat_two*1e3:.2f} ms")

    print("\n=== distributed spiking engine (8 devices, 2 pods × 4) ===")
    # neuron-level expansion + physical permutation realizing the partition
    w, pop_of = expand_synapses(bm.graph, args.neurons_per_pop, seed=0)
    m = w.shape[0]
    # device of each neuron = device of its population; equalize counts
    n_assign = part.assign[pop_of]
    order = np.argsort(n_assign, kind="stable")
    per = m // n_dev
    n_assign_eq = np.empty(m, np.int64)
    n_assign_eq[order] = np.arange(m) // per
    perm = partition_permutation(n_assign_eq, n_dev)
    wp = w[np.ix_(perm, perm)].astype(np.float32) * 0.05

    rasters = {}
    for exchange in dict.fromkeys(args.exchanges):
        eng = DistributedSNN(
            mesh=(2, 4),
            w_syn=wp,
            params=LIFParams(noise_sigma=0.0),
            exchange=exchange,
            i_ext=3.5,
            device=device,
            graph=False if args.eager else None,
        )
        rasters[exchange] = eng.run(args.steps, seed=0).cpu().numpy()
        print(f"{exchange:10s}: {int(rasters[exchange].sum())} spikes "
              f"over {args.steps} steps × {m} neurons")
    first, *others = rasters
    for exchange in others:
        if not np.array_equal(rasters[exchange], rasters[first]):
            raise AssertionError(f"schedules must agree: {exchange} != {first}")
    names = " and ".join(n.replace("_", "-") for n in rasters)
    print(f"{names} exchanges produce identical rasters ✓")
    return {"rasters": rasters, "partition": part, "table": tb,
            "latency_s": {"p2p": lat_p2p, "two_level": lat_two}}


if __name__ == "__main__":
    main()
