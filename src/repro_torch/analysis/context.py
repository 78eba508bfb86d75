"""The artifact bundle planlint rules run over.

A :class:`PlanContext` carries whatever slice of the plan chain exists —
graph, partition, traffic, routing table, synapse tiles, exchange
schedule, ragged plan, netsim topology — and every field is optional:
rules lint what is present and stay silent about what is not.  The two
constructors cover the common shapes:

* :meth:`PlanContext.from_table` — an Algorithm-2 (or P2P) routing
  table; derives the group mask and the sparse ppermute schedule the
  distributed engine would run from it.
* :meth:`PlanContext.from_synapses` — block-CSR synapse tiles on a
  ``(G, R)`` mesh, optionally with the ragged plan executing them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PlanContext"]


@dataclasses.dataclass
class PlanContext:
    """Everything a Layer-1 rule may look at.  All artifact fields are
    optional; rules skip absent inputs.

    Attributes:
      name: scenario label, echoed in findings.
      graph: :class:`~repro_torch.core.graph.CommGraph`.
      partition: ``int64[M]`` vertex → part assignment.
      n_parts: part count for ``partition`` (inferred when omitted).
      traffic: :class:`~repro_torch.core.traffic.TrafficMatrix`.
      wg: ``float64[N]`` per-device weight (balance checks).
      table: :class:`~repro_torch.core.routing.RoutingTable`.
      syn: :class:`~repro_torch.snn.sparse.BlockSynapses`.
      mesh_shape: ``(G, R)`` when the context maps onto a device mesh.
      gmask: ``bool[G, G]`` group-pooled consumer mask.
      schedule: ppermute rounds (``exchange_schedule`` output shape).
      ragged_plan: :class:`~repro_torch.snn.ragged.RaggedPlan`.
      topology: :class:`~repro_torch.netsim.topology.Topology`.
      dead: device ids evacuated by ``replan(dead=...)``.
      down_links: link ids currently in an outage window
        (:class:`~repro_torch.netsim.simulate.LinkOutage`); PL171 checks every
        scheduled pair still has a route avoiding them.
      pod_of: ``int64[N]`` device → pod id (the out-of-core planner's
        coarse tier; enables PL160's independent traffic aggregation).
      shard_flows: ``float64[P, P]`` cross-pod bridge-flow ledger — row
        ``p`` is produced by pod shard ``p`` from its *own* slice of the
        traffic CSR, so PL160 can cross-check shards pairwise without
        any global artifact.
      balance_slack: PL130 cap, matching the partitioners' default.
      waste_threshold: PL140 per-round padding-waste warning bar.
      bottleneck_threshold: PL180 opt-in — when set (0..1), the
        schedule is replayed through netsim on ``topology`` and an info
        finding reports the dominant link kind if its critical-path
        share exceeds this fraction.  ``None`` (the default) skips the
        rule: the replay is a full simulation, too costly to run on
        every lint pass unasked.
    """

    name: str = ""
    graph: object | None = None
    partition: np.ndarray | None = None
    n_parts: int | None = None
    traffic: object | None = None
    wg: np.ndarray | None = None
    table: object | None = None
    syn: object | None = None
    mesh_shape: tuple[int, int] | None = None
    gmask: np.ndarray | None = None
    schedule: list | None = None
    ragged_plan: object | None = None
    topology: object | None = None
    dead: list | None = None
    down_links: list | None = None
    pod_of: np.ndarray | None = None
    shard_flows: np.ndarray | None = None
    balance_slack: float = 0.05
    waste_threshold: float = 0.5
    bottleneck_threshold: float | None = None

    @property
    def n_groups(self) -> int | None:
        """Group count, from whichever artifact defines it."""
        if self.table is not None:
            return int(self.table.n_groups)
        if self.mesh_shape is not None:
            return int(self.mesh_shape[0])
        if self.gmask is not None:
            return int(self.gmask.shape[0])
        if self.ragged_plan is not None:
            return int(self.ragged_plan.mesh_shape[0])
        return None

    @classmethod
    def from_table(
        cls,
        table,
        *,
        name: str = "",
        wg: np.ndarray | None = None,
        topology=None,
        dead=None,
        **kw,
    ) -> "PlanContext":
        """Context for a routing table: derives the group-pooled consumer
        mask (:func:`~repro_torch.core.routing.needed_sources` +
        :func:`~repro_torch.core.routing.pool_block_mask`) and the sparse
        ppermute schedule the engine would execute from it.  P2P tables
        (G = N) skip the derivation — every pair is direct."""
        from repro_torch.core.routing import needed_sources, pool_block_mask
        from repro_torch.snn.sparse import exchange_schedule

        gmask = schedule = mesh_shape = None
        traffic = table.device_traffic
        if not hasattr(traffic, "rows"):  # dense parity-oracle table
            traffic = None
        if table.bridge.size:
            gmask = pool_block_mask(
                needed_sources(table), table.group_of, table.n_groups
            )
            schedule = exchange_schedule(gmask)
            counts = np.bincount(table.group_of, minlength=table.n_groups)
            if counts.size and counts.max() == counts.min():
                mesh_shape = (table.n_groups, int(counts[0]))
        return cls(
            name=name,
            traffic=traffic,
            wg=wg,
            table=table,
            mesh_shape=mesh_shape,
            gmask=gmask,
            schedule=schedule,
            topology=topology,
            dead=dead,
            **kw,
        )

    @classmethod
    def from_synapses(
        cls,
        syn,
        mesh_shape: tuple[int, int],
        *,
        name: str = "",
        plan=None,
        topology=None,
        **kw,
    ) -> "PlanContext":
        """Context for block-CSR synapse tiles on a ``(G, R)`` mesh,
        optionally with the ragged plan that executes them."""
        from repro_torch.core.routing import pool_block_mask
        from repro_torch.snn.sparse import exchange_schedule

        g, r = int(mesh_shape[0]), int(mesh_shape[1])
        if syn.n_blocks != g * r:
            raise ValueError(
                f"syn has {syn.n_blocks} blocks for a ({g}, {r}) mesh"
            )
        group_of = np.arange(g * r, dtype=np.int64) // r
        gmask = pool_block_mask(syn.mask(), group_of, g)
        return cls(
            name=name,
            syn=syn,
            mesh_shape=(g, r),
            gmask=gmask,
            schedule=exchange_schedule(gmask),
            ragged_plan=plan,
            topology=topology,
            **kw,
        )
