"""netsim — a discrete-event interconnect simulator that replays the
repo's real exchange schedules.

Hardware-free CI can gate *bytes*; the paper's claim is *latency*.
This package closes that gap with a link-level α–β–congestion simulator
(:mod:`~repro_torch.netsim.simulate`) over configurable topologies
(:mod:`~repro_torch.netsim.topology`) whose inputs are the actual executed
artifacts the rest of the repo produces — masked ``ppermute`` rounds,
:class:`~repro_torch.snn.ragged.RaggedPlan` bridge schedules, Algorithm-2
routing tables (:mod:`~repro_torch.netsim.adapters`) — and a what-if harness
for schedules nobody has implemented yet (:mod:`~repro_torch.netsim.whatif`).

Pure numpy/python — no jax — so it imports anywhere, including
launchers that must not initialize devices.
"""
from repro_torch.netsim.adapters import (
    a2a_rounds,
    flat_rounds,
    ragged_rounds,
    rounds_from_triples,
    sparse_rounds,
    table_rounds,
    total_bytes,
)
from repro_torch.netsim.events import Delivery, EventQueue, Message, Transmission
from repro_torch.netsim.simulate import LinkOutage, SimResult, simulate
from repro_torch.netsim.topology import (
    DEFAULT_ALPHA,
    DEFAULT_LINK_BW,
    Link,
    Topology,
    fat_tree,
    ring,
    single_switch,
    topology_from_config,
    two_tier,
)
from repro_torch.netsim.shards import aggregated_table_rounds, p2p_rounds, sharded_rounds
from repro_torch.netsim.whatif import payload_sharding_whatif, sharded_ragged_rounds

__all__ = [
    "Message",
    "Delivery",
    "Transmission",
    "EventQueue",
    "SimResult",
    "simulate",
    "LinkOutage",
    "Link",
    "Topology",
    "single_switch",
    "two_tier",
    "ring",
    "fat_tree",
    "topology_from_config",
    "DEFAULT_LINK_BW",
    "DEFAULT_ALPHA",
    "rounds_from_triples",
    "sparse_rounds",
    "flat_rounds",
    "ragged_rounds",
    "table_rounds",
    "a2a_rounds",
    "sharded_rounds",
    "aggregated_table_rounds",
    "p2p_rounds",
    "total_bytes",
    "sharded_ragged_rounds",
    "payload_sharding_whatif",
]
