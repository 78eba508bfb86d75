"""What-if harness: simulate proposed schedules *before* implementing
them.

The ROADMAP logs "ragged payload sharding" as an open item: bridge
compaction sends each packed ``K_r``-lane payload from ONE device per
group, so for very wide payloads the bridge NIC becomes a serial
bottleneck.  A ``psum_scatter``-style variant would shard each payload
across the ``R`` inner positions — member ``i`` of the sending group
bridges lanes ``[i·K/R, (i+1)·K/R)`` straight to member ``i`` of the
receiving group — trading one extra fast-axis gather for ``R×``
slow-axis parallelism.

Nobody has to build that executor to know whether it pays:
:func:`sharded_ragged_rounds` emits the wire schedule the variant
*would* execute, and :func:`payload_sharding_whatif` replays both
schedules over a set of topologies and reports the verdict (recorded in
ROADMAP).  The expected shape: big wins where the bridge NIC is the
bottleneck (single switch, fat tree), muted wins where every shard
still funnels through one oversubscribed pod uplink (two-tier DCN).
"""
from __future__ import annotations

from repro_torch.netsim.adapters import ragged_rounds, total_bytes
from repro_torch.netsim.events import Message
from repro_torch.netsim.simulate import simulate
from repro_torch.netsim.topology import Topology

__all__ = ["sharded_ragged_rounds", "payload_sharding_whatif"]


def sharded_ragged_rounds(plan, *, n_shards: int | None = None) -> list[list[Message]]:
    """The wire schedule of the proposed ``psum_scatter``-style sharded
    ragged exchange.

    Each scheduled pair's padded ``K_r``-lane payload is split into
    ``min(n_shards, R)`` equal shards of ``ceil(K_r / shards)`` lanes
    (static shapes pad the last shard up, mirroring how the real ragged
    executor pads to ``K_r``); shard ``i`` travels from inner position
    ``i`` of the sending group to inner position ``i`` of the receiving
    group.  With ``R = 1`` (or ``n_shards = 1``) this degenerates to the
    executed ragged schedule exactly.
    """
    g, r = plan.mesh_shape
    shards = r if n_shards is None else max(1, min(int(n_shards), r))
    rounds: list[list[Message]] = []
    for rnd_idx, rnd in enumerate(plan.rounds):
        msgs: list[Message] = []
        if rnd.pairs:
            lanes = -(-rnd.width // shards)  # ceil: padded equal shards
            for gs, gd in rnd.pairs:
                for i in range(shards):
                    msgs.append(
                        Message(
                            gs * r + i,
                            gd * r + i,
                            lanes * 4,
                            round=rnd_idx,
                            tag="ragged_sharded",
                        )
                    )
        rounds.append(msgs)
    return rounds


def _scale_bytes(rounds: list[list[Message]], scale: float) -> list[list[Message]]:
    if scale == 1.0:
        return rounds
    return [
        [
            Message(m.src, m.dst, max(int(m.nbytes * scale), 1), m.round, m.tag)
            for m in rnd
        ]
        for rnd in rounds
    ]


def payload_sharding_whatif(
    plan,
    topologies: dict[str, Topology],
    *,
    n_shards: int | None = None,
    alpha_msg: float = 0.0,
    byte_scale: float = 1.0,
) -> dict[str, dict[str, float]]:
    """Replay executed-ragged vs sharded-ragged over ``topologies``.

    ``byte_scale`` multiplies every payload, probing the ROADMAP's
    actual concern — *very wide* payloads (equivalently, large block
    sizes ``B``) — without regenerating a model: sharding trades ``R×``
    more messages (an α cost) for ``R×`` NIC parallelism (a β win), so
    the verdict flips with the payload/α ratio.

    Returns per topology name ``{"ragged_s", "sharded_s", "speedup",
    "ragged_bytes", "sharded_bytes"}`` — ``speedup > 1`` means sharding
    the payload would cut the simulated critical path on that fabric.
    """
    base = _scale_bytes(ragged_rounds(plan), byte_scale)
    sharded = _scale_bytes(sharded_ragged_rounds(plan, n_shards=n_shards), byte_scale)
    out: dict[str, dict[str, float]] = {}
    for name, topo in topologies.items():
        r0 = simulate(base, topo, alpha_msg=alpha_msg)
        r1 = simulate(sharded, topo, alpha_msg=alpha_msg)
        r0.assert_conserved()
        r1.assert_conserved()
        out[name] = {
            "ragged_s": r0.t_total,
            "sharded_s": r1.t_total,
            "speedup": r0.t_total / r1.t_total if r1.t_total > 0 else 1.0,
            "ragged_bytes": float(total_bytes(base)),
            "sharded_bytes": float(total_bytes(sharded)),
        }
    return out
