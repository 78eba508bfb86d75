"""Interconnect topologies for the discrete-event simulator.

A :class:`Topology` is a directed link graph over ``n_devices`` device
NICs plus switch nodes, with a deterministic route for every ordered
device pair.  Each :class:`Link` carries an α–β cost model — ``alpha``
seconds of fixed per-message latency and ``beta`` seconds per byte
(1 / bandwidth); congestion is *not* a link parameter but emerges in
:mod:`repro_torch.netsim.simulate` from FIFO serialization on shared links.

Four constructors cover the evaluation surface of the paper and ROADMAP:

* :func:`single_switch` — every NIC on one crossbar; the only shared
  resources are the per-device up/down links, so latency is governed by
  per-NIC serialization (the closed-form model's regime).
* :func:`two_tier`     — pods of ``pod_size`` devices behind leaf
  switches joined by ONE oversubscribed spine: the paper's pod/DCN
  machine shape, where the leaf↔spine links are the congestion point
  every cross-group byte must pay for.
* :func:`ring`         — devices in a ring, store-and-forward through
  intermediate NICs; multi-hop distance matters.
* :func:`fat_tree`     — pods of leaves joined by ``n_spines`` parallel
  spines with deterministic ECMP (hash of the device pair): the
  non-blocking contrast to :func:`two_tier`.

``topology_from_config`` builds any of them from a plain dict (the
schema documented in README "Simulating the interconnect"), so
benchmark configs and what-if sweeps stay declarative.

Node ids: devices are ``0 .. n_devices-1``; switches are appended after.
All constructions and routes are pure numpy/python — no jax — so the
module is importable from launchers before jax initializes devices.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "Link",
    "Topology",
    "single_switch",
    "two_tier",
    "ring",
    "fat_tree",
    "topology_from_config",
    "DEFAULT_LINK_BW",
    "DEFAULT_ALPHA",
]

# 100 Gb/s InfiniBand EDR per device port — matches ClusterModel.bw_link.
DEFAULT_LINK_BW = 12.5e9
# Per-hop fixed latency (switch traversal + wire), seconds.
DEFAULT_ALPHA = 1.0e-6


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed link.

    Attributes:
      src: source node id (device NIC or switch).
      dst: destination node id.
      alpha: fixed per-message traversal latency, seconds.
      beta: serialization cost, seconds per byte (1 / bandwidth).
      kind: role tag ('nic_up' | 'nic_down' | 'leaf_up' | 'leaf_down' |
        'ring_cw' | 'ring_ccw') — used for per-tier utilization reports.
    """

    src: int
    dst: int
    alpha: float
    beta: float
    kind: str


@dataclasses.dataclass(frozen=True)
class Topology:
    """A named link graph with deterministic per-device-pair routes.

    ``params`` holds the constructor-specific routing tables (plain ints and
    tuples); :meth:`route` dispatches on ``kind``.  Instances are cheap
    and immutable — build one per scenario.
    """

    name: str
    kind: str
    n_devices: int
    links: tuple[Link, ...]
    params: dict

    @property
    def n_links(self) -> int:
        return len(self.links)

    def route(self, src: int, dst: int) -> tuple[int, ...]:
        """Link ids traversed by a ``src → dst`` device message, in
        order.  ``src == dst`` is local delivery: the empty route."""
        n = self.n_devices
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"device pair ({src}, {dst}) outside [0, {n})")
        if src == dst:
            return ()
        p = self.params
        if self.kind == "single_switch":
            return (p["up"][src], p["down"][dst])
        if self.kind == "two_tier":
            ps, pd = src // p["pod_size"], dst // p["pod_size"]
            if ps == pd:
                return (p["up"][src], p["down"][dst])
            return (
                p["up"][src],
                p["leaf_up"][ps],
                p["leaf_down"][pd],
                p["down"][dst],
            )
        if self.kind == "fat_tree":
            ps, pd = src // p["pod_size"], dst // p["pod_size"]
            if ps == pd:
                return (p["up"][src], p["down"][dst])
            s = (src + dst) % p["n_spines"]  # deterministic ECMP
            return (
                p["up"][src],
                p["leaf_up"][ps][s],
                p["leaf_down"][pd][s],
                p["down"][dst],
            )
        if self.kind == "ring":
            fwd = (dst - src) % n
            if fwd <= n - fwd:  # clockwise (ties break clockwise)
                return tuple(p["cw"][(src + k) % n] for k in range(fwd))
            return tuple(p["ccw"][(src - k) % n] for k in range(n - fwd))
        raise ValueError(f"unknown topology kind {self.kind!r}")

    def route_avoiding(
        self, src: int, dst: int, avoid
    ) -> tuple[int, ...] | None:
        """The precomputed backup route for ``src → dst`` that skips the
        ``avoid`` link ids (a downed-link set), or ``None`` when every
        route is blocked.

        The primary :meth:`route` is returned unchanged when it is
        already disjoint from ``avoid``.  Alternatives exist exactly
        where the fabric has path diversity: a :func:`fat_tree` cross-pod
        pair can re-hash onto any surviving spine, a :func:`ring` pair
        can take the other arc; :func:`single_switch`, :func:`two_tier`,
        and intra-pod pairs have a single physical path, so a downed
        link there means *stall until up* (the simulator's fallback).
        """
        avoid = frozenset(avoid)
        primary = self.route(src, dst)
        if not avoid.intersection(primary):
            return primary
        p = self.params
        if self.kind == "fat_tree":
            ps, pd = src // p["pod_size"], dst // p["pod_size"]
            if ps != pd:
                s0 = (src + dst) % p["n_spines"]
                for k in range(1, p["n_spines"]):
                    s = (s0 + k) % p["n_spines"]
                    alt = (
                        p["up"][src],
                        p["leaf_up"][ps][s],
                        p["leaf_down"][pd][s],
                        p["down"][dst],
                    )
                    if not avoid.intersection(alt):
                        return alt
            return None
        if self.kind == "ring":
            n = self.n_devices
            fwd = (dst - src) % n
            if fwd <= n - fwd:  # primary was clockwise: try the other arc
                alt = tuple(p["ccw"][(src - k) % n] for k in range(n - fwd))
            else:
                alt = tuple(p["cw"][(src + k) % n] for k in range(fwd))
            return alt if not avoid.intersection(alt) else None
        return None  # single_switch / two_tier: one physical path

    def device_egress_links(self) -> list[tuple[int, ...]]:
        """Per device, the link ids on which its messages *depart* —
        the NIC serialization points the latency model's per-device
        egress terms correspond to."""
        p = self.params
        if self.kind == "ring":
            return [(p["cw"][d], p["ccw"][d]) for d in range(self.n_devices)]
        return [(p["up"][d],) for d in range(self.n_devices)]


def _nic_links(
    n_devices: int, switch_of: list[int], alpha: float, beta: float
) -> tuple[list[Link], list[int], list[int]]:
    """Up/down link pairs between each device and its switch."""
    links: list[Link] = []
    up: list[int] = []
    down: list[int] = []
    for d in range(n_devices):
        up.append(len(links))
        links.append(Link(d, switch_of[d], alpha, beta, "nic_up"))
        down.append(len(links))
        links.append(Link(switch_of[d], d, alpha, beta, "nic_down"))
    return links, up, down


def single_switch(
    n_devices: int,
    *,
    link_bw: float = DEFAULT_LINK_BW,
    alpha: float = DEFAULT_ALPHA,
    name: str | None = None,
) -> Topology:
    """All NICs on one non-blocking crossbar."""
    if n_devices < 1:
        raise ValueError("need at least one device")
    beta = 1.0 / link_bw
    sw = n_devices
    links, up, down = _nic_links(n_devices, [sw] * n_devices, alpha, beta)
    return Topology(
        name=name or f"single_switch({n_devices})",
        kind="single_switch",
        n_devices=n_devices,
        links=tuple(links),
        params={"up": up, "down": down},
    )


def two_tier(
    n_devices: int,
    pod_size: int,
    *,
    link_bw: float = DEFAULT_LINK_BW,
    dcn_oversub: float = 4.0,
    alpha: float = DEFAULT_ALPHA,
    name: str | None = None,
) -> Topology:
    """Pods behind leaf switches, one shared spine (the paper's DCN).

    Each leaf's uplink aggregates ``pod_size`` NICs at
    ``pod_size · link_bw / dcn_oversub`` — ``dcn_oversub > 1`` makes the
    pod boundary the bottleneck, which is exactly the regime in which
    the paper's bridge aggregation pays off.
    """
    if n_devices % pod_size:
        raise ValueError(f"pod_size {pod_size} must divide {n_devices}")
    n_pods = n_devices // pod_size
    beta = 1.0 / link_bw
    beta_dcn = dcn_oversub / (pod_size * link_bw)
    leaf_of = [n_devices + d // pod_size for d in range(n_devices)]
    links, up, down = _nic_links(n_devices, leaf_of, alpha, beta)
    spine = n_devices + n_pods
    leaf_up: list[int] = []
    leaf_down: list[int] = []
    for pd in range(n_pods):
        leaf = n_devices + pd
        leaf_up.append(len(links))
        links.append(Link(leaf, spine, alpha, beta_dcn, "leaf_up"))
        leaf_down.append(len(links))
        links.append(Link(spine, leaf, alpha, beta_dcn, "leaf_down"))
    return Topology(
        name=name or f"two_tier({n_devices}, pods of {pod_size})",
        kind="two_tier",
        n_devices=n_devices,
        links=tuple(links),
        params={
            "up": up,
            "down": down,
            "leaf_up": leaf_up,
            "leaf_down": leaf_down,
            "pod_size": pod_size,
        },
    )


def ring(
    n_devices: int,
    *,
    link_bw: float = DEFAULT_LINK_BW,
    alpha: float = DEFAULT_ALPHA,
    name: str | None = None,
) -> Topology:
    """Bidirectional device ring; messages store-and-forward through
    intermediate NICs along the shorter arc (ties go clockwise)."""
    if n_devices < 2:
        raise ValueError("a ring needs at least two devices")
    beta = 1.0 / link_bw
    links: list[Link] = []
    cw: list[int] = []
    ccw: list[int] = []
    for d in range(n_devices):
        cw.append(len(links))
        links.append(Link(d, (d + 1) % n_devices, alpha, beta, "ring_cw"))
        ccw.append(len(links))
        links.append(Link(d, (d - 1) % n_devices, alpha, beta, "ring_ccw"))
    return Topology(
        name=name or f"ring({n_devices})",
        kind="ring",
        n_devices=n_devices,
        links=tuple(links),
        params={"cw": cw, "ccw": ccw},
    )


def fat_tree(
    n_devices: int,
    pod_size: int,
    *,
    n_spines: int | None = None,
    link_bw: float = DEFAULT_LINK_BW,
    alpha: float = DEFAULT_ALPHA,
    name: str | None = None,
) -> Topology:
    """Two-tier Clos with ``n_spines`` parallel spines and deterministic
    ECMP — full bisection at ``n_spines = pod_size`` (the default)."""
    if n_devices % pod_size:
        raise ValueError(f"pod_size {pod_size} must divide {n_devices}")
    n_pods = n_devices // pod_size
    n_spines = n_spines or pod_size
    if n_spines < 1:
        raise ValueError("need at least one spine")
    beta = 1.0 / link_bw
    leaf_of = [n_devices + d // pod_size for d in range(n_devices)]
    links, up, down = _nic_links(n_devices, leaf_of, alpha, beta)
    leaf_up: list[list[int]] = []
    leaf_down: list[list[int]] = []
    for pd in range(n_pods):
        leaf = n_devices + pd
        ups: list[int] = []
        downs: list[int] = []
        for s in range(n_spines):
            spine = n_devices + n_pods + s
            ups.append(len(links))
            links.append(Link(leaf, spine, alpha, beta, "leaf_up"))
            downs.append(len(links))
            links.append(Link(spine, leaf, alpha, beta, "leaf_down"))
        leaf_up.append(ups)
        leaf_down.append(downs)
    return Topology(
        name=name or f"fat_tree({n_devices}, pods of {pod_size}, {n_spines} spines)",
        kind="fat_tree",
        n_devices=n_devices,
        links=tuple(links),
        params={
            "up": up,
            "down": down,
            "leaf_up": leaf_up,
            "leaf_down": leaf_down,
            "pod_size": pod_size,
            "n_spines": n_spines,
        },
    )


_BUILDERS = {
    "single_switch": single_switch,
    "two_tier": two_tier,
    "ring": ring,
    "fat_tree": fat_tree,
}


def topology_from_config(cfg: dict) -> Topology:
    """Build a topology from a plain-dict config.

    Schema: ``{"kind": <constructor name>, "n_devices": int, ...}`` with the
    remaining keys passed through to the constructor (``pod_size`` is
    positional-required for ``two_tier``/``fat_tree``; ``link_bw``,
    ``alpha``, ``dcn_oversub``, ``n_spines``, ``name`` are optional).
    See README "Simulating the interconnect" for worked examples.
    """
    cfg = dict(cfg)
    kind = cfg.pop("kind", None)
    if kind not in _BUILDERS:
        raise ValueError(f"unknown topology kind {kind!r} (have {sorted(_BUILDERS)})")
    n_devices = cfg.pop("n_devices")
    if kind in ("two_tier", "fat_tree"):
        pod_size = cfg.pop("pod_size")
        return _BUILDERS[kind](n_devices, pod_size, **cfg)
    return _BUILDERS[kind](n_devices, **cfg)
