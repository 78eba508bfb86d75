"""Analytic latency model for the paper's Table II.

The paper measures end-to-end simulation step latency on the Kunlun
supercomputer.  We cannot measure InfiniBand congestion on CPU, so — as
recorded in DESIGN.md §9 — Table II is reproduced with an α-β-congestion
model whose constants are calibrated to the paper's reported cluster
behaviour.  The *inputs* to the model (per-device traffic, connection
counts, bridge loads) come from running the real algorithms on the real
generated graph; only the translation traffic→seconds is analytic.

Model
-----
A simulation step costs::

  T_step = T_compute + T_comm
  T_comm = max_d [ conn(d) · α_conn                    (connection setup:
                                                        one host thread per
                                                        logical connection)
                 + egress(d) / bw_eff(d) ]             (serialization)
  bw_eff(d) = bw_link / (1 + γ · congestion(d))        (congestion collapse)

``congestion(d)`` counts how many *other* flows contend for the links the
device's traffic traverses — with unbalanced traffic and thousands of
simultaneous P2P connections the effective bandwidth collapses, which is
how 1,552-connection random/GA runs take hours while the two-level
schedule takes fractions of a second (Table II rows 1–3).

Channel noise (the paper's complexity knob, 0.1–0.6) raises firing rates
and hence both compute and traffic; we model it as a multiplier
``1 + κ·noise`` on both terms, reproducing Table II's monotone growth.

Two backends, one API
---------------------
:func:`estimate` is the entry point Table-II/Fig-3b consumers call:

* ``model='closed_form'`` — the α-β-congestion formulas in this module
  (:func:`step_latency`), cheap enough for sweeps at any scale.
* ``model='netsim'`` — the discrete-event interconnect simulator
  (:mod:`repro_torch.netsim`): the table's forwarding schedule is replayed
  message by message over an explicit topology, so congestion comes
  from simulated FIFO queueing on shared links instead of the fitted
  ``γ`` term.  Pass ``topology=`` (default: a single switch over the
  table's devices) and the same ``cluster`` constants — ``alpha_conn``
  becomes the per-message injection cost, ``bytes_per_traffic_unit``
  scales flows to wire bytes.

Both return the same :class:`LatencyBreakdown`, so benchmarks flip
between them with a flag.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.routing import (
    RoutingTable,
    connection_counts,
    level1_egress,
    level2_egress,
)

__all__ = [
    "ClusterModel",
    "LatencyBreakdown",
    "estimate",
    "step_latency",
    "table2_row",
]


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """Constants calibrated to the paper's cluster (Kunlun, IB + PCIe).

    Attributes:
      alpha_conn: per-logical-connection setup cost (thread launch + QP
        handshake), seconds.  The paper attributes large overheads to the
        one-thread-per-connection model.
      bw_link: per-device egress bandwidth, bytes/second.
      gamma: congestion sensitivity — how fast effective bandwidth
        collapses as contending flows accumulate.
      kappa: channel-noise traffic/compute multiplier.
      t_compute0: base per-step compute time at noise 0, seconds.
      bytes_per_traffic_unit: converts abstract traffic units
        (``P·W_i·W_j``) into wire bytes.
    """

    alpha_conn: float = 2.0e-4
    bw_link: float = 12.5e9  # 100 Gb/s IB EDR per device
    gamma: float = 8.0e-3
    kappa: float = 1.1
    t_compute0: float = 0.04
    bytes_per_traffic_unit: float = 1.0

    def with_noise(self, noise: float) -> "ClusterModel":
        return self


@dataclasses.dataclass(frozen=True)
class LatencyBreakdown:
    t_total: float
    t_compute: float
    t_conn: float
    t_serial: float
    worst_device: int


def _congestion_per_device(tb: RoutingTable) -> np.ndarray:
    """Contending-flow count seen by each device's egress path.

    P2P: every simultaneous connection in the system shares the fabric;
    a device's flows contend with the *fan-in* at their destinations.
    Two-level: only same-group flows plus the aggregated bridge flows
    contend on the relevant links.

    Fully vectorized over the sparse traffic entries (O(nnz) + O(nnz(G²))
    for the bridge term); dense tables are converted on entry.
    """
    from repro_torch.core.traffic import TrafficMatrix

    tm = tb.device_traffic
    if not isinstance(tm, TrafficMatrix):
        tm = TrafficMatrix.from_dense(tm)
    n = tb.n_devices
    rows, cols = tm.rows(), tm.indices  # every stored entry is active (> 0)
    if tb.method == "p2p":
        # fan-in congestion: flows arriving at each of my destinations
        fan_in = np.bincount(cols, minlength=n).astype(np.float64)
        return (
            np.bincount(rows, weights=fan_in[cols], minlength=n)
            - np.bincount(rows, minlength=n)  # others, not me
        )
    # two-level: destinations are same-group peers + served bridges
    intra = tb.group_of[rows] == tb.group_of[cols]
    r_i, c_i = rows[intra], cols[intra]
    fan_in = np.bincount(c_i, minlength=n).astype(np.float64)
    cong = np.bincount(r_i, weights=fan_in[c_i], minlength=n) - np.bincount(
        r_i, minlength=n
    )
    # bridges contend with other bridges targeting the same group: one
    # aggregated flow per source group arriving at gd, charged to *every*
    # bridge carrying a share of the flow (split flows contend too)
    from repro_torch.core.routing import _share_coo_or_primary, group_pair_traffic

    gpt = group_pair_traffic(tb)
    incoming = (gpt > 0).sum(axis=0)
    sdev, sgrp, _ = _share_coo_or_primary(tb)
    served = gpt[tb.group_of[sdev], sgrp] > 0
    np.add.at(
        cong,
        sdev[served],
        np.maximum(0, incoming[sgrp[served]] - 1).astype(np.float64),
    )
    return cong


def step_latency(
    tb: RoutingTable,
    cluster: ClusterModel = ClusterModel(),
    *,
    noise: float = 0.1,
) -> LatencyBreakdown:
    """Latency of one simulation step under routing table ``tb``."""
    noise_mult = 1.0 + cluster.kappa * noise
    conn = connection_counts(tb)
    egress = (level1_egress(tb) + level2_egress(tb)) * noise_mult
    egress_bytes = egress * cluster.bytes_per_traffic_unit
    cong = _congestion_per_device(tb)
    bw_eff = cluster.bw_link / (1.0 + cluster.gamma * cong)
    t_conn = conn * cluster.alpha_conn
    t_serial = egress_bytes / bw_eff
    t_comm = t_conn + t_serial
    worst = int(np.argmax(t_comm))
    t_compute = cluster.t_compute0 * noise_mult
    return LatencyBreakdown(
        t_total=float(t_compute + t_comm[worst]),
        t_compute=float(t_compute),
        t_conn=float(t_conn[worst]),
        t_serial=float(t_serial[worst]),
        worst_device=worst,
    )


def _netsim_latency(
    tb: RoutingTable,
    cluster: ClusterModel,
    *,
    noise: float,
    topology=None,
) -> LatencyBreakdown:
    """Discrete-event backend: replay the table's forwarding schedule.

    Lazy-imports :mod:`repro_torch.netsim` (keeps the closed-form path free of
    the dependency).  The cluster constants map onto the simulator:
    ``alpha_conn`` is charged per message at injection (the host-side
    connection cost that sinks P2P in Table II), traffic units scale to
    wire bytes by ``bytes_per_traffic_unit`` times the noise multiplier.
    """
    from repro_torch import netsim

    topo = topology or netsim.single_switch(tb.n_devices, link_bw=cluster.bw_link)
    if topo.n_devices != tb.n_devices:
        raise ValueError(f"topology has {topo.n_devices} devices, table {tb.n_devices}")
    noise_mult = 1.0 + cluster.kappa * noise
    rounds = netsim.table_rounds(tb, bytes_per_unit=cluster.bytes_per_traffic_unit * noise_mult)
    # forwarding stages truly depend on each other (bridges aggregate
    # only after level-1 delivers) — simulate with barriers
    res = netsim.simulate(rounds, topo, alpha_msg=cluster.alpha_conn, barriers=True)
    res.assert_conserved()
    t_compute = cluster.t_compute0 * noise_mult
    return LatencyBreakdown(
        t_total=float(t_compute + res.t_total),
        t_compute=float(t_compute),
        t_conn=0.0,  # folded into the simulated per-message injection cost
        t_serial=float(res.t_total),
        worst_device=res.worst_device(),
    )


def estimate(
    tb: RoutingTable,
    cluster: ClusterModel = ClusterModel(),
    *,
    model: str = "closed_form",
    noise: float = 0.1,
    topology=None,
) -> LatencyBreakdown:
    """Step-latency estimate under routing table ``tb``, either backend.

    The two backends answer different questions (see
    ``docs/PAPER_MAPPING.md``): ``'closed_form'`` includes the
    per-connection host cost (``alpha_conn``) and the superlinear
    congestion term — the regime where the paper's P2P rows collapse —
    while ``'netsim'`` is a wire-level floor under which P2P is merely
    worse, not catastrophic.

    Args:
      cluster: :class:`ClusterModel` constants (link bandwidth,
        per-connection setup cost, congestion coefficients, unit scale).
      model: ``'closed_form'`` (this module's α-β-congestion formulas)
        or ``'netsim'`` (discrete-event replay over ``topology`` —
        :mod:`repro_torch.netsim`).
      noise: channel-noise level ``z`` of Table II — scales spike (and
        hence wire) volume.
      topology: netsim only — a :class:`repro_torch.netsim.Topology` over the
        table's devices; defaults to a single switch at the cluster's
        link bandwidth.

    Returns:
      :class:`LatencyBreakdown` — per-term seconds plus ``t_total``.
    """
    if model == "closed_form":
        return step_latency(tb, cluster, noise=noise)
    if model == "netsim":
        return _netsim_latency(tb, cluster, noise=noise, topology=topology)
    raise ValueError(f"unknown latency model {model!r}")


def table2_row(
    tb: RoutingTable,
    cluster: ClusterModel = ClusterModel(),
    noises: tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6),
    *,
    model: str = "closed_form",
    topology=None,
) -> list[float]:
    """One row of Table II: step latency across channel-noise levels,
    under either latency backend (see :func:`estimate`)."""
    return [
        estimate(tb, cluster, model=model, noise=z, topology=topology).t_total
        for z in noises
    ]
