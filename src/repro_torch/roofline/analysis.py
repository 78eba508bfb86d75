"""Three-term roofline from a counted step.

Port of ``repro/roofline/analysis.py``; its classes and functions are copies
(pinned by ``tests/test_torch_copies.py``), fed by the port's dispatch
count (:mod:`repro_torch.roofline.count`) where the reference reads HLO.

Terms (all per-chip, seconds):

    compute    = FLOPs / peak_FLOP/s
    memory     = HBM bytes / HBM bandwidth
    collective = collective ring bytes / link bandwidth

The counts are rank 0's local work, so they are already per chip; the
largest term is the bottleneck.  ``model_flops`` is the 6·N·D (train) /
2·N·D (inference) useful-work convention (N = active params), whose ratio
against the counted FLOPs exposes recompute and masking waste.
Cross-pod traffic is also charged against the (slower) bandwidth across
the pod boundary.

:data:`V5E` is the reference's TPU v5e, kept as the constant the copy is
pinned with; :data:`H100` is the card the port runs on.
"""
from __future__ import annotations

import dataclasses

# the reference's name for the totals, so that the copied code stays equal
from repro_torch.roofline.count import Totals as HloTotals

__all__ = ["HW", "V5E", "H100", "RooflineReport", "roofline", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float  # bf16 FLOP/s per chip
    hbm_bw: float  # bytes/s per chip
    ici_bw: float  # bytes/s per link
    dci_bw: float  # bytes/s per chip across the pod boundary
    hbm_per_chip: float = 16e9


V5E = HW(name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9, dci_bw=12.5e9)

#: NVIDIA H100 SXM: dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 at 450
#: GB/s each way, 80 GB.  ``dci_bw`` assumes one 400 Gb/s NIC per card
#: (50 GB/s) for traffic that leaves the pod: an assumption of this
#: constant, not a measurement.
H100 = HW(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9, dci_bw=50e9,
          hbm_per_chip=80e9)


@dataclasses.dataclass
class RooflineReport:
    compute_s: float
    memory_s: float
    collective_s: float
    cross_pod_s: float
    dominant: str
    bound_s: float
    model_flops_per_chip: float
    useful_ratio: float  # model flops / HLO flops
    roofline_fraction: float  # compute_s / bound_s (1.0 = compute-bound at peak)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(
    active_params: int, tokens: int, kind: str
) -> float:
    """6·N·D for training, 2·N·D for inference forward passes."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_params * tokens


def roofline(
    totals: HloTotals,
    *,
    n_devices: int,
    model_flops_global: float,
    hw: HW = V5E,
) -> RooflineReport:
    compute_s = totals.flops / hw.peak_flops
    memory_s = totals.hbm_bytes / hw.hbm_bw
    collective_s = totals.coll_ring_bytes / hw.ici_bw
    cross_pod_s = totals.cross_pod_bytes / hw.dci_bw
    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": max(collective_s, cross_pod_s),
    }
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    mf = model_flops_global / n_devices
    return RooflineReport(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        cross_pod_s=cross_pod_s,
        dominant=dominant,
        bound_s=bound_s,
        model_flops_per_chip=mf,
        useful_ratio=mf / totals.flops if totals.flops else 0.0,
        roofline_fraction=(mf / hw.peak_flops) / bound_s if bound_s else 0.0,
    )
