"""Roofline layer: per-chip counts of one step by dispatch + the 3-term model.

The counter itself is ``repro_torch.roofline.count.count`` (the function is
not re-exported here, where its name would hide its module's)."""
from repro_torch.roofline.analysis import H100, HW, V5E, RooflineReport, model_flops, roofline
from repro_torch.roofline.count import Totals, top_collectives

__all__ = [
    "HW", "V5E", "H100", "RooflineReport", "model_flops", "roofline",
    "Totals", "top_collectives",
]
