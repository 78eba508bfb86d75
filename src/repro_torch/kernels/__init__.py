"""Kernel layer of the port: the two spike-accumulation kernels written
for Hopper (``csrc/spike_accum.cu``), their plain PyTorch versions, and the
device dispatch between them."""
from repro_torch.kernels.ops import spike_currents, spike_currents_blocks
from repro_torch.kernels.spike_accum import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches", "spike_currents", "spike_currents_blocks"]
