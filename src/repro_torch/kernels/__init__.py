"""Kernel layer of the port: the spike-accumulation kernels
(``csrc/spike_accum.cu``), the attention kernels (``csrc/attention.cu``) and
the sequence scans (``csrc/scan.cu``) written for Hopper, their plain
PyTorch versions, and the device dispatch between them
(:mod:`repro_torch.kernels.ops`; its model-zoo entries are not re-exported
here, where ``attention`` is a kernel module's name)."""
from repro_torch.kernels._build import LAUNCHES, reset_launches
from repro_torch.kernels.ops import spike_currents, spike_currents_blocks

__all__ = ["LAUNCHES", "reset_launches", "spike_currents", "spike_currents_blocks"]
