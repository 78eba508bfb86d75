"""Kernel layer of the port: the spike-accumulation kernels
(``csrc/spike_accum.cu``) and the attention kernels (``csrc/attention.cu``)
written for Hopper, their plain PyTorch versions, and the device dispatch
between them (:mod:`repro_torch.kernels.ops`; its ``attention`` and
``decode_attention`` are not re-exported here, where the names are the
kernel modules')."""
from repro_torch.kernels._build import LAUNCHES, reset_launches
from repro_torch.kernels.ops import spike_currents, spike_currents_blocks

__all__ = ["LAUNCHES", "reset_launches", "spike_currents", "spike_currents_blocks"]
