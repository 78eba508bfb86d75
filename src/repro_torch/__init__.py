"""PyTorch/CUDA port of the brain-simulation system (``repro``).

Mirrors ``src/repro``'s layout and names.  Imports ``torch`` and never
``jax`` or ``repro``: each numpy module the port needs is copied here.
Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; see :mod:`repro_torch.device`.
"""
from repro_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
