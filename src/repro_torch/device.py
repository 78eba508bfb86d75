"""The port's default-device rule.

Every entry point of :mod:`repro_torch` takes an explicit ``device`` and
defaults to ``"cuda"``.  :func:`resolve_device` turns that argument into
a :class:`torch.device`: when CUDA is absent and the caller did not ask
for the CPU, it raises — the port never moves to the CPU on its own.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means :data:`DEFAULT_DEVICE` (``"cuda"``).  A CUDA device is
    returned only when CUDA is available; otherwise this raises
    ``RuntimeError`` — pass ``device="cpu"`` to run on the host.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
