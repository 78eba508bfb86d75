"""Published peaks of the card the cells run on, and what the card says of
itself.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
power limit of 700 W: 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM.  A share of a roofline or of a peak is
stated against these, with the card's power limit beside it.
"""
from __future__ import annotations

import subprocess

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def card() -> dict:
    """The card's name and power limit from ``nvidia-smi`` (empty where it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    name, limit = (s.strip() for s in out.stdout.strip().splitlines()[0].split(",", 1))
    return {"smi_name": name, "power_limit": limit}
