"""Production meshes.

Port of ``repro/launch/mesh.py``: functions, so importing this module
touches no process group.  :func:`make_production_mesh` only builds the
``DeviceMesh``: the caller has initialised ``torch.distributed`` with a
world of 256 (or 512) ranks, as ``torch.distributed.run`` does (a dry run
may use the ``fake`` backend).
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "POD_SIZE"]

POD_SIZE = 256  # chips per pod (16 × 16)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
