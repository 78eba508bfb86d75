"""Carry weights, neuron constants and state from the reference's inputs
into the port's objects on a given device.

The reference engines (``repro.snn``) take numpy arrays, plain dataclass
fields and JAX arrays; the tests and the smoke script build both engines
from one set of numpy inputs through these functions:

* :func:`dense_weights` — a dense ``w_syn`` as a float32 tensor;
* :func:`block_synapses` — the ``BlockSynapses`` fields
  (``indptr``/``src_ids``/``blocks``/``n_blocks``) as the port's
  :class:`~repro_torch.snn.sparse.BlockSynapses`;
* :func:`padded_tiles` — those tiles as the rank-stacked, zero-padded
  device tensors the distributed engine's kernel reads, built on the
  device tile by tile (no second host copy of the tiles);
* :func:`neuron_params` — the neuron-parameter dataclass fields;
* :func:`neuron_state` — the ``v``/``u`` state.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.snn.neuron import IzhikevichParams, LIFParams, NeuronState
from repro_torch.snn.sparse import BlockSynapses

__all__ = [
    "dense_weights",
    "block_synapses",
    "padded_tiles",
    "neuron_params",
    "neuron_state",
]


def dense_weights(w, device: str | torch.device | None = None) -> torch.Tensor:
    """A dense ``[M, M]`` synapse matrix as a float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(w, dtype=np.float32), device=resolve_device(device))


def block_synapses(
    indptr, src_ids, blocks, n_blocks: int | None = None
) -> BlockSynapses:
    """The port's :class:`BlockSynapses` from the reference's fields,
    validated on construction (``n_blocks`` defaults to
    ``len(indptr) - 1``)."""
    if n_blocks is None:
        n_blocks = len(indptr) - 1
    syn = BlockSynapses(
        indptr=np.asarray(indptr, dtype=np.int64),
        src_ids=np.asarray(src_ids, dtype=np.int64),
        blocks=np.asarray(blocks, dtype=np.float32),
        n_blocks=int(n_blocks),
    )
    syn.validate()
    return syn


def padded_tiles(
    syn: BlockSynapses, device: str | torch.device | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(src_ids int32[n_blocks, K], blocks f32[n_blocks, K, B, B])`` on
    ``device`` — :meth:`BlockSynapses.padded`'s layout (destination ``d``'s
    real tiles first, then zero tiles pointing at source 0), built on the
    device from the stored tiles.  A fresh copy on every call: engines that
    should share one pass it as ``DistributedSNN(tiles=...)``."""
    dev = resolve_device(device)
    deg = np.diff(syn.indptr)
    k = max(int(deg.max()) if deg.size else 0, 1)
    b = syn.block_size
    src = np.zeros((syn.n_blocks, k), dtype=np.int32)
    blk = torch.zeros((syn.n_blocks, k, b, b), dtype=torch.float32, device=dev)
    for d in range(syn.n_blocks):
        lo, hi = int(syn.indptr[d]), int(syn.indptr[d + 1])
        src[d, : hi - lo] = syn.src_ids[lo:hi]
        for j in range(hi - lo):
            blk[d, j].copy_(torch.from_numpy(syn.blocks[lo + j]))
    return torch.as_tensor(src, device=dev), blk


def neuron_params(fields: Mapping | object, kind: str | None = None):
    """``LIFParams`` / ``IzhikevichParams`` from a reference dataclass (any
    object with the same fields) or a plain dict.  ``kind`` ('lif' or
    'izhikevich') defaults to the source's class name."""
    if not isinstance(fields, Mapping):
        kind = kind or type(fields).__name__
        fields = dataclasses.asdict(fields) if dataclasses.is_dataclass(fields) else vars(fields)
    kind = (kind or "lif").lower()
    cls = IzhikevichParams if kind.startswith("izhikevich") else LIFParams
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: float(v) for k, v in fields.items() if k in names})


def neuron_state(
    v, u, device: str | torch.device | None = None, key=None
) -> NeuronState:
    """A :class:`NeuronState` with float32 ``v``/``u`` on ``device``."""
    dev = resolve_device(device)
    return NeuronState(
        v=torch.as_tensor(np.asarray(v, dtype=np.float32), device=dev),
        u=torch.as_tensor(np.asarray(u, dtype=np.float32), device=dev),
        key=key,
    )
