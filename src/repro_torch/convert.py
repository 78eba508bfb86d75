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
* :func:`neuron_state` — the ``v``/``u`` state;
* :func:`lm_params` — the JAX LM's parameter tree (``repro.models.lm``)
  as the port's, leaf for leaf.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.snn.neuron import IzhikevichParams, LIFParams, NeuronState
from repro_torch.snn.sparse import BlockSynapses

__all__ = [
    "dense_weights",
    "block_synapses",
    "padded_tiles",
    "neuron_params",
    "neuron_state",
    "lm_params",
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
    syn: BlockSynapses, device: str | torch.device | None = None, *,
    ranks: range | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(src_ids int32[n_blocks, K], blocks f32[n_blocks, K, B, B])`` on
    ``device`` — :meth:`BlockSynapses.padded`'s layout (destination ``d``'s
    real tiles first, then zero tiles pointing at source 0), built on the
    device from the stored tiles; with ``ranks``, only those destinations'
    rows (``K`` stays the whole grid's).  A fresh copy on every call:
    engines that should share one pass it as ``DistributedSNN(tiles=...,
    tile_ranks=ranks)``."""
    dev = resolve_device(device)
    deg = np.diff(syn.indptr)
    k = max(int(deg.max()) if deg.size else 0, 1)
    b = syn.block_size
    ranks = range(syn.n_blocks) if ranks is None else ranks
    src = np.zeros((len(ranks), k), dtype=np.int32)
    blk = torch.zeros((len(ranks), k, b, b), dtype=torch.float32, device=dev)
    for row, d in enumerate(ranks):
        lo, hi = int(syn.indptr[d]), int(syn.indptr[d + 1])
        src[row, : hi - lo] = syn.src_ids[lo:hi]
        for j in range(hi - lo):
            blk[row, j].copy_(torch.from_numpy(syn.blocks[lo + j]))
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
    """A :class:`NeuronState` with float32 ``v``/``u`` on ``device``; ``key``
    (a reference key ``[..., 2]`` of ``uint32`` words, or ``None``) becomes
    the port's ``int64`` key tensor (:mod:`repro_torch.random`)."""
    dev = resolve_device(device)
    if key is not None:
        key = torch.as_tensor(np.asarray(key, dtype=np.uint32).astype(np.int64), device=dev)
    return NeuronState(
        v=torch.as_tensor(np.asarray(v, dtype=np.float32), device=dev),
        u=torch.as_tensor(np.asarray(u, dtype=np.float32), device=dev),
        key=key,
    )


def lm_params(tree: Mapping, cfg, device: str | torch.device | None = None) -> dict:
    """The port's LM parameters from the reference's tree (nested dicts of
    arrays, as ``repro.models.lm.init_params`` builds it) for ``cfg``.

    Each leaf is read as float32 numpy — hand over ``np.asarray(x,
    np.float32)`` for a bf16 JAX leaf, whose own numpy dtype torch refuses;
    bf16 → f32 → bf16 is exact — and stored on ``device`` in the dtype of
    its :class:`~repro_torch.models.lm.PDef`.  Keys and shapes must match
    :func:`repro_torch.models.lm.param_defs` exactly."""
    dev = resolve_device(device)

    def conv(node, pd, path):
        if isinstance(pd, lm.PDef):
            a = np.array(node, dtype=np.float32)  # a writable copy
            if a.shape != pd.shape:
                raise ValueError(f"{path}: shape {a.shape}, expected {pd.shape}")
            return torch.from_numpy(a).to(device=dev, dtype=pd.dtype)
        if not isinstance(node, Mapping) or set(node) != set(pd):
            got = sorted(node) if isinstance(node, Mapping) else type(node).__name__
            raise ValueError(f"{path or '/'}: keys {got}, expected {sorted(pd)}")
        return {k: conv(node[k], pd[k], f"{path}/{k}") for k in sorted(pd)}

    return conv(tree, lm.param_defs(cfg), "")
