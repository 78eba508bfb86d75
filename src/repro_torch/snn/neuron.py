"""Neuron dynamics — LIF and Izhikevich point models with conductance
channel noise (the paper's complexity knob, Table II).

Port of ``repro.snn.neuron`` to tensors.  The same functions step the
single-device engine (state ``[M]``) and the distributed engine's
rank-stacked state (``[n_dev, n_loc]``): the update is elementwise.  All
state is float32 and the arithmetic keeps the reference's operation
order and its ``where`` structure (refractory hold, reset, the
``max(u - dt, 0)`` countdown), so at ``noise_sigma=0`` the spikes match
the JAX steps exactly.

Channel noise draws from JAX's threefry streams (:mod:`repro_torch.random`)
under the key carried in :attr:`NeuronState.key`: ``[2]`` for a flat state,
``[n_dev, 2]`` (one key per rank) for a rank-stacked one.  Each noisy step
splits the key and draws its normals from the subkey, as the reference's
step does, so a seed gives the reference's noise and its raster.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.device import resolve_device

__all__ = [
    "LIFParams",
    "IzhikevichParams",
    "NeuronState",
    "lif_step",
    "izhikevich_step",
    "init_state",
]


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Leaky integrate-and-fire constants (mV / ms / MΩ units)."""

    tau_m: float = 10.0
    v_rest: float = -65.0
    v_reset: float = -65.0
    v_thresh: float = -50.0
    r_m: float = 10.0
    t_refrac: float = 2.0
    dt: float = 0.1
    noise_sigma: float = 0.0  # channel noise: conductance jitter, mV/√ms


@dataclasses.dataclass(frozen=True)
class IzhikevichParams:
    """Izhikevich model constants (regular-spiking defaults)."""

    a: float = 0.02
    b: float = 0.2
    c: float = -65.0
    d: float = 8.0
    v_thresh: float = 30.0
    dt: float = 0.5
    noise_sigma: float = 0.0


class NeuronState(NamedTuple):
    """v: membrane potential; u: recovery (Izhikevich) / refractory
    countdown (LIF); key: the noise key (:mod:`repro_torch.random`) —
    ``[2]``, one per row of a rank-stacked state ``[n_dev, 2]``, or
    ``None`` (noise-free)."""

    v: torch.Tensor
    u: torch.Tensor
    key: torch.Tensor | None


def init_state(
    n: int | tuple[int, ...],
    params,
    key: torch.Tensor | None = None,
    *,
    device: str | torch.device | None = None,
) -> NeuronState:
    """Resting state of ``n`` neurons on ``device`` (default the card; see
    :func:`repro_torch.device.resolve_device`)."""
    device = resolve_device(device)
    shape = (n,) if isinstance(n, int) else tuple(n)
    if isinstance(params, LIFParams):
        v0 = torch.full(shape, params.v_rest, dtype=torch.float32, device=device)
        u0 = torch.zeros(shape, dtype=torch.float32, device=device)
    else:
        v0 = torch.full(shape, params.c, dtype=torch.float32, device=device)
        u0 = params.b * v0
    return NeuronState(v=v0, u=u0, key=key)


def _noise(state: NeuronState, v: torch.Tensor, params) -> tuple[torch.Tensor, torch.Tensor]:
    """``(key, noise)``: ``key, sub = split(state.key)`` and the channel
    noise ``sigma · sqrt(dt) · normal(sub)`` shaped like ``v``, one draw per
    key row; the scale is the reference's float32 product."""
    key = state.key
    if key is None:
        raise ValueError("noise_sigma > 0 needs NeuronState.key")
    if v.shape[:key.dim() - 1] != key.shape[:-1]:
        raise ValueError(f"keys {tuple(key.shape)} for state rows {tuple(v.shape)}")
    key, z = random.split_normal(key, v.shape[key.dim() - 1:])
    scale = float(np.float32(params.noise_sigma) * np.sqrt(np.float32(params.dt)))
    return key, scale * z


def lif_step(
    state: NeuronState, i_syn: torch.Tensor, params: LIFParams
) -> tuple[NeuronState, torch.Tensor]:
    """One forward-Euler LIF step.  Returns (new_state, spikes[f32])."""
    refractory = state.u > 0.0
    dv = (params.dt / params.tau_m) * (
        (params.v_rest - state.v) + params.r_m * i_syn
    )
    v_new, key = state.v + dv, state.key
    if params.noise_sigma:
        key, noise = _noise(state, state.v, params)
        v_new = v_new + noise
    v = torch.where(refractory, state.v, v_new)
    spikes = (v >= params.v_thresh) & ~refractory
    v = torch.where(spikes, torch.full_like(v, params.v_reset), v)
    u = torch.where(
        spikes,
        torch.full_like(state.u, params.t_refrac),
        torch.clamp_min(state.u - params.dt, 0.0),
    )
    return NeuronState(v=v, u=u, key=key), spikes.to(torch.float32)


def izhikevich_step(
    state: NeuronState, i_syn: torch.Tensor, params: IzhikevichParams
) -> tuple[NeuronState, torch.Tensor]:
    """One Izhikevich step (two half-steps for v, standard trick)."""
    v, u, key = state.v, state.u, state.key
    for _ in range(2):  # two half-dt substeps for numerical stability
        v = v + 0.5 * params.dt * (0.04 * v * v + 5.0 * v + 140.0 - u + i_syn)
    u = u + params.dt * params.a * (params.b * v - u)
    if params.noise_sigma:
        key, noise = _noise(state, v, params)
        v = v + noise
    spikes = v >= params.v_thresh
    v = torch.where(spikes, torch.full_like(v, params.c), v)
    u = torch.where(spikes, u + params.d, u)
    return NeuronState(v=v, u=u, key=key), spikes.to(torch.float32)
