"""Neuron dynamics — LIF and Izhikevich point models with conductance
channel noise (the paper's complexity knob, Table II).

Port of ``repro.snn.neuron`` to tensors.  The same functions step the
single-device engine (state ``[M]``) and the distributed engine's
rank-stacked state (``[n_dev, n_loc]``): the update is elementwise.  All
state is float32 and the arithmetic keeps the reference's operation
order and its ``where`` structure (refractory hold, reset, the
``max(u - dt, 0)`` countdown), so at ``noise_sigma=0`` the spikes match
the JAX steps exactly.

Channel noise draws from explicit ``torch.Generator``\\ s carried in
:attr:`NeuronState.key`: one generator for a flat state, or one per row
(rank) for a rank-stacked state.  ``torch.Generator`` cannot reproduce
JAX's threefry streams, so noisy runs agree with the reference in
distribution only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "LIFParams",
    "IzhikevichParams",
    "NeuronState",
    "lif_step",
    "izhikevich_step",
    "init_state",
    "make_generators",
    "generators",
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


Key = torch.Generator | Sequence[torch.Generator] | None


class NeuronState(NamedTuple):
    """v: membrane potential; u: recovery (Izhikevich) / refractory
    countdown (LIF); key: noise generator(s) — one ``torch.Generator``,
    one per row of a rank-stacked state, or ``None`` (noise-free)."""

    v: torch.Tensor
    u: torch.Tensor
    key: Key


def make_generators(
    seed: int, n: int, device: str | torch.device
) -> list[torch.Generator]:
    """``n`` independent noise generators on ``device`` seeded from
    ``seed`` (one per rank; numpy ``SeedSequence`` spawns the seeds)."""
    seeds = [
        int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
        for s in np.random.SeedSequence(seed).spawn(n)
    ]
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def generators(key: Key) -> tuple[torch.Generator, ...]:
    """The generators a state draws from, to register with a CUDA graph
    that captures its steps (:class:`repro_torch.graphs.StepGraph`): a
    replay then advances each one's Philox offset as an eager step would."""
    if key is None:
        return ()
    return (key,) if isinstance(key, torch.Generator) else tuple(key)


def init_state(
    n: int | tuple[int, ...],
    params,
    key: Key = None,
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


def _normal(v: torch.Tensor, key: Key) -> torch.Tensor:
    """Standard normals shaped like ``v`` from the state's generator(s)."""
    if key is None:
        raise ValueError("noise_sigma > 0 needs NeuronState.key generator(s)")
    if isinstance(key, torch.Generator):
        return torch.randn(v.shape, generator=key, dtype=v.dtype, device=v.device)
    if len(key) != v.shape[0]:
        raise ValueError(f"{len(key)} generators for {v.shape[0]} state rows")
    return torch.stack([
        torch.randn(v.shape[1:], generator=g, dtype=v.dtype, device=v.device)
        for g in key
    ])


def lif_step(
    state: NeuronState, i_syn: torch.Tensor, params: LIFParams
) -> tuple[NeuronState, torch.Tensor]:
    """One forward-Euler LIF step.  Returns (new_state, spikes[f32])."""
    refractory = state.u > 0.0
    dv = (params.dt / params.tau_m) * (
        (params.v_rest - state.v) + params.r_m * i_syn
    )
    v_new = state.v + dv
    if params.noise_sigma:
        v_new = v_new + (
            params.noise_sigma * math.sqrt(params.dt) * _normal(state.v, state.key)
        )
    v = torch.where(refractory, state.v, v_new)
    spikes = (v >= params.v_thresh) & ~refractory
    v = torch.where(spikes, torch.full_like(v, params.v_reset), v)
    u = torch.where(
        spikes,
        torch.full_like(state.u, params.t_refrac),
        torch.clamp_min(state.u - params.dt, 0.0),
    )
    return NeuronState(v=v, u=u, key=state.key), spikes.to(torch.float32)


def izhikevich_step(
    state: NeuronState, i_syn: torch.Tensor, params: IzhikevichParams
) -> tuple[NeuronState, torch.Tensor]:
    """One Izhikevich step (two half-steps for v, standard trick)."""
    v, u = state.v, state.u
    for _ in range(2):  # two half-dt substeps for numerical stability
        v = v + 0.5 * params.dt * (0.04 * v * v + 5.0 * v + 140.0 - u + i_syn)
    u = u + params.dt * params.a * (params.b * v - u)
    if params.noise_sigma:
        v = v + params.noise_sigma * math.sqrt(params.dt) * _normal(v, state.key)
    spikes = v >= params.v_thresh
    v = torch.where(spikes, torch.full_like(v, params.c), v)
    u = torch.where(spikes, u + params.d, u)
    return NeuronState(v=v, u=u, key=state.key), spikes.to(torch.float32)
