"""The brain model of the SNN cells, made by the benchmark from the seed.

:func:`population_probabilities` is a frozen copy of the port's
``snn.model.generate_brain_model`` (itself the reference's): the same draws
from the same seed, reduced to what the cells use, the dense population
connection probabilities ``P[n_pop, n_pop]`` (symmetric, the larger of
duplicate edges, no self-loops).  :func:`sample_synapses` draws the
neuron-level synapses of the model class that ``snn.engine.expand_synapses``
defines, on the device, in a few large calls: neuron ``i`` of population
``a`` connects to neuron ``j`` of population ``b`` with probability
``P[a, b] · synapse_p`` (``synapse_p`` inside a population), no neuron onto
itself, weights ``gamma(2, w_scale / 2)`` (the sum of two exponential
draws), every outgoing weight of an inhibitory neuron negative (Dale's
law), all scaled by the launcher's ``scale``.  Neurons lie in contiguous
slabs: rank ``d`` holds neurons ``[d·B, (d + 1)·B)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def population_probabilities(
    *,
    n_populations: int,
    n_regions: int,
    total_neurons: int,
    intra_region_p: float = 0.35,
    lambda_mm: float = 28.0,
    inter_degree: float = 12.0,
    long_range_frac: float = 0.015,
    mean_rate_hz: float = 4.0,
    seed: int = 0,
) -> np.ndarray:
    """``P[n_pop, n_pop]`` of ``generate_brain_model(...)`` with these
    arguments: the same random draws in the same order."""
    rng = np.random.default_rng(seed)
    if n_regions > n_populations:
        raise ValueError("need at least one population per region")
    u = rng.normal(size=(n_regions, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    region_pos = u * rng.uniform(60.0, 80.0, size=(n_regions, 1))
    region_of = np.sort(rng.integers(0, n_regions, size=n_populations))
    region_of[:n_regions] = np.arange(n_regions)
    region_of = np.sort(region_of)
    jitter = rng.normal(scale=4.0, size=(n_populations, 3))
    positions = region_pos[region_of] + jitter
    raw = rng.lognormal(mean=0.0, sigma=0.8, size=n_populations)
    del raw, total_neurons  # neuron counts: drawn for the stream, unused here
    rng.lognormal(mean=np.log(mean_rate_hz), sigma=0.5, size=n_populations)  # rates

    srcs, dsts, ps = [], [], []
    for r in range(n_regions):
        members = np.nonzero(region_of == r)[0]
        k = members.shape[0]
        if k < 2:
            continue
        ii, jj = np.triu_indices(k, 1)
        keep = rng.random(ii.shape[0]) < intra_region_p
        srcs.append(members[ii[keep]])
        dsts.append(members[jj[keep]])
        ps.append(rng.uniform(0.3, 1.0, int(keep.sum())))

    pilot_i = rng.integers(0, n_populations, size=4096)
    pilot_j = rng.integers(0, n_populations, size=4096)
    pd = np.linalg.norm(positions[pilot_i] - positions[pilot_j], axis=1)
    acc_rate = max(float(np.exp(-pd / lambda_mm).mean()), 1e-4)
    n_cand = int(inter_degree * n_populations / 2 / acc_rate)
    ci = rng.integers(0, n_populations, size=n_cand)
    cj = rng.integers(0, n_populations, size=n_cand)
    valid = (ci != cj) & (region_of[ci] != region_of[cj])
    ci, cj = ci[valid], cj[valid]
    dist = np.linalg.norm(positions[ci] - positions[cj], axis=1)
    accept = rng.random(ci.shape[0]) < np.exp(-dist / lambda_mm)
    srcs.append(ci[accept])
    dsts.append(cj[accept])
    ps.append(rng.uniform(0.05, 0.4, int(accept.sum())))

    n_long = max(1, int(long_range_frac * n_populations))
    li = rng.integers(0, n_populations, size=n_long)
    lj = rng.integers(0, n_populations, size=n_long)
    keep = li != lj
    srcs.append(li[keep])
    dsts.append(lj[keep])
    ps.append(rng.uniform(0.4, 0.9, int(keep.sum())))

    src, dst, prob = np.concatenate(srcs), np.concatenate(dsts), np.concatenate(ps)
    p = np.zeros((n_populations, n_populations))
    np.maximum.at(p, (src, dst), prob)
    np.maximum.at(p, (dst, src), prob)
    np.fill_diagonal(p, 0.0)
    return p


@dataclasses.dataclass(frozen=True)
class Synapses:
    """Synapses over ``n_blocks`` ranks of ``block`` neurons each.

    ``tiles`` ``f32[n_blocks, K, B, B]``: destination ``d``'s stored tiles
    (rows presynaptic, from block ``src[d, k]``, columns its own neurons),
    sorted by source, then zero tiles pointing at source 0 (the port's
    padded layout); ``src`` ``int32[n_blocks, K]``; ``stored`` ``bool[n_blocks
    (source), n_blocks (destination)]``: which tiles hold a synapse.
    ``pre``, ``post``, ``weight``: every synapse as global neuron indices and
    its float32 weight, on the host (what the plain reference reads).
    """

    tiles: torch.Tensor
    src: torch.Tensor
    stored: np.ndarray
    pre: np.ndarray
    post: np.ndarray
    weight: np.ndarray

    @property
    def n_blocks(self) -> int:
        return int(self.stored.shape[0])

    @property
    def block(self) -> int:
        return int(self.tiles.shape[-1])


def _generator(device, *words: int) -> torch.Generator:
    seed = int(np.random.SeedSequence([int(w) for w in words]).generate_state(2, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def sample_synapses(p: np.ndarray, neurons_per_pop: int, n_blocks: int, *, seed: int,
                    synapse_p: float, w_scale: float, inhibitory_frac: float, scale: float,
                    device) -> Synapses:
    """The synapses of population probabilities ``p`` (see the module),
    drawn on ``device`` from ``seed``, one tile at a time (so that the
    draws never hold more than a tile's candidates): one uniform draw per
    candidate pair, one per synapse's two exponential draws, and before
    them one for the inhibitory flags."""
    n_pop = p.shape[0]
    if n_pop % n_blocks:
        raise ValueError("n_blocks must divide the population count")
    ppb = n_pop // n_blocks
    b = ppb * neurons_per_pop
    m = n_pop * neurons_per_pop
    pp = p.copy()
    np.fill_diagonal(pp, 1.0)  # inside a population: synapse_p itself
    pt = torch.as_tensor(pp, dtype=torch.float32, device=device)
    gen = _generator(device, seed, 1)
    inhib = torch.rand(m, generator=gen, device=device) < inhibitory_frac
    sign = torch.where(inhib, -scale, scale).to(torch.float32)
    pops = torch.arange(m, device=device) // neurons_per_pop
    # every (source, destination) tile, one at a time, then only the stored ones kept
    grid = torch.zeros((n_blocks, n_blocks, b, b), dtype=torch.float32, device=device)
    eye = torch.arange(b, device=device)
    pre_all, post_all, w_all = [], [], []
    for d in range(n_blocks):
        cols = pops[d * b:(d + 1) * b]
        for s in range(n_blocks):
            rows = slice(s * b, (s + 1) * b)
            prob = pt[pops[rows][:, None], cols[None, :]] * synapse_p  # [B, B]
            hit = torch.rand((b, b), generator=gen, device=device) < prob
            del prob
            if s == d:
                hit[eye, eye] = False  # no neuron onto itself
            pre, col = torch.nonzero(hit, as_tuple=True)
            del hit
            pre = pre + s * b
            u = torch.rand((2, pre.numel()), generator=gen, device=device)
            # u in [0, 1): -log(1 - u) is exponential and finite
            w = (w_scale / 2.0) * -(torch.log1p(-u[0]) + torch.log1p(-u[1])) * sign[pre]
            grid[d].view(m, b)[pre, col] = w
            pre_all.append(pre.cpu().numpy())
            post_all.append((col + d * b).cpu().numpy())
            w_all.append(w.cpu().numpy())
    stored = np.zeros((n_blocks, n_blocks), dtype=bool)
    for i, pre in enumerate(pre_all):
        stored[i % n_blocks, i // n_blocks] = pre.size > 0
    k = max(int(stored.sum(0).max()), 1)
    src = np.zeros((n_blocks, k), dtype=np.int32)
    for d in range(n_blocks):
        real = np.nonzero(stored[:, d])[0]
        src[d, :real.size] = real
    if stored.all():
        tiles = grid  # every tile stored: the grid is the padded layout already
    else:
        tiles = torch.zeros((n_blocks, k, b, b), dtype=torch.float32, device=device)
        for d in range(n_blocks):
            for j, s in enumerate(np.nonzero(stored[:, d])[0]):
                tiles[d, j].copy_(grid[d, s])
        del grid
    return Synapses(tiles=tiles, src=torch.as_tensor(src, device=device), stored=stored,
                    pre=np.concatenate(pre_all).astype(np.int64),
                    post=np.concatenate(post_all).astype(np.int64),
                    weight=np.concatenate(w_all).astype(np.float32))


def drive(m: int, lo: float, hi: float, *, seed: int, sim: int, device) -> torch.Tensor:
    """The external drive of simulation ``sim``: one value per neuron,
    uniform in ``[lo, hi)``, drawn on ``device``."""
    gen = _generator(device, seed, 2, sim)
    return lo + (hi - lo) * torch.rand(m, generator=gen, device=device)
