"""Brain-model generator (the paper's simulation model, §I/§V).

The paper's model is "created according to the biological structure of a
real human brain scanned using medical instruments" — i.e. a parcellation
into regions/populations with empirical connection probabilities, scaled
to 10–20 billion neurons.  We generate the same *class* of model:

* ``n_regions`` cortical regions laid out on a 3-D shell;
* each region holds several neuron **populations** (the partitioning
  granularity — P[M,M] at M = 1e10 single neurons is not materializable,
  see DESIGN.md §9.3);
* connectivity = strong intra-region community structure + distance-
  dependent exponential fall-off between regions + sparse long-range
  fascicles (heavy-tail) — the "extremely sparse, uneven" matrix the
  paper describes;
* population weight = neuron count × firing rate × bytes/spike, i.e. the
  expected traffic the population generates (the paper's ``W``).

The generator is deterministic per seed and scales from unit-test sizes
(tens of populations) to paper scale (10^4–10^5 populations representing
10^10 neurons) in seconds, because everything is vectorized sparse COO.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import CommGraph, build_graph

__all__ = ["BrainModel", "generate_brain_model"]


@dataclasses.dataclass(frozen=True)
class BrainModel:
    """A generated brain model at population granularity.

    Attributes:
      graph: population-level communication graph (P, W).
      neuron_counts: ``int64[n_pop]`` neurons per population.
      region_of: ``int64[n_pop]`` population → region.
      positions: ``float64[n_pop, 3]`` population centroids.
      firing_rate: ``float64[n_pop]`` mean rate (Hz) per population.
      total_neurons: Σ neuron_counts.
    """

    graph: CommGraph
    neuron_counts: np.ndarray
    region_of: np.ndarray
    positions: np.ndarray
    firing_rate: np.ndarray

    @property
    def total_neurons(self) -> int:
        return int(self.neuron_counts.sum())

    @property
    def n_populations(self) -> int:
        return int(self.neuron_counts.shape[0])


def generate_brain_model(
    *,
    n_populations: int = 2048,
    n_regions: int = 90,
    total_neurons: int = 10_000_000_000,
    intra_region_p: float = 0.35,
    lambda_mm: float = 28.0,
    inter_degree: float = 12.0,
    long_range_frac: float = 0.015,
    mean_rate_hz: float = 4.0,
    bytes_per_spike: float = 4.0,
    seed: int = 0,
) -> BrainModel:
    """Generate a brain model.

    Defaults follow the AAL-90 parcellation shape scaled to the paper's
    10-billion-neuron setup.  Region sizes and rates are log-normal
    (biological population sizes are heavy-tailed — the *uneven traffic*
    of the paper's guideline #3 falls out of this).
    """
    rng = np.random.default_rng(seed)
    if n_regions > n_populations:
        raise ValueError("need at least one population per region")

    # --- regions on a spherical shell (cortex-like geometry, mm units)
    u = rng.normal(size=(n_regions, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    region_pos = u * rng.uniform(60.0, 80.0, size=(n_regions, 1))

    # --- populations per region (log-normal sizes)
    region_of = np.sort(rng.integers(0, n_regions, size=n_populations))
    # guarantee every region non-empty
    region_of[:n_regions] = np.arange(n_regions)
    region_of = np.sort(region_of)
    jitter = rng.normal(scale=4.0, size=(n_populations, 3))
    positions = region_pos[region_of] + jitter

    raw = rng.lognormal(mean=0.0, sigma=0.8, size=n_populations)
    neuron_counts = np.maximum(
        1, np.round(raw / raw.sum() * total_neurons)
    ).astype(np.int64)

    firing_rate = rng.lognormal(
        mean=np.log(mean_rate_hz), sigma=0.5, size=n_populations
    )

    # --- edges -------------------------------------------------------
    # intra-region: dense community block (prob ~ intra_region_p)
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

    # inter-region: distance-dependent sampling.  Sample candidate pairs
    # proportional to exp(-dist/λ) without materializing the n_pop² grid.
    # ``inter_degree`` targets the mean number of inter-region partners
    # per population — the paper's device graph is dense (mean 1,552
    # connections per GPU at 2,000 GPUs), which requires a rich
    # projection structure, so the candidate count adapts to the target
    # via a pilot estimate of the distance-acceptance rate.
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

    # long-range fascicles: few, strong, distance-oblivious
    n_long = max(1, int(long_range_frac * n_populations))
    li = rng.integers(0, n_populations, size=n_long)
    lj = rng.integers(0, n_populations, size=n_long)
    keep = li != lj
    srcs.append(li[keep])
    dsts.append(lj[keep])
    ps.append(rng.uniform(0.4, 0.9, int(keep.sum())))

    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    prob = np.concatenate(ps)

    # paper's W: expected traffic = neurons × rate × bytes/spike
    weights = neuron_counts.astype(np.float64) * firing_rate * bytes_per_spike
    # normalize to keep objectives in a numerically friendly range
    weights = weights / weights.mean()

    graph = build_graph(src, dst, prob, weights, sym=True)
    return BrainModel(
        graph=graph,
        neuron_counts=neuron_counts,
        region_of=region_of,
        positions=positions,
        firing_rate=firing_rate,
    )
