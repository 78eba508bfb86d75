"""Single-device SNN engine — the reference simulation loop, on tensors.

Port of ``repro.snn.engine``.  :class:`SNNEngine` steps the neuron
dynamics and the synaptic-current accumulation in a loop over steps, each
step updating the state in place and writing its raster row through a
device step counter; on the card the first step runs eagerly and the rest
replay its CUDA graph (:mod:`repro_torch.graphs`, the counterpart of the
reference's ``jax.jit`` over ``lax.scan``).  It is the raster oracle the distributed engine
(:mod:`repro_torch.snn.distributed`) is pinned to, modulo the neuron
permutation.  The ``current_fn`` hook swaps the accumulation: pass
:func:`repro_torch.kernels.spike_currents` to run the hand-written
``spike_accum`` kernel on the card (its plain version on the CPU).

:func:`expand_synapses` and :func:`expand_synapses_sparse` are numpy
copies of the reference's.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch import graphs, random
from repro_torch.core.graph import CommGraph
from repro_torch.device import resolve_device
from repro_torch.snn.sparse import BlockSynapses
from repro_torch.snn.neuron import (
    IzhikevichParams,
    LIFParams,
    NeuronState,
    init_state,
    izhikevich_step,
    lif_step,
)

__all__ = ["SNNEngine", "expand_synapses", "expand_synapses_sparse", "RunResult"]


def expand_synapses(
    g: CommGraph,
    neurons_per_pop: int,
    *,
    synapse_p: float = 0.3,
    w_scale: float = 8.0,
    inhibitory_frac: float = 0.2,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Expand a population graph into a neuron-level synapse matrix.

    Returns ``(w_syn[M, M], pop_of[M])`` where ``M = n_pop ·
    neurons_per_pop``.  Neuron pairs in connected populations get a
    synapse with probability ``P[pop_i, pop_j] · synapse_p``; intra-
    population connectivity uses ``synapse_p`` directly.  ~20% of neurons
    are inhibitory (negative outgoing weights), Dale's law respected.
    Only usable at test scale (M ≲ a few thousand).
    """
    rng = np.random.default_rng(seed)
    n_pop = g.num_vertices
    m = n_pop * neurons_per_pop
    pop_of = np.repeat(np.arange(n_pop), neurons_per_pop)
    # population-pair probability matrix (dense — test scale only)
    pp = np.zeros((n_pop, n_pop))
    rows = g.rows()
    pp[rows, g.indices] = g.probs
    pp[g.indices, rows] = g.probs
    np.fill_diagonal(pp, 1.0)
    prob = pp[pop_of[:, None], pop_of[None, :]] * synapse_p
    mask = rng.random((m, m)) < prob
    np.fill_diagonal(mask, False)
    w = rng.gamma(2.0, w_scale / 2.0, size=(m, m)) * mask
    inhib = rng.random(m) < inhibitory_frac
    w[inhib] *= -1.0
    return w.astype(np.float32), pop_of


def expand_synapses_sparse(
    g: CommGraph,
    neurons_per_pop: int,
    n_blocks: int,
    *,
    assign: np.ndarray | None = None,
    synapse_p: float = 0.3,
    w_scale: float = 8.0,
    inhibitory_frac: float = 0.2,
    seed: int = 0,
) -> tuple[BlockSynapses, np.ndarray]:
    """Expand a population graph into **block-CSR** synapses — the
    scalable counterpart of :func:`expand_synapses` that never
    materializes ``[M, M]``.

    Neurons are laid out device-contiguously: populations are assigned to
    the ``n_blocks`` device blocks (``assign``, an Algorithm-1 result with
    equal counts; contiguous slabs when ``None``), and only the ``B × B``
    tiles whose population pairs are connected in ``g`` are ever sampled
    — everything else is structurally zero and skipped, so memory is
    O(nnz tiles · B²) plus the dense *population*-pair matrix (population
    granularity is always materializable, per the partitioning layer).

    Sampling is deterministic per ``(seed, src_block, dst_block)``
    independent RNG streams, so the result does not depend on tile
    iteration order; it is *not* bit-identical to the dense
    :func:`expand_synapses` (which draws all pairs from one stream).
    Same model class: synapse probability ``P[pop_i, pop_j] · synapse_p``
    (``synapse_p`` intra-population), gamma weights, Dale's law with
    ~``inhibitory_frac`` inhibitory neurons, empty diagonal.

    Returns ``(syn, pop_of)``: the tiles and the original population id
    of every neuron in the new block-contiguous layout.
    """
    n_pop = g.num_vertices
    if assign is None:
        if n_pop % n_blocks:
            raise ValueError("n_blocks must divide the population count")
        assign = np.repeat(np.arange(n_blocks), n_pop // n_blocks)
    else:
        assign = np.asarray(assign, dtype=np.int64)
        counts = np.bincount(assign, minlength=n_blocks)
        if counts.max() != counts.min():
            raise ValueError(
                f"uneven population assignment ({counts.min()}–{counts.max()}"
                " per block); equalize counts upstream"
            )
    ppb = n_pop // n_blocks  # populations per block
    b = ppb * neurons_per_pop  # neurons per block
    m = n_pop * neurons_per_pop

    # block-contiguous population order (stable: preserves intra-block order)
    pop_perm = np.argsort(assign, kind="stable")
    pop_of = np.repeat(pop_perm, neurons_per_pop)

    # population-pair probability matrix (dense at population granularity)
    pp = np.zeros((n_pop, n_pop))
    rows = g.rows()
    pp[rows, g.indices] = g.probs
    pp[g.indices, rows] = g.probs
    np.fill_diagonal(pp, 1.0)
    pp = pp[np.ix_(pop_perm, pop_perm)]  # block-contiguous order

    # inhibitory flags per neuron — stream [seed, n_blocks, n_blocks] can
    # never collide with a tile stream [seed, bi, bj] (bi, bj < n_blocks)
    inhib = (
        np.random.default_rng([seed, n_blocks, n_blocks]).random(m)
        < inhibitory_frac
    )

    # candidate tiles: any connected population pair spanning (bi, bj)
    member = np.zeros((n_blocks, n_pop))
    member[np.arange(n_pop) // ppb, np.arange(n_pop)] = 1.0
    tile_any = (member @ (pp > 0) @ member.T) > 0

    srcs, dsts, tiles = [], [], []
    for bi, bj in zip(*np.nonzero(tile_any)):
        rng = np.random.default_rng([seed, int(bi), int(bj)])
        prob = np.repeat(
            np.repeat(
                pp[bi * ppb : (bi + 1) * ppb, bj * ppb : (bj + 1) * ppb],
                neurons_per_pop,
                axis=0,
            ),
            neurons_per_pop,
            axis=1,
        )
        mask = rng.random((b, b)) < prob * synapse_p
        if bi == bj:
            np.fill_diagonal(mask, False)
        if not mask.any():
            continue
        w = rng.gamma(2.0, w_scale / 2.0, size=(b, b)).astype(np.float32) * mask
        w[inhib[bi * b : (bi + 1) * b]] *= -1.0
        srcs.append(int(bi))
        dsts.append(int(bj))
        tiles.append(w)
    syn = BlockSynapses.from_tiles(
        np.array(srcs, dtype=np.int64),
        np.array(dsts, dtype=np.int64),
        np.stack(tiles) if tiles else np.zeros((0, b, b), np.float32),
        n_blocks,
    )
    return syn, pop_of


@dataclasses.dataclass(frozen=True)
class RunResult:
    spikes: torch.Tensor  # [T, M] f32 raster
    v_trace: torch.Tensor  # [T, M] membrane potential ([T, 0] unless recorded)
    final_state: NeuronState
    capture_s: float = 0.0  # seconds spent capturing the step's CUDA graph

    @property
    def rates(self) -> torch.Tensor:
        return self.spikes.mean(dim=0)


@dataclasses.dataclass(frozen=True)
class SNNEngine:
    """Reference (single-device) spiking-network engine.

    Attributes:
      w_syn: ``f32[M, M]`` synaptic weights, ``w[i, j]``: pre ``i`` → post
        ``j`` (a tensor or a numpy array; moved to ``device``).
      params: LIF or Izhikevich constants (includes channel noise).
      i_ext: constant external drive per neuron ``f32[M]`` (or scalar).
      device: where the engine runs; ``None`` means ``"cuda"``, and a
        missing card raises unless ``"cpu"`` is asked for.
      graph: replay the steps from a CUDA graph (``None``: on the card yes,
        on the CPU no; ``True`` on the CPU raises).
    """

    w_syn: torch.Tensor
    params: LIFParams | IzhikevichParams
    i_ext: torch.Tensor | float = 0.0
    device: str | torch.device | None = None
    graph: bool | None = None

    def __post_init__(self):
        dev = resolve_device(self.device)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "graph", graphs.use_graph(self.graph, dev))
        object.__setattr__(
            self, "w_syn",
            torch.as_tensor(self.w_syn, dtype=torch.float32, device=dev),
        )

    @property
    def n_neurons(self) -> int:
        return int(self.w_syn.shape[0])

    def _step_fn(self) -> Callable:
        return lif_step if isinstance(self.params, LIFParams) else izhikevich_step

    def run(
        self,
        n_steps: int,
        *,
        seed: int = 0,
        record_v: bool = False,
        current_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    ) -> RunResult:
        """Simulate ``n_steps``.

        Args:
          seed: the noise key is ``PRNGKey(seed)``, as the reference's
            ``key=jax.random.PRNGKey(seed)`` (``noise_sigma > 0`` only).
          current_fn: optional override computing ``I[j]`` from the global
            spike vector — the hook the ``spike_accum`` kernel uses.
        """
        dev = self.device
        m = self.n_neurons
        key = random.PRNGKey(seed, device=dev) if self.params.noise_sigma else None
        state = init_state(m, self.params, key, device=dev)
        step = self._step_fn()
        w = self.w_syn
        i_ext = torch.as_tensor(self.i_ext, dtype=torch.float32, device=dev)
        accumulate = (
            current_fn
            if current_fn is not None
            else lambda spikes, w_syn: spikes @ w_syn
        )
        spikes_out = torch.empty((n_steps, m), dtype=torch.float32, device=dev)
        vs = torch.empty((n_steps, m if record_v else 0), dtype=torch.float32,
                         device=dev)
        prev = torch.zeros((m,), dtype=torch.float32, device=dev)
        t_dev = torch.zeros((1,), dtype=torch.long, device=dev)  # the step counter

        def one_step():
            new, spikes = step(state, accumulate(prev, w) + i_ext, self.params)
            state.v.copy_(new.v)
            state.u.copy_(new.u)
            if key is not None:
                key.copy_(new.key)
            prev.copy_(spikes)
            spikes_out.index_copy_(0, t_dev, spikes[None])
            if record_v:
                vs.index_copy_(0, t_dev, new.v[None])
            t_dev.add_(1)

        capture_s = graphs.run_steps(one_step, n_steps, dev, self.graph, name="snn.engine.step")
        return RunResult(spikes=spikes_out, v_trace=vs, final_state=state,
                         capture_s=capture_s)
