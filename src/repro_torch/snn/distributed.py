"""Distributed SNN engine — the paper's simulation system, port of
``repro.snn.distributed``.

Neurons are assigned to ranks by **Algorithm 1** (the partition result is
realized as a physical permutation), local dynamics run independently per
rank, and the per-step spike exchange follows one of

* ``exchange='flat'``      — every rank broadcasts its spikes to every
  other rank (the paper's direct P2P baseline: ``all_gather`` over the
  joint mesh axes);
* ``exchange='two_level'`` — the paper's two-level routing: gather inside
  the group (level-1, fast axis), then one aggregated exchange across
  groups (level-2, slow axis);
* ``exchange='sparse'``    — the routing-table-driven exchange: the block
  mask schedules masked ``ppermute`` rounds over the slow axis so only the
  blocks somebody consumes ever move (:mod:`repro_torch.snn.sparse`);
* ``exchange='ragged'``    — the bridge-compacted, column-pruned exchange
  (:mod:`repro_torch.snn.ragged`): each scheduled cross-group pair moves
  one packed payload bridge to bridge, re-broadcast over the fast axis.

All four deliver the same effective global spike vector; what changes is
the collective schedule — message counts and bytes, which the
communicator's ledger records per step.

An engine runs the ranks its communicator holds (:mod:`repro_torch.snn.comm`),
as tensors stacked over them ``[len(comm.ranks), ...]``, and every step
updates them all at once: behind a
:class:`~repro_torch.snn.comm.LoopbackComm` (the default) every rank of
the mesh on one device; behind a
:class:`~repro_torch.snn.comm.ProcessGroupComm` one rank per process over
``torch.distributed`` (NCCL, or gloo), where :meth:`DistributedSNN.run`
returns that rank's raster and :func:`gather_raster` assembles the global
one.  Rank ``d`` draws its noise under row ``d`` of
``random.split(PRNGKey(seed), n_dev)`` wherever it runs, the key the
reference's ``shard_map`` hands device ``d``, so both give its raster.
Synaptic accumulation: ``flat``/``two_level`` multiply ``s_global @
w_block`` with ``torch.matmul`` (the reference leaves that product to XLA
outside any kernel); ``sparse``/``ragged`` run the block-CSR ``I = Σ_k
s_blk[src_ids[k]] @ blocks[k]`` through
:func:`repro_torch.kernels.spike_currents_blocks`, one launch per step for
the ranks held, on their own tiles only.  There is no policy flag: on a
CUDA device that is the hand-written ``spike_accum_blocks`` kernel, on the
CPU its plain version.

A step updates the rank-stacked state in place and writes its raster row
through a device step counter, so it can be captured: on the card the
first step of a run runs eagerly and the rest replay its CUDA graph
(:mod:`repro_torch.graphs`, the counterpart of the reference's ``jax.jit``
over ``lax.scan``), one capture per run.  The graph binds the synapse
tiles, the drive and the index rows by address, so a plan swap
(:meth:`DistributedSNN.with_plan`, :meth:`PlanBuffer.flip`) is captured
anew by the next run; the tiles are never copied.  ``graph=False`` runs
every step eagerly.  A communicator whose collectives a graph cannot
capture (gloo, and NCCL across ranks: ``ProcessGroupComm.capturable``)
needs ``graph=False``: ``graph=True`` raises.

While the tracer collects (:mod:`repro_torch.obs`: ``obs.enable()`` or a
``torch.profiler`` session) a run is an ``snn.run`` span over ``snn.init``
(the step's state, previous spikes and raster) and the steps
(:func:`repro_torch.graphs.run_steps`: ``graph.warmup``, ``graph.capture``,
``graph.steps``).

:meth:`DistributedSNN.trace_step` runs eager steps through a recording
communicator for planlint Layer 2 (:mod:`repro_torch.analysis.traced`).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import convert, graphs, random
from repro_torch.core.routing import pool_block_mask
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import spike_currents_blocks
from repro_torch.obs import trace as obs
from repro_torch.snn.comm import Comm, LoopbackComm
from repro_torch.snn.ragged import RaggedPlan, build_ragged_plan
from repro_torch.snn.sparse import BlockSynapses, exchange_schedule, exchange_volume
from repro_torch.snn.neuron import (
    IzhikevichParams,
    LIFParams,
    NeuronState,
    init_state,
    izhikevich_step,
    lif_step,
)

__all__ = [
    "DistributedSNN",
    "PlanBuffer",
    "gather_raster",
    "partition_permutation",
    "group_mesh_permutation",
    "permute_ranks",
]


def group_mesh_permutation(tb) -> tuple[np.ndarray, tuple[int, int]]:
    """Map an Algorithm-2 :class:`~repro_torch.core.routing.RoutingTable`
    onto a 2-D mesh.

    Returns ``(perm, (G, N/G))``: ``perm`` orders ranks
    group-contiguously (``perm[k]`` is the physical rank at mesh slot
    ``k``), so a mesh of shape ``(G, N/G)`` puts axis 0 (the slow axis)
    across routing groups and axis 1 inside each group.  Requires equal
    group sizes.
    """
    counts = np.bincount(tb.group_of, minlength=tb.n_groups)
    if counts.max() != counts.min():
        raise ValueError(
            f"uneven grouping ({counts.min()}–{counts.max()} devices per "
            "group); a mesh needs equal group sizes"
        )
    perm = np.argsort(tb.group_of, kind="stable")
    return perm, (tb.n_groups, int(counts[0]))


def permute_ranks(
    syn: BlockSynapses, perm: np.ndarray,
    tiles: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[BlockSynapses, tuple[torch.Tensor, torch.Tensor] | None]:
    """Lay the synapses out with mesh slot ``k`` holding device
    ``perm[k]`` (e.g. :func:`group_mesh_permutation` of a new table).

    Returns ``(syn, tiles)``: the relabelled block-CSR, each destination's
    tiles sorted by their new source label, and — given the padded device
    tiles of ``syn`` over every rank (:func:`repro_torch.convert.padded_tiles`)
    — the same tiles moved on their device into the new layout, tile by
    tile (never staged again from the host); ``None`` without them.  The
    drive moves with the blocks: ``i_ext.reshape(n, -1)[perm]``.
    """
    perm = np.asarray(perm, dtype=np.int64)
    n = syn.n_blocks
    if not np.array_equal(np.sort(perm), np.arange(n)):
        raise ValueError(f"perm is not a permutation of the {n} ranks")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    old_dst = syn.dst_of()
    dst, src = inv[old_dst], inv[syn.src_ids]
    order = np.lexsort((src, dst))
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(dst, minlength=n))
    out = BlockSynapses(indptr=indptr, src_ids=src[order], blocks=syn.blocks[order],
                        n_blocks=n)
    if tiles is None:
        return out, None
    src_t, blk = tiles
    if blk.shape[0] != n:
        raise ValueError(f"tiles hold {blk.shape[0]} ranks, not the mesh's {n}")
    k, b = blk.shape[1], syn.block_size
    # flat slots of each stored tile in the padded [n, K] grid, then and now
    old_pos = (old_dst * k + np.arange(syn.nnzb) - syn.indptr[old_dst])[order]
    new_dst = dst[order]
    new_pos = new_dst * k + np.arange(syn.nnzb) - indptr[new_dst]
    moved = torch.zeros_like(blk)
    flat_old, flat_new = blk.view(n * k, b, b), moved.view(n * k, b, b)
    for i, j in zip(old_pos.tolist(), new_pos.tolist()):
        flat_new[j].copy_(flat_old[i])
    new_src = np.zeros((n, k), dtype=np.int32)  # padding points at source 0
    new_src.reshape(-1)[new_pos] = out.src_ids
    return out, (torch.as_tensor(new_src, device=src_t.device), moved)


def partition_permutation(assign: np.ndarray, n_devices: int) -> np.ndarray:
    """Permutation placing neurons device-contiguously per ``assign``.

    Devices must receive equal counts (static shapes) — callers pad the
    assignment upstream if the partition is uneven.
    """
    counts = np.bincount(assign, minlength=n_devices)
    if counts.max() != counts.min():
        raise ValueError(
            f"uneven partition ({counts.min()}–{counts.max()} per device); "
            "equalize counts before building the permutation"
        )
    return np.argsort(assign, kind="stable")


def _step_fn(params):
    return lif_step if isinstance(params, LIFParams) else izhikevich_step


def _init(params, ranks: range, n_dev: int, n_loc: int, seed: int, dev: torch.device):
    """Initial state ``[len(ranks), n_loc]`` of the ranks held; rank ``d``'s
    noise key is row ``d`` of ``split(PRNGKey(seed), n_dev)``, as the
    reference's one key per device over the full mesh (only when the model
    is noisy)."""
    keys = None
    if params.noise_sigma:
        keys = random.split(random.PRNGKey(seed, device=dev), n_dev)[ranks.start:ranks.stop]
    return init_state((len(ranks), n_loc), params, keys, device=dev)


@dataclasses.dataclass(frozen=True)
class DistributedSNN:
    """SNN engine over a 1-D ``(G,)`` or 2-D ``(G, R)`` mesh of ranks.

    Attributes:
      mesh: mesh shape; axis 0 is the slow axis across groups, axis 1 (2-D
        only) the fast axis inside a group.
      w_syn: ``f32[M, M]`` *permuted* synapse matrix (Alg. 1 order), a
        tensor or numpy array.  Optional when ``syn`` is given and
        ``exchange`` is ``'sparse'``/``'ragged'``.
      params: neuron model constants.
      exchange: 'flat' | 'two_level' | 'sparse' | 'ragged' (two_level
        requires a 2-D mesh).
      i_ext: external drive: a scalar, or one value per neuron ``f32[M]``
        in the engine's (permuted) neuron order.
      syn: block-CSR synapse tiles (``exchange='sparse'``/``'ragged'``);
        derived from ``w_syn`` when omitted.  ``syn.n_blocks`` must equal
        the rank count.
      bridge_inner: ``int[G, G]`` inner index of each group's bridge per
        destination group (``exchange='ragged'``); ``None`` spreads bridge
        duty round-robin.
      ragged_scatter: ``'fused'`` (default) lands every round's payload in
        one ``index_add_``; ``'per_round'`` adds each round on its own.
        Bit-identical: each non-trash slot receives at most one value.
      plan: an explicit ragged plan (the double-buffered swap path).
      tiles: ``(src_ids, blocks)``, the padded device tiles of the synapses
        (:func:`repro_torch.convert.padded_tiles`), to share one device copy
        between engines over the same synapses: the rows of the ranks
        ``tile_ranks``; built from them on first use when omitted, and
        owned by the engine from then on (edits to ``syn.blocks`` made
        after that are not seen).
      tile_ranks: the ranks whose rows ``tiles`` holds, in order (``None``:
        every rank of the mesh).  A run must hold ranks among them.
      device: where the ranks live; ``None`` means ``"cuda"``, and a
        missing card raises unless ``"cpu"`` is asked for.
      graph: replay the steps from a CUDA graph (``None``: on the card yes,
        on the CPU no; ``True`` on the CPU raises).
    """

    mesh: tuple[int, ...]
    w_syn: torch.Tensor | np.ndarray | None = None
    params: LIFParams | IzhikevichParams | None = None
    exchange: str = "flat"
    i_ext: float | np.ndarray | torch.Tensor = 0.0
    syn: BlockSynapses | None = None
    bridge_inner: np.ndarray | None = None
    ragged_scatter: str = "fused"
    plan: RaggedPlan | None = None
    tiles: tuple[torch.Tensor, torch.Tensor] | None = None
    tile_ranks: range | None = None
    device: str | torch.device | None = None
    graph: bool | None = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        object.__setattr__(self, "graph", graphs.use_graph(self.graph, self.device))
        object.__setattr__(self, "mesh", tuple(int(x) for x in self.mesh))
        if self.params is None:
            raise ValueError("params is required")
        if len(self.mesh) not in (1, 2):
            raise ValueError(f"mesh {self.mesh} must be (G,) or (G, R)")
        if self.exchange not in ("flat", "two_level", "sparse", "ragged"):
            raise ValueError(self.exchange)
        if self.ragged_scatter not in ("fused", "per_round"):
            raise ValueError(self.ragged_scatter)
        if self.exchange == "two_level" and len(self.mesh) < 2:
            raise ValueError("two_level exchange needs a 2-D mesh")
        if self.w_syn is None and self.syn is None:
            raise ValueError("need w_syn or syn")
        if self.w_syn is None and self.exchange not in ("sparse", "ragged"):
            raise ValueError(f"exchange={self.exchange!r} needs dense w_syn")
        if self.syn is not None and self.syn.n_blocks != self.n_devices:
            raise ValueError(
                f"syn has {self.syn.n_blocks} blocks for {self.n_devices} devices"
            )
        if self.tiles is not None:
            syn, held = self._block_synapses(), self._tile_ranks
            shape = tuple(self.tiles[1].shape)
            if (not isinstance(held, range) or held.step != 1 or not held
                    or held.start < 0 or held.stop > self.n_devices):
                raise ValueError(f"tile_ranks {held!r}: a run of the mesh's "
                                 f"{self.n_devices} ranks")
            if shape[0] != len(held) or shape[2:] != (syn.block_size,) * 2:
                raise ValueError(f"tiles {shape} do not hold these synapses "
                                 f"(ranks {held.start}..{held.stop - 1})")
        elif self.tile_ranks is not None:
            raise ValueError("tile_ranks names the rows of tiles=")
        if self.plan is not None:
            if self.exchange != "ragged":
                raise ValueError("plan= only applies to exchange='ragged'")
            if self.plan.mesh_shape != self._mesh_groups():
                raise ValueError(
                    f"plan mesh {self.plan.mesh_shape} != engine mesh "
                    f"{self._mesh_groups()}"
                )

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.mesh))

    def _mesh_groups(self) -> tuple[int, int]:
        """``(G, R)``: slow-axis size and ranks per group (1-D: R = 1)."""
        return (self.mesh[0], 1) if len(self.mesh) == 1 else (self.mesh[0], self.mesh[1])

    def _drive(self, n_loc: int, ranks: range) -> float | torch.Tensor:
        """The external drive as a scalar or stacked over the ranks held,
        ``[len(ranks), n_loc]``."""
        if np.ndim(self.i_ext) == 0:
            return float(self.i_ext)
        drive = torch.as_tensor(self.i_ext, dtype=torch.float32, device=self.device)
        if drive.numel() != self.n_devices * n_loc:
            raise ValueError(
                f"i_ext has {drive.numel()} values for {self.n_devices * n_loc} neurons"
            )
        return drive.reshape(self.n_devices, n_loc)[ranks.start:ranks.stop]

    @property
    def _tile_ranks(self) -> range:
        return range(self.n_devices) if self.tile_ranks is None else self.tile_ranks

    @functools.cached_property
    def _device_tiles(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Every rank's padded synapse tiles on the device, staged once per
        engine."""
        return convert.padded_tiles(self._block_synapses(), self.device)

    def _tiles_for(self, ranks: range) -> tuple[torch.Tensor, torch.Tensor]:
        """The padded tiles of the ranks held: the rows of ``tiles`` (which
        must hold these ranks), or staged for every rank or for these ranks
        alone, once per engine."""
        if self.tiles is not None:
            held = self._tile_ranks
            if ranks.start < held.start or ranks.stop > held.stop:
                raise ValueError(f"tiles hold ranks {held.start}..{held.stop - 1}, "
                                 f"not {ranks.start}..{ranks.stop - 1}")
            if ranks == held:
                return self.tiles
            lo = ranks.start - held.start
            return tuple(t[lo:lo + len(ranks)] for t in self.tiles)
        if len(ranks) == self.n_devices:
            return self._device_tiles
        cache = self.__dict__.setdefault("_local_tiles", {})
        key = (ranks.start, ranks.stop)
        if key not in cache:
            cache[key] = convert.padded_tiles(self._block_synapses(), self.device, ranks=ranks)
        return cache[key]

    def _dense_w(self) -> torch.Tensor:
        return torch.as_tensor(self.w_syn, dtype=torch.float32, device=self.device)

    def _block_synapses(self) -> BlockSynapses:
        return self.syn if self.syn is not None else self._tiled_w

    @functools.cached_property
    def _tiled_w(self) -> BlockSynapses:
        """``w_syn`` tiled once per engine (its fields never change)."""
        w = self.w_syn
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        return BlockSynapses.from_dense(w, self.n_devices)

    def _ragged_plan(self) -> RaggedPlan:
        """The static ragged level-2 schedule (the explicit ``plan`` when
        set, else planned from the synapse tiles once per engine: planning
        scans every tile)."""
        return self.plan if self.plan is not None else self._planned

    @functools.cached_property
    def _planned(self) -> RaggedPlan:
        return build_ragged_plan(
            self._block_synapses(), self._mesh_groups(),
            bridge_inner=self.bridge_inner,
        )

    def with_plan(
        self, plan: RaggedPlan, *, syn: BlockSynapses | None = None,
        tiles: tuple[torch.Tensor, torch.Tensor] | None = None,
        i_ext: float | np.ndarray | torch.Tensor | None = None,
    ) -> "DistributedSNN":
        """New engine executing ``plan`` (and optionally edited synapse
        tiles) — the flip half of the double-buffered plan swap.  A plan
        with the active plan's :meth:`step_signature` reuses the prepared
        step (the :func:`_sparse_step` cache); without new tiles the new
        engine takes over this engine's device tiles.  A plan on another
        rank layout (:func:`permute_ranks`) comes with its synapses, their
        device ``tiles`` (staged from ``syn`` when omitted) and the drive
        ``i_ext`` in that layout."""
        changes = {"plan": plan} if i_ext is None else {"plan": plan, "i_ext": i_ext}
        if syn is not None:
            return dataclasses.replace(self, syn=syn, tiles=tiles, tile_ranks=None, **changes)
        if tiles is not None:
            raise ValueError("tiles= comes with the synapses they hold (syn=)")
        if self.tiles is not None:
            return dataclasses.replace(self, **changes)
        return dataclasses.replace(self, tiles=self._device_tiles, **changes)

    def step_signature(self) -> tuple:
        """Static signature of the prepared sparse/ragged step: for
        ``'ragged'`` the live rounds' (shift, width, perm), for
        ``'sparse'`` the masked round pair lists.  Engines with equal
        signatures (and equal mesh / params / device) share one prepared
        step; index rows and tiles are inputs."""
        if self.exchange == "ragged":
            plan = self._ragged_plan()
            return (
                "ragged",
                tuple(
                    (rnd.shift, rnd.width, rnd.perm)
                    for rnd in plan.rounds
                    if rnd.pairs
                ),
            )
        syn = self._block_synapses()
        g, r = self._mesh_groups()
        gmask = pool_block_mask(syn.mask(), np.arange(self.n_devices) // r, g)
        return (
            "sparse",
            tuple(tuple(pairs) for pairs in exchange_schedule(gmask)),
        )

    def exchange_stats(self) -> dict[str, int]:
        """Per-step slow-axis receive volume (bytes): the dense schedule vs
        the block-mask-driven one vs the bridge-compacted one."""
        syn = self._block_synapses()
        g, r = self._mesh_groups()
        return exchange_volume(
            syn.mask(),
            mesh_shape=(g, r) if len(self.mesh) > 1 else (g,),
            block_bytes=syn.block_size * 4,
            plan=self._ragged_plan(),
        )

    def run(
        self,
        n_steps: int,
        *,
        seed: int = 0,
        comm: Comm | None = None,
        probe: Callable[[int, torch.Tensor], None] | None = None,
    ) -> torch.Tensor:
        """Simulate the ranks ``comm`` holds; returns their spike raster
        ``[T, len(comm.ranks)·n_loc]`` on the engine's device — the global
        ``[T, M]`` one behind the default :class:`LoopbackComm`
        (:func:`gather_raster` assembles it from process ranks).  Pass
        ``comm`` to read its per-step byte ledger afterwards.  ``probe``
        (optional) is called as ``probe(t, i)`` at each step with the
        synaptic current ``i`` of the ranks held (global order, drive
        excluded)."""
        comm = LoopbackComm(self.mesh, self.device) if comm is None else comm
        if (comm.g, comm.r) != self._mesh_groups():
            raise ValueError(f"communicator mesh {comm.mesh_shape} != engine mesh {self.mesh}")
        if self.graph and not comm.capturable:
            raise ValueError(
                f"graph=True: a CUDA graph cannot capture {type(comm).__name__}"
                f"({getattr(comm, 'backend', '')}) collectives; pass graph=False"
            )
        with obs.span("snn.run", cat="snn", args={"exchange": self.exchange, "steps": n_steps,
                                                  "ranks": len(comm.ranks)}):
            if self.exchange in ("sparse", "ragged"):
                fn, args = self._sparse_callable_and_args(comm.ranks)
                return fn(*args, n_steps=n_steps, seed=seed, comm=comm, probe=probe,
                          graph=self.graph)[0]
            return self._run_dense(n_steps, seed, comm, probe)

    def _run_dense(self, n_steps, seed, comm, probe) -> torch.Tensor:
        """:meth:`run` of ``exchange='flat'`` / ``'two_level'``."""
        ranks = comm.ranks
        w = self._dense_w()
        m = w.shape[0]
        n_dev = self.n_devices
        if m % n_dev:
            raise ValueError("neuron count must divide the device count")
        n_loc, n_held = m // n_dev, len(ranks)
        # rank d holds the incoming-weight column block W[:, d·n_loc:(d+1)·n_loc]
        w_block = w.reshape(m, n_dev, n_loc).permute(1, 0, 2)[ranks.start:ranks.stop]
        w_block = w_block.contiguous()
        step = _step_fn(self.params)
        exchange = self.exchange

        def gather(spikes_loc):
            if exchange == "flat":
                return comm.all_gather(spikes_loc, "joint")
            return comm.all_gather(comm.all_gather(spikes_loc, "inner"), "slow")

        with obs.span("snn.init", cat="snn"):
            drive = self._drive(n_loc, ranks)
            state = _init(self.params, ranks, n_dev, n_loc, seed, self.device)
            prev = torch.zeros((n_held, n_loc), dtype=torch.float32, device=self.device)
            raster = torch.empty((n_steps, n_held, n_loc), dtype=torch.float32,
                                 device=self.device)
            t_dev = torch.zeros((1,), dtype=torch.long, device=self.device)

        def one_step():
            comm.new_step()
            s_global = gather(prev)  # [n_held, M]
            cur = torch.matmul(s_global[:, None, :], w_block)[:, 0]
            _advance(step, state, prev, raster, t_dev, cur + drive, self.params)
            return cur

        graphs.run_steps(one_step, n_steps, self.device, self.graph, name="snn.step",
                         ledger=comm, probe=_global(probe))
        return raster.reshape(n_steps, n_held * n_loc)

    def step_profile(self, n_steps: int = 2, *, seed: int = 0) -> dict[str, float]:
        """Opt-in blocked per-phase host profile of one sparse/ragged run.

        Phases are timed on the host, synchronizing the device at each
        boundary: ``prepare_s`` (looking up the prepared step and staging
        its device inputs), ``first_call_s`` and ``steady_call_s`` (two
        runs of ``n_steps``, each capturing its step's CUDA graph where the
        engine replays), and ``capture_s``, the first run's capture (inside
        ``first_call_s``, as the reference's compile is); plus the
        :meth:`exchange_stats` byte ledger (``bytes_per_step``) and the
        prepared-step cache hit/miss counters.
        Each phase is also a tracer span and the bytes are counters.
        """
        if self.exchange not in ("sparse", "ragged"):
            raise ValueError("step_profile covers exchange='sparse'/'ragged'")

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        prof: dict[str, float] = {}
        with obs.span("snn.step_profile", cat="exec", tid="snn",
                      args={"exchange": self.exchange, "n_steps": n_steps}):
            t = time.perf_counter()
            with obs.span("snn.prepare", cat="exec", tid="snn"):
                fn, args = self._sparse_callable_and_args(range(self.n_devices))
                sync()
            prof["prepare_s"] = time.perf_counter() - t
            for phase in ("first_call", "steady_call"):
                t = time.perf_counter()
                with obs.span(f"snn.{phase}", cat="exec", tid="snn"):
                    _, capture_s = fn(*args, n_steps=n_steps, seed=seed,
                                      comm=LoopbackComm(self.mesh, self.device),
                                      graph=self.graph)
                    sync()
                prof[f"{phase}_s"] = time.perf_counter() - t
                prof.setdefault("capture_s", capture_s)
        stats = self.exchange_stats()
        bytes_step = float(stats[self.exchange])
        prof["bytes_per_step"] = bytes_step
        obs.counter("snn.exchange_bytes",
                    {k: float(v) for k, v in stats.items()}, tid="snn")
        ci = _sparse_step.cache_info()
        prof["step_cache_hits"] = float(ci.hits)
        prof["step_cache_misses"] = float(ci.misses)
        return prof

    def trace_step(self, n_steps: int = 2, *, comm: Comm | None = None):
        """Run ``n_steps`` eager sparse/ragged steps through a recording
        communicator (over ``comm``, by default a :class:`LoopbackComm`)
        and return what they did — the input of planlint's Layer-2 lints
        (:mod:`repro_torch.analysis.traced`): the collective calls of each
        step and the ops that read the device from the host.  On the CPU
        (the tests) nothing waits on a card; an engine on the card traces
        there."""
        if self.exchange not in ("sparse", "ragged"):
            raise ValueError("trace_step covers exchange='sparse'/'ragged'")
        from repro_torch.analysis.traced import trace_run

        eng = dataclasses.replace(self, graph=False) if self.graph else self
        comm = LoopbackComm(self.mesh, self.device) if comm is None else comm
        return trace_run(lambda rec: eng.run(n_steps, comm=rec), comm)

    def _step_key(self) -> "_StepKey":
        return _StepKey(
            mesh=self.mesh,
            params=self.params,
            ragged_scatter=self.ragged_scatter,
            signature=self.step_signature(),
            device=str(self.device),
        )

    def _sparse_callable_and_args(self, ranks: range) -> tuple:
        """The prepared sparse/ragged step plus the device inputs of the
        ranks held — padded synapse tiles, the drive and, for ``'ragged'``,
        the per-round (send, recv) index rows.  Swapping to a plan with an
        equal :meth:`step_signature` reuses the prepared step."""
        src, blocks = self._tiles_for(ranks)  # [n_held, K], [n_held, K, B, B]
        if self.exchange == "ragged":
            idx_rows = tuple(
                torch.as_tensor(
                    np.stack([rnd.send_idx, rnd.recv_idx], axis=1)[ranks.start:ranks.stop],
                    dtype=torch.long, device=self.device,
                )  # [n_held, 2, K_r]
                for rnd in self._ragged_plan().rounds
                if rnd.pairs
            )
        else:
            idx_rows = ()
        fn = _sparse_step(self._step_key())
        return fn, (src, blocks, self._drive(blocks.shape[-1], ranks), idx_rows)


@dataclasses.dataclass(frozen=True)
class _StepKey:
    """Hashable static description of a prepared sparse/ragged step: the
    mesh, neuron constants, the exchange signature
    (:meth:`DistributedSNN.step_signature`) and the device."""

    mesh: tuple[int, ...]
    params: LIFParams | IzhikevichParams
    ragged_scatter: str
    signature: tuple
    device: str


class _SparseStep:
    """A sparse/ragged step prepared for one static signature: the
    schedule's index tensors live on the device, the tiles, the drive and
    the ragged index rows come in as arguments.

    Level-1 (fast axis) gathers the group spike block.  Level-2:

    * ``'sparse'`` — the ``ppermute`` rounds the group-pooled block mask
      schedules, every inner position shipping the full ``R·B`` group
      block;
    * ``'ragged'`` — each scheduled pair moves one packed ``[K_r]``
      payload bridge to bridge (joint-axis ``ppermute``), a fast-axis
      ``psum`` re-broadcasts it in the receiving group, and the payload
      lands in its block slots (pad lanes in a trash slot ``rb``).

    Unneeded blocks and columns never cross the slow axis; their slots
    stay zero and the block-CSR storage holds no weight for them, so the
    raster equals the dense oracle's.  A step runs the ranks its
    communicator holds (:class:`_Held`).
    """

    def __init__(self, key: _StepKey):
        g = key.mesh[0]
        r = key.mesh[1] if len(key.mesh) == 2 else 1
        self.key = key
        self.g, self.r, self.n_dev = g, r, g * r
        self.kind, self.schedule = key.signature
        self.step = _step_fn(key.params)
        # the slot of the group each round's payload came from: (gid - shift) % G
        if self.kind == "ragged":
            self.shifts = [shift for shift, _w, _perm in self.schedule]
        else:
            self.shifts = [s for s, pairs in enumerate(self.schedule, start=1) if pairs]
        self._held: dict[tuple, _Held] = {}

    def held(self, ranks: range, dev: torch.device) -> "_Held":
        """The index tensors of the ranks held, made once per range."""
        key = (ranks.start, ranks.stop, str(dev))
        if key not in self._held:
            rank = torch.arange(ranks.start, ranks.stop, device=dev)
            gid = rank // self.r
            self._held[key] = _Held(
                local=torch.arange(len(ranks), device=dev), gid=gid,
                src_row={s: (gid - s) % self.g for s in self.shifts},
            )
        return self._held[key]

    def _gather_blocks(self, comm, s_grp, held):
        """Sparse level-2: ``[n_held, R·B]`` group blocks → ``[n_held, n_dev,
        B]`` global blocks (zeros where the schedule skipped a transfer)."""
        g, n_dev = self.g, self.n_dev
        n_held, rb = s_grp.shape
        buf = s_grp.new_zeros((n_held, g, rb))
        buf[held.local, held.gid] = s_grp
        for shift, pairs in enumerate(self.schedule, start=1):
            if not pairs:
                continue
            recv = comm.ppermute(s_grp, pairs, "slow")
            # untargeted receivers got zeros and write zeros into an
            # otherwise-untouched slot
            buf[held.local, held.src_row[shift]] = recv
        return buf.reshape(n_held, n_dev, rb // self.r)

    def _gather_blocks_ragged(self, comm, s_grp, idx_rows, held):
        """Ragged level-2: packed bridge-only ``ppermute`` + fast-axis
        broadcast + scatter into block slots, in one ``index_add_`` over
        every round (``'fused'``) or one ``scatter_add_`` per round."""
        g, r, n_dev = self.g, self.r, self.n_dev
        n_held, rb = s_grp.shape
        width = g * (rb + 1)  # one [G, rb + 1] buffer per rank
        fused = self.key.ragged_scatter == "fused"
        if fused:
            own = (held.local * width + held.gid * (rb + 1))[:, None]
            parts = [s_grp.reshape(-1)]
            flat_idx = [(own + torch.arange(rb, device=s_grp.device)).reshape(-1)]
        else:
            buf = s_grp.new_zeros((n_held, g, rb + 1))
            buf[held.local, held.gid, :rb] = s_grp
            buf = buf.reshape(n_held, width)
        for (shift, _width, perm), idx in zip(self.schedule, idx_rows):
            send_idx, recv_idx = idx[:, 0], idx[:, 1]  # [n_held, K_r] each
            payload = torch.gather(s_grp, 1, send_idx)
            recv = comm.ppermute(payload, perm, "joint")
            if r > 1:
                # only the receiving bridge got data; everyone else holds
                # zeros, so a psum is the intra-group broadcast
                recv = comm.psum(recv)
            slot = (held.src_row[shift] * (rb + 1))[:, None] + recv_idx
            if fused:
                parts.append(recv.reshape(-1))
                flat_idx.append((held.local[:, None] * width + slot).reshape(-1))
            else:
                buf.scatter_add_(1, slot, recv)
        if fused:
            buf = s_grp.new_zeros((n_held * width,)).index_add_(
                0, torch.cat(flat_idx), torch.cat(parts)
            )
        buf = buf.reshape(n_held, g, rb + 1)[:, :, :rb]
        return buf.reshape(n_held, n_dev, rb // r)

    def __call__(self, src, blocks, drive, idx_rows, *, n_steps, seed, comm, probe=None,
                 graph=False):
        """Run ``n_steps`` of the ranks ``comm`` holds (replayed from a CUDA
        graph with ``graph``); returns their raster ``[T, n_held·B]`` and
        the capture's seconds."""
        key = self.key
        ranks, b = comm.ranks, blocks.shape[-1]
        dev = blocks.device
        with obs.span("snn.init", cat="snn"):
            held = self.held(ranks, dev)
            state = _init(key.params, ranks, self.n_dev, b, seed, dev)
            prev = torch.zeros((len(ranks), b), dtype=torch.float32, device=dev)
            raster = torch.empty((n_steps, len(ranks), b), dtype=torch.float32, device=dev)
            t_dev = torch.zeros((1,), dtype=torch.long, device=dev)

        def one_step():
            comm.new_step()
            s_grp = comm.all_gather(prev, "inner") if self.r > 1 else prev
            if self.kind == "ragged":
                s_blocks = self._gather_blocks_ragged(comm, s_grp, idx_rows, held)
            else:
                s_blocks = self._gather_blocks(comm, s_grp, held)
            cur = spike_currents_blocks(s_blocks, src, blocks)
            _advance(self.step, state, prev, raster, t_dev, cur + drive, key.params)
            return cur

        capture_s = graphs.run_steps(one_step, n_steps, dev, graph, name="snn.step",
                                     ledger=comm, probe=_global(probe))
        return raster.reshape(n_steps, len(ranks) * b), capture_s


class _Held(NamedTuple):
    """Index tensors of the ranks a step holds: their positions in the
    stack (``local``), their groups (``gid``) and, per round shift, the
    slot of the group a payload came from (``src_row``)."""

    local: torch.Tensor
    gid: torch.Tensor
    src_row: dict[int, torch.Tensor]


def _advance(step, state: NeuronState, prev, raster, t_dev, i_syn, params) -> None:
    """One neuron update of the rank-stacked ``state`` under ``i_syn``, in
    place: the state (its noise keys too) and ``prev`` take the new values,
    and the spikes land
    in raster row ``t_dev``, which then advances."""
    new, spikes = step(state, i_syn, params)
    state.v.copy_(new.v)
    state.u.copy_(new.u)
    if state.key is not None:
        state.key.copy_(new.key)
    prev.copy_(spikes)
    raster.index_copy_(0, t_dev, spikes[None])
    t_dev.add_(1)


def _global(probe):
    """``probe(t, i)`` on the current of the ranks held, ``[n_held·n_loc]``
    in global order, from a rank-stacked one."""
    return None if probe is None else (lambda t, cur: probe(t, cur.reshape(-1)))


def gather_raster(raster: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The global raster ``[T, M]``, on every rank, from the raster of the
    ranks ``comm`` holds (what :meth:`DistributedSNN.run` returns).  A
    collective outside the timed steps: not charged to the ledger."""
    t = raster.shape[0]
    held = raster.reshape(t, len(comm.ranks), -1).transpose(0, 1).contiguous()
    return comm.collect(held).transpose(0, 1).reshape(t, -1)


@functools.lru_cache(maxsize=32)
def _sparse_step(key: _StepKey) -> _SparseStep:
    """The prepared sparse/ragged step for a static signature.  Engines
    whose plans share a signature get the same object, so a plan swap
    only changes the tile and index-row inputs."""
    return _SparseStep(key)


class PlanBuffer:
    """Double-buffered :class:`RaggedPlan` holder for a running engine.

    :meth:`stage` parks a fresh plan (with optionally edited synapse tiles)
    next to the active engine, and :meth:`flip` swaps it in between steps.
    When the staged plan's static signature equals the active one, the
    flipped engine reuses the prepared step via the :func:`_sparse_step`
    cache; :meth:`stage` returns that reuse predicate.
    """

    def __init__(self, engine: DistributedSNN):
        if engine.exchange != "ragged":
            raise ValueError("PlanBuffer double-buffers ragged plans")
        if engine.plan is None:
            engine = engine.with_plan(engine._ragged_plan())
        self._active = engine
        self._staged: DistributedSNN | None = None

    @property
    def engine(self) -> DistributedSNN:
        """The active engine — run steps on this."""
        return self._active

    @property
    def staged(self) -> DistributedSNN | None:
        return self._staged

    def stage(
        self, plan: RaggedPlan, *, syn: BlockSynapses | None = None,
        tiles: tuple[torch.Tensor, torch.Tensor] | None = None,
        i_ext: float | np.ndarray | torch.Tensor | None = None,
    ) -> bool:
        """Park ``plan`` (+ optional new tiles, or a new rank layout: see
        :meth:`DistributedSNN.with_plan`) in the back buffer.

        Returns True when flipping will reuse the active prepared step
        (equal static signatures).
        """
        self._staged = self._active.with_plan(plan, syn=syn, tiles=tiles, i_ext=i_ext)
        return self._staged.step_signature() == self._active.step_signature()

    def flip(self) -> DistributedSNN:
        """Swap the staged engine in and return it (the new active)."""
        if self._staged is None:
            raise RuntimeError("nothing staged — call stage() first")
        self._active, self._staged = self._staged, None
        return self._active
