"""CUDA graphs of the port: one step of a main path captured once and
replayed, the counterpart of the reference's ``jax.jit`` (a whole SNN run
under ``lax.scan``, ``repro/snn/engine.py:246``; each decode step and each
prefill bucket, ``repro/serve/engine.py:53-61``; the train step,
``repro/launch/train.py:62``).

A step is a function of no arguments that reads its inputs from tensors it
closes over and writes its state back into them in place (a
``DistributedSNN`` step, an ``SNNEngine`` step, one ``lm.decode_step``,
one ``lm.prefill`` of a bucket's token buffer, one train step with its
AdamW update), so the same tensors serve every call.  :func:`stepper`
returns the step itself when it runs eagerly, or a :class:`StepGraph` that
runs the first call eagerly and replays a CUDA graph of the step from the
second on.

* **Warm-up.**  The first call is a real step, run on the stream the graph
  is captured on.  It fills what a capture cannot make: the loopback
  communicator's index tensors (built from host lists at first use, and an
  H2D copy from pageable memory inside a capture is an error), cuBLAS's
  handle and workspace for that stream, and the kernels' shared-memory
  opt-in (``cudaFuncSetAttribute``).
* **Capture** happens at the second call, and a replay follows it.  The
  capture runs the step's Python once with the device recording, not
  computing: its kernel launches (:data:`~repro_torch.kernels.LAUNCHES`)
  and the bytes it charges to a communicator's ledger are recorded and
  taken back out, so the capture itself counts nothing.
* **Replay** is one graph launch, after which the recorded launches and
  ledger entries are credited again: the counts read exactly what an eager
  step would leave, once per replayed step.
* **Memory.**  ``torch.cuda.graph`` synchronises and empties the caching
  allocator's cache before it begins a capture, so the blocks the eager
  warm-up freed are returned to the device and the capture's private pool
  can take them.
* Tensors the step allocates come from the graph's memory pool (one pool
  per graph unless the caller passes one to share) and keep their
  addresses: what the step returns is the static output of every replay.
  Graphs that share a pool must replay in their capture order, or while
  the outputs of the others are dead: a capture may place its outputs in
  memory another graph of the pool uses for temporaries.
  A step that draws random numbers carries its key in a device tensor
  (:mod:`repro_torch.random`) and writes the next key back into it, so a
  replay advances the stream as an eager step does.

A failed capture or replay raises; nothing falls back to eager.
"""
from __future__ import annotations

import functools
import time
from collections.abc import Callable

import torch

from repro_torch.kernels._build import LAUNCHES

__all__ = ["use_graph", "StepGraph", "stepper", "run_steps"]


def use_graph(graph: bool | None, device: torch.device) -> bool:
    """The engines' switch: ``None`` replays on a CUDA device and runs
    eagerly on the CPU, ``False`` runs eagerly, ``True`` replays and raises
    on the CPU."""
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, got {device}")
    return bool(graph)


class StepGraph:
    """``step()`` run eagerly once, then captured and replayed.

    ``ledger``: an object whose ``step_bytes`` list the step appends to
    (:class:`~repro_torch.snn.comm.LoopbackComm`).  ``pool``: a memory pool
    handle shared with other graphs (``torch.cuda.graph_pool_handle()``);
    ``None`` gives the graph a pool of its own.
    """

    def __init__(
        self,
        step: Callable[[], object],
        device: torch.device,
        *,
        ledger=None,
        pool=None,
    ):
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.step, self.device = step, device
        self.ledger, self.pool = ledger, pool
        self.stream = _capture_stream(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None
        self.launches: dict[str, int] = {}
        self.step_bytes: list[int] = []
        self.capture_s = 0.0
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls == 1:
            return self._on_stream(self.step)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] += n
        if self.ledger is not None:
            self.ledger.step_bytes.extend(self.step_bytes)
        return self.out

    def _on_stream(self, fn):
        """``fn()`` on the capture stream, ordered after and before the
        caller's stream."""
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = fn()
        here.wait_stream(self.stream)
        return out

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        launches = dict(LAUNCHES)
        n_entries = len(self.ledger.step_bytes) if self.ledger is not None else 0
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                self.out = self.step()
        finally:
            self.launches = {k: LAUNCHES[k] - launches[k] for k in LAUNCHES}
            LAUNCHES.update(launches)
            if self.ledger is not None:
                self.step_bytes = self.ledger.step_bytes[n_entries:]
                del self.ledger.step_bytes[n_entries:]
        self.graph = graph
        self.capture_s = time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One warm-up and capture stream per device (as PyTorch keeps one
    default capture stream): cuBLAS keeps a workspace for every stream it
    has run on, so a stream per graph would leave one workspace each."""
    return torch.cuda.Stream(device)


def stepper(step: Callable[[], object], device: torch.device, graph: bool, **kw):
    """``step`` itself (eager) or a :class:`StepGraph` over it (``graph``)."""
    return StepGraph(step, device, **kw) if graph else step


def run_steps(
    step: Callable[[], object],
    n_steps: int,
    device: torch.device,
    graph: bool,
    *,
    probe: Callable[[int, object], None] | None = None,
    **kw,
) -> float:
    """Call ``step()`` ``n_steps`` times through :func:`stepper`, then
    ``probe(t, out)`` with what step ``t`` returned (on the card the static
    output of the replay); returns the capture's seconds (0 when nothing
    was captured)."""
    run = stepper(step, device, graph, **kw)
    for t in range(n_steps):
        out = run()
        if probe is not None:
            probe(t, out)
    return run.capture_s if isinstance(run, StepGraph) else 0.0
