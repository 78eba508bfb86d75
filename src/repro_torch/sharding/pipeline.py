"""GPipe-style pipeline parallelism over one axis of a communicator's mesh.

Port of ``repro/sharding/pipeline.py`` onto the port's collective layer
(:mod:`repro_torch.snn.comm`): stages hold contiguous layer blocks, and
microbatches flow through the pipeline by ``ppermute`` rotation.  The
schedule is the reference's fill-drain: with S stages and M microbatches
the loop runs S+M−1 ticks; each tick every stage applies its block to the
microbatch it holds, the result is kept only where the stage is active
(``stage <= t < stage + M``), and activations rotate one stage forward.
The last stage deposits its finished microbatches, and a final ``psum``
over the axis gives every stage the output.  Bubble fraction =
(S−1)/(S+M−1).

The stage parameters are stacked over the ranks the communicator holds:
under :class:`~repro_torch.snn.comm.LoopbackComm` on a ``(S,)`` mesh their
leading dim holds all S stages on one device, under
:class:`~repro_torch.snn.comm.ProcessGroupComm` the rank's own stage.
``stage_fn`` is called once per held stage and tick, in a Python loop (not
``vmap``), so a stage may launch a hand-written kernel.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

__all__ = ["gpipe", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + n_microbatches - 1)


def _stages(comm, axis: str) -> tuple[int, list[int]]:
    """The number of stages over ``axis`` and the stage of each held rank."""
    if axis == "slow":
        return comm.g, [rank // comm.r for rank in comm.ranks]
    if axis == "joint":
        return comm.n_dev, list(comm.ranks)
    raise ValueError(f"gpipe runs over 'slow' or 'joint', not {axis!r}")


def _stage_params(tree, i: int):
    if isinstance(tree, dict):
        return {k: _stage_params(v, i) for k, v in tree.items()}
    return tree[i]


def gpipe(stage_fn: Callable, comm, *, axis: str = "slow", n_microbatches: int) -> Callable:
    """Build a pipelined apply: ``(stage_params, x) -> y``.

    Args:
      stage_fn: per-stage transform ``f(params_for_stage, x_mb) -> x_mb``.
      comm: a communicator whose mesh holds ``axis`` (its size = number of
        stages; on a ``(G, R)`` mesh ``"slow"`` pipelines each inner
        position's G ranks).
      n_microbatches: must be ≥ 1 and divide the batch dim.

    stage_params: nested dicts of tensors whose leading dim is
    ``len(comm.ranks)``, entry ``i`` the stage of held rank ``comm.ranks[i]``.
    x: [B, ...] activations, the same on every rank.  Returns y: [B, ...]
    after all stages, the same on every rank.
    """
    n_stages, held = _stages(comm, axis)
    if n_microbatches < 1:
        raise ValueError("n_microbatches must be >= 1")
    perm = tuple((i, (i + 1) % n_stages) for i in range(n_stages))

    def run(stage_params, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n_microbatches:
            raise ValueError(f"batch {x.shape[0]} does not split into {n_microbatches}")
        mbs = x.reshape((n_microbatches, x.shape[0] // n_microbatches) + tuple(x.shape[1:]))
        sps = [_stage_params(stage_params, i) for i in range(len(held))]
        n_held = len(held)
        buf = torch.zeros((n_held,) + tuple(mbs.shape[1:]), dtype=x.dtype, device=x.device)
        out = torch.zeros((n_held,) + tuple(mbs.shape), dtype=x.dtype, device=x.device)
        for t in range(n_stages + n_microbatches - 1):
            rows = []
            for i, stage in enumerate(held):
                b = buf[i]
                if stage == 0:  # stage 0 injects microbatch t (if any remain)
                    b = mbs[t if t < n_microbatches else 0]
                # every stage applies its block; only an active stage keeps it
                y = stage_fn(sps[i], b)
                active = stage <= t < stage + n_microbatches
                b = y if active else b
                if stage == n_stages - 1 and active:  # the last stage deposits
                    out[i, t - (n_stages - 1)] = b
                rows.append(b)
            # rotate activations one stage forward
            buf = comm.ppermute(torch.stack(rows), perm, axis)
        last = torch.tensor([stage == n_stages - 1 for stage in held], device=x.device)
        out = comm.psum(torch.where(last.view((-1,) + (1,) * (out.ndim - 1)), out, 0), axis)
        return out[0].reshape(x.shape)

    return run
