"""Ranks in processes of their own: the card each one takes, and a harness
that runs a function in ``n`` ranks of one ``torch.distributed`` group.

:func:`rank_device` is the rule every process-group entry point follows.
Under NCCL local rank ``i`` takes card ``i``: one card per rank, since
NCCL refuses two ranks on one card.  Under gloo on the card the ranks
share the cards round robin, card ``i mod count`` (every rank on card 0 of
a one-card machine), and their collectives are staged through host
buffers (:class:`repro_torch.snn.ProcessGroupComm`).

:func:`spawn` starts ``n`` processes (the ``spawn`` start method, through
``torch.multiprocessing``, so a tensor in shared memory reaches every rank
without a copy), joins them through a ``file://`` store in a directory of
their own (no TCP port, so runs side by side never collide), calls
``fn(rank, n, *args)`` in each and returns the ranks' results in rank
order.  A rank that raises fails the call with its traceback; ranks that
outlast ``timeout`` seconds (a collective posted by some ranks only
hangs) are killed, and the call fails.  ``fn`` must be importable by the
spawned processes: defined at the top of a module.
"""
from __future__ import annotations

import datetime
import pickle
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["rank_device", "spawn"]


def rank_device(backend: str, device_type: str, local_rank: int) -> torch.device:
    """The device of a process rank: the CPU, or under NCCL the card of its
    local rank, or under gloo one of the cards shared round robin."""
    if device_type == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a process rank on the card, but CUDA sees no card")
    if backend == "nccl":
        if local_rank >= count:
            raise RuntimeError(
                f"NCCL takes one card per rank: local rank {local_rank} of a host "
                f"with {count} card(s); run several ranks on one card with gloo"
            )
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % count)


def spawn(fn, n: int, *args, backend: str = "gloo", device: str = "cpu",
          timeout: float = 120.0, workdir: str | Path | None = None) -> list:
    """``[fn(rank, n, *args) for rank in range(n)]``, each rank in a process
    of its own, in a ``backend`` process group on ``device`` (``"cpu"`` or
    ``"cuda"``; a rank on the card has its :func:`rank_device` set as the
    current one).  ``workdir`` holds the store and the results (a fresh
    temporary directory when omitted)."""
    if workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return spawn(fn, n, *args, backend=backend, device=device, timeout=timeout,
                         workdir=tmp)
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, n, backend, device, str(work), timeout, args))
             for rank in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {n} still running after {timeout} s")
    out = []
    for rank, p in enumerate(procs):
        path = work / f"rank{rank}.pkl"
        if not path.exists():
            raise RuntimeError(f"rank {rank} died (exit code {p.exitcode})")
        status, value = pickle.loads(path.read_bytes())
        if status != "ok":
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        out.append(value)
    return out


def _rank_main(fn, rank: int, n: int, backend: str, device: str, work: str,
               timeout: float, args) -> None:
    torch.set_num_threads(1)  # one core per rank: more made 8 CPU ranks ~100x slower
    out = Path(work, f"rank{rank}.pkl")
    try:
        dev = rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{work}/store", rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=timeout))
        out.write_bytes(pickle.dumps(("ok", fn(rank, n, *args))))
    except BaseException:
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))  # the parent reports it
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
