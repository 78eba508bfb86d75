"""Deterministic synthetic data pipeline with host sharding + prefetch.

Every batch is a pure function of (seed, step, host_shard), so

* restarts replay identically (the fault-tolerance supervisor skips a
  poisoned step by construction),
* each host of a multi-host job materializes only its slice
  (``host_index``/``host_count``), and
* no filesystem or network dependency exists in tests/benchmarks.

Token streams are Zipf-distributed (vocabulary ranks follow natural
text better than uniform, exercising the embedding-gather paths
non-trivially); labels are next-token shifts of the same stream.
Modality stubs: ``vlm`` adds precomputed patch embeddings, ``audio``
emits ``n_codebooks`` parallel streams.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from collections.abc import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    zipf_a: float = 1.2


class SyntheticLM:
    """Deterministic per-step synthetic batches for one host."""

    def __init__(self, arch: ArchConfig, dc: DataConfig):
        if dc.global_batch % dc.host_count:
            raise ValueError("global_batch must divide host_count")
        self.arch = arch
        self.dc = dc
        self.local_batch = dc.global_batch // dc.host_count

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence(
                [self.dc.seed, step, self.dc.host_index]
            )
        )

    def _tokens(self, rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
        v = self.arch.vocab_size
        z = rng.zipf(self.dc.zipf_a, size=shape)
        return ((z - 1) % v).astype(np.int32)

    def __call__(self, step: int) -> dict[str, np.ndarray]:
        rng = self._rng(step)
        b, s = self.local_batch, self.dc.seq_len
        if self.arch.modality == "audio":
            ncb = self.arch.n_codebooks
            stream = self._tokens(rng, (b, s + 1, ncb))
            return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
        if self.arch.modality == "vlm":
            s_text = s - self.arch.vision_tokens
            stream = self._tokens(rng, (b, s_text + 1))
            vis = rng.standard_normal(
                (b, self.arch.vision_tokens, self.arch.d_model), dtype=np.float32
            )
            return {
                "tokens": stream[:, :-1],
                "labels": stream[:, 1:],
                "vision_embed": vis,
            }
        stream = self._tokens(rng, (b, s + 1))
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def iter(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a step-indexed source."""

    def __init__(self, source, depth: int = 2, start_step: int = 0):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self.source(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join()
