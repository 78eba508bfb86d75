"""Batched serving engine of the port: prefill + decode over request slots.

Port of ``repro/serve/engine.py``, with its two schedulers:

* **wave batching** (``generate``): requests are padded to a common
  prompt length, prefilled in one shot, decoded in lockstep until the
  wave drains.
* **continuous batching** (``generate_continuous``): a fixed pool of
  decode slots; when a request finishes, the next queued request is
  prefilled (batch-1) and its cache is spliced into the batched cache
  at the freed slot.

Both run under ``torch.inference_mode()``, for every text architecture the
LM serves (attention K/V caches, Mamba-2 and RG-LRU states, dense MLPs or
experts: ``_tile_cache`` and ``_splice_cache`` walk the nested cache and
treat every ``[R, B, ...]`` leaf alike, as the reference's do); vlm and
audio configs are refused, as the reference's demo engine refuses them.  Prefill
(:func:`repro_torch.models.lm.prefill`) runs eagerly.  Decode is one
:func:`~repro_torch.models.lm.decode_step` per step over caches that stay
where prefill (or the tiling of the first fill) put them: the tokens and
the position sit in static device tensors and the position advances on the
device.  With ``graph`` (the default on the card, the counterpart of the
reference's jitted decode) the first step of a batch runs eagerly and the
rest replay its CUDA graph (:mod:`repro_torch.graphs`), one capture per
wave of ``generate`` and one per ``generate_continuous``, all in one memory
pool of the engine; ``graph=False`` runs every step eagerly.  Sampling and
the host's token bookkeeping stay outside the graph, as in the reference,
and ``_splice_cache`` copies a refill into the captured cache in place.

The schedules, and the reference's quirks, are kept as they are: the
initial fill of ``generate_continuous`` leaves every slot with the last
prefilled request's cache (``_splice_cache`` into a batch-1 cache
overwrites it whole, where the reference replaces it), a newcomer
attends to the zero K/V its prefill left in slots ``[plen, pos)`` because
``slot_pos`` is shared by the batch and not spliced, left-padding tokens
(0) enter the SSM and RG-LRU states and, in a mixture of experts, all
choose the same experts and take their capacity before the prompt does
(each batch row is a dispatch group), and both schedulers run one decode
step past the last token they keep.  Greedy decoding matches the
reference; ``temperature > 0`` samples with a ``torch.Generator`` seeded from
``ServeConfig.seed``, whose streams differ from ``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm

__all__ = ["ServeConfig", "ServeEngine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    batch_slots: int = 4
    temperature: float = 0.0
    eos_id: int | None = None
    seed: int = 0


class ServeEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: dict,
        sc: ServeConfig = ServeConfig(),
        *,
        device: str | torch.device | None = None,
        graph: bool | None = None,
    ):
        """``graph``: replay decode steps from CUDA graphs (``None``: on the
        card yes, on the CPU no; ``True`` on the CPU raises)."""
        if cfg.modality != "text":
            raise NotImplementedError(f"{cfg.name}: the engine serves text archs, "
                                      f"not {cfg.modality} (as the reference's)")
        self.device = resolve_device(device)
        self.graph = graphs.use_graph(graph, self.device)
        self._pool = torch.cuda.graph_pool_handle() if self.graph else None
        emb = params["embed"]["tok"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params lie on {emb.device}, the engine on {self.device}")
        self.cfg, self.params, self.sc = cfg, params, sc
        self._gen = torch.Generator(device=self.device).manual_seed(sc.seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits[..., : self.cfg.vocab_size]
        if self.sc.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[..., 0].to(torch.int32)

    def _tokens(self, toks: np.ndarray) -> dict:
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    @torch.inference_mode()
    def generate(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32
    ) -> list[list[int]]:
        """Serve all prompts (in waves of ``batch_slots``)."""
        out: list[list[int]] = []
        for i in range(0, len(prompts), self.sc.batch_slots):
            out.extend(self._wave(prompts[i : i + self.sc.batch_slots], max_new_tokens))
        return out

    # ---- continuous batching ------------------------------------------

    @torch.inference_mode()
    def generate_continuous(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32
    ) -> list[list[int]]:
        """Slot-based continuous batching.

        Every prompt is left-padded to one prefill length bucket, so all
        slots share the decode position; requests enter the moment a slot
        frees.  Caches hold ``plen + 2 * max_new_tokens`` slots; with many
        queued requests the position can pass that, and later writes are
        no-ops (the reference's behaviour).
        """
        b = self.sc.batch_slots
        plen = max(8, 1 << (max(len(p) for p in prompts) - 1).bit_length())
        queue = list(range(len(prompts)))
        results: list[list[int]] = [[] for _ in prompts]
        slot_req = [-1] * b  # request id per slot
        slot_left = [0] * b  # tokens remaining per slot

        def padded(r):
            t = np.zeros((1, plen), np.int32)
            p = prompts[r][-plen:]
            t[0, plen - len(p):] = p
            return self._tokens(t)

        max_len = plen + max_new_tokens * 2  # headroom across refills

        def prefill(r):
            return lm.prefill(self.params, padded(r), self.cfg, max_len=max_len)

        caches = None
        tok = np.zeros(b, np.int32)
        for s_ in range(b):
            if not queue:
                break
            r = queue.pop(0)
            logits, c1 = prefill(r)
            tok[s_] = int(self._sample(logits)[0])
            results[r].append(int(tok[s_]))
            slot_req[s_], slot_left[s_] = r, max_new_tokens - 1
            if caches is None:
                caches = c1
            else:
                _splice_cache(caches, c1, s_)
        if caches is None:
            return results
        caches = _tile_cache(caches, b)  # the decode graph captures these tensors
        decode = _Decode(self, caches, b, plen)
        while any(sr >= 0 for sr in slot_req):
            logits = decode(torch.from_numpy(tok))
            nxt = self._sample(logits).cpu().numpy()
            for s_ in range(b):
                r = slot_req[s_]
                if r < 0:
                    continue
                done = slot_left[s_] <= 0 or (
                    self.sc.eos_id is not None and results[r] and results[r][-1] == self.sc.eos_id
                )
                if not done:
                    results[r].append(int(nxt[s_]))
                    tok[s_] = int(nxt[s_])
                    slot_left[s_] -= 1
                if slot_left[s_] <= 0:
                    if queue:  # refill the freed slot immediately
                        r2 = queue.pop(0)
                        logits2, c1 = prefill(r2)
                        _splice_cache(caches, c1, s_)
                        tok[s_] = int(self._sample(logits2)[0])
                        results[r2].append(int(tok[s_]))
                        slot_req[s_], slot_left[s_] = r2, max_new_tokens - 1
                    else:
                        slot_req[s_] = -1
        return results

    def _wave(self, prompts, max_new_tokens) -> list[list[int]]:
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        plen = max(8, 1 << (plen - 1).bit_length())  # pad to pow2
        toks = np.zeros((b, plen), np.int32)
        for r, p in enumerate(prompts):
            toks[r, plen - len(p) :] = p  # left-pad (keeps last token hot)
        logits, caches = lm.prefill(
            self.params, self._tokens(toks), self.cfg, max_len=plen + max_new_tokens
        )
        results: list[list[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        tok = self._sample(logits)
        decode = _Decode(self, caches, b, plen)
        for _ in range(max_new_tokens):
            t = tok.cpu().numpy()
            for r in range(b):
                if not done[r]:
                    results[r].append(int(t[r]))
                    if self.sc.eos_id is not None and t[r] == self.sc.eos_id:
                        done[r] = True
            if done.all():
                break
            tok = self._sample(decode(tok))
        return results


class _Decode:
    """Decode steps of one batch: ``lm.decode_step`` over caches that stay
    in place, its tokens ``[B, 1]`` and position in static device tensors
    (the position advances on the device), run eagerly or, on the card,
    replayed from a CUDA graph after the first step.  Calling it with the
    batch's tokens ``[B]`` returns the step's logits ``[B, Vp]``, valid
    until the next call."""

    def __init__(self, eng: ServeEngine, caches: list[dict], batch: int, pos: int):
        dev = eng.device
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        position = torch.full((), pos, dtype=torch.int32, device=dev)

        def step() -> torch.Tensor:  # refers to no _Decode: no cycle keeps the graph alive
            logits, _ = lm.decode_step(eng.params, caches, {"tokens": tokens}, position, eng.cfg)
            position.add_(1)
            return logits

        self.tokens = tokens
        self.run = graphs.stepper(step, dev, eng.graph, pool=eng._pool)

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens.reshape(self.tokens.shape))
        return self.run()


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts / lists of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _tile_cache(cache, b: int):
    """Broadcast a batch-1 cache to b slots (every slot a copy of slot 0)."""
    def tile(x):
        if x.dim() >= 2 and x.shape[1] == 1:  # [R, B=1, ...] per-layer stacks
            return x.expand((x.shape[0], b) + tuple(x.shape[2:])).clone()
        return x
    return _tree_map(tile, cache)


def _splice_cache(batched, single, slot: int):
    """Copy a batch-1 cache into slot ``slot`` of a batched cache, in place
    (a decode graph may hold its tensors).  A batch-1 cache is overwritten
    whole, whatever ``slot``: the reference returns the new cache there.
    Returns ``batched``."""
    def splice(bc, sc_):
        if (
            bc.dim() >= 2
            and sc_.dim() == bc.dim()
            and sc_.shape[1] == 1
            and bc.shape[0] == sc_.shape[0]
        ):
            if bc.shape[1] == 1:
                bc.copy_(sc_)
            else:
                bc[:, slot] = sc_[:, 0].to(bc.dtype)
    _tree_map(splice, batched, single)
    return batched
