"""Batched serving engine of the port: prefill + decode over request slots.

Port of ``repro/serve/engine.py``, with its two schedulers:

* **wave batching** (``generate``): requests are padded to a common
  prompt length, prefilled in one shot, decoded in lockstep until the
  wave drains.
* **continuous batching** (``generate_continuous``): a fixed pool of
  decode slots; when a request finishes, the next queued request is
  prefilled (batch-1) and its cache is spliced into the batched cache
  at the freed slot.

Both run under ``torch.inference_mode()`` (under a mesh ``torch.no_grad()``:
DTensor's indexing of a parameter fails in inference mode), for every text architecture the
LM serves (attention K/V caches, Mamba-2 and RG-LRU states, dense MLPs or
experts: ``_tile_cache`` and ``_splice_cache`` walk the nested cache and
treat every ``[R, B, ...]`` leaf alike, as the reference's do); vlm and
audio configs are refused, as the reference's demo engine refuses them.
Prefill (:func:`repro_torch.models.lm.prefill`) runs per bucket ``(batch,
plen, max_len)``, the reference's one compile per bucket
(``repro/serve/engine.py:53-57``): each bucket has a static token buffer,
and with ``graph`` its first call runs eagerly, its second is captured and
every later call replays that CUDA graph, returning the bucket's static
logits and caches (valid until the bucket's next call).  The continuous
scheduler prefills every request at one bucket ``(1, plen, max_len)``.
Decode is one :func:`~repro_torch.models.lm.decode_step` per step over
caches that stay where prefill (or the tiling of the first fill) put them:
the tokens and the position sit in static device tensors and the position
advances on the device.  With ``graph`` (the default on the card, the
counterpart of the reference's jitted decode) the first step of a batch
runs eagerly and the rest replay its CUDA graph (:mod:`repro_torch.graphs`),
one capture per wave of ``generate`` and one per ``generate_continuous``;
``graph=False`` runs every step eagerly.  The decode graphs share one memory
pool of the engine and the prefill graphs another: graphs that share a pool
must replay in their capture order, or one's temporaries overwrite
another's live outputs, and a refill's prefill replays between decode
steps.  Within the prefill pool only one bucket's outputs are live at a
time (a wave's, or the continuous scheduler's while it refills).  A wave
decodes in its prefill's static caches: a later wave of the same bucket
replays into the same tensors, which is safe because the earlier wave has
finished.  ``_tile_cache`` copies every leaf of the continuous scheduler's
batch-1 cache (``slot_pos`` too), so a refill's prefill, replayed into that
bucket's caches, leaves the decode cache as it was.  Sampling and the host's
token bookkeeping stay outside the graphs, as in the reference, and
``_splice_cache`` copies a refill into the captured cache in place.

While the tracer collects (:mod:`repro_torch.obs`: ``obs.enable()`` or a
``torch.profiler`` session) each call is a ``serve.call`` span over a
``serve.prefill`` span per prefill, a ``serve.decode`` span per decode step
and, in the continuous scheduler, a ``serve.schedule`` span of the slot
loop after each step (refills nest in it).  Their arguments are built
only while the tracer collects.

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
reference, and so does ``temperature > 0``: the engine holds the key
``PRNGKey(ServeConfig.seed)`` and each sampled step splits it and draws
``categorical(sub, logits / T)`` (:mod:`repro_torch.random`; on the card the
``threefry`` kernel), the reference's stream.

Under a sharding policy with a mesh (``pol``; the parameters distributed by
``lm.distribute_params``) prefill and decode run sharded
(``lm.prefill`` / ``lm.decode_step`` with ``pol``, every kernel on the
rank's shards), the caches are DTensors at ``lm.cache_specs``' placements,
and every rank samples the same tokens from the gathered logits.  A batch
that the batch axes do not divide (a batch of 1 on a batch axis of 2) runs
with the batch replicated (the policy without its batch axes, as the
reference's dry-run does); ``_tile_cache`` lays the first fill's batch-1
cache out at the batch's placements, ``slot_pos`` kept as without a mesh,
and ``_splice_cache`` moves a batch-1 cache's rows into the rank that holds
the slot.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch import graphs, random
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.obs import trace as obs
from repro_torch.sharding.policies import ShardingPolicy, is_dtensor

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
        pol: ShardingPolicy = ShardingPolicy(),
        device: str | torch.device | None = None,
        graph: bool | None = None,
    ):
        """``graph``: replay prefill buckets and decode steps from CUDA
        graphs (``None``: on the card yes, on the CPU no, under a mesh only
        on a one-rank NCCL mesh; ``True`` on the CPU raises).  ``pol``: the
        sharding policy (the reference takes it third and positionally;
        here it is a keyword, after ``sc``, so the port's callers keep
        their order); under a mesh ``params`` must already be distributed
        (``lm.distribute_params``)."""
        if cfg.modality != "text":
            raise NotImplementedError(f"{cfg.name}: the engine serves text archs, "
                                      f"not {cfg.modality} (as the reference's)")
        self.device = resolve_device(device)
        emb = params["embed"]["tok"]
        if is_dtensor(emb) != (pol.mesh is not None):
            raise ValueError("params must be distributed over the policy's mesh "
                             "(lm.distribute_params), and plain tensors without one")
        if pol.mesh is not None and emb.device_mesh is not pol.mesh:
            raise ValueError("params are distributed over another mesh than the policy's")
        if graph is None and pol.mesh is not None and not _capturable(pol.mesh):
            graph = False  # a collective that cannot be captured: eager by default
        self.graph = graphs.use_graph(graph, self.device)
        self._pool = torch.cuda.graph_pool_handle() if self.graph else None
        self._prefill_pool = torch.cuda.graph_pool_handle() if self.graph else None
        self._prefills: dict[tuple[int, int, int], _Prefill] = {}
        if emb.device.type != self.device.type:
            raise ValueError(f"params lie on {emb.device}, the engine on {self.device}")
        self.cfg, self.params, self.sc, self.pol = cfg, params, sc, pol
        self._key = random.PRNGKey(sc.seed, device=self.device)
        # a device scalar: PyTorch divides by a host scalar as a product with
        # its reciprocal on the card, the reference by the float32 divisor
        self._temperature = torch.tensor(sc.temperature, dtype=torch.float32,
                                         device=self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if is_dtensor(logits):  # every rank samples from the whole rows
            logits = logits.full_tensor()
        logits = logits[..., : self.cfg.vocab_size]
        if self.sc.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        self._key, sub = random.split(self._key)
        scaled = logits / self._temperature.to(logits.dtype)
        return random.categorical(sub, scaled).to(torch.int32)

    def _prefill(self, toks: np.ndarray, max_len: int):
        """``lm.prefill`` of ``toks`` ``[B, plen]`` through its bucket
        ``(B, plen, max_len)``: (logits, caches), the bucket's static
        outputs when it replays."""
        key = (toks.shape[0], toks.shape[1], max_len)
        if key not in self._prefills:
            self._prefills[key] = _Prefill(self, *key, self._policy(toks.shape[0]))
        return self._prefills[key](torch.from_numpy(toks))

    def _policy(self, batch: int) -> ShardingPolicy:
        """The policy for a batch of ``batch`` rows: the engine's, without
        its batch axes when they do not divide the batch (a batch of 1 on a
        batch axis of 2), as the reference's dry-run drops them; DTensor
        cannot flatten a dim it splits unevenly."""
        if self.pol.mesh is None or batch % self.pol.dp_size == 0:
            return self.pol
        return dataclasses.replace(self.pol, batch_axes=())

    def _no_grad(self):
        return torch.inference_mode() if self.pol.mesh is None else torch.no_grad()

    def generate(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32
    ) -> list[list[int]]:
        """Serve all prompts (in waves of ``batch_slots``)."""
        out: list[list[int]] = []
        with self._no_grad():
            for i in range(0, len(prompts), self.sc.batch_slots):
                out.extend(self._wave(prompts[i : i + self.sc.batch_slots], max_new_tokens))
        return out

    # ---- continuous batching ------------------------------------------

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
        with self._no_grad():
            return self._continuous(prompts, max_new_tokens)

    def _continuous(self, prompts, max_new_tokens) -> list[list[int]]:
        b = self.sc.batch_slots
        plen = max(8, 1 << (max(len(p) for p in prompts) - 1).bit_length())
        traced = obs.is_enabled()  # the spans' arguments are built only then
        with obs.span("serve.call", cat="serve", args={
                "requests": len(prompts), "slots": b, "plen": plen,
                "max_new_tokens": max_new_tokens} if traced else None):
            queue = list(range(len(prompts)))
            results: list[list[int]] = [[] for _ in prompts]
            slot_req = [-1] * b  # request id per slot
            slot_left = [0] * b  # tokens remaining per slot

            max_len = plen + max_new_tokens * 2  # headroom across refills

            def prefill(r, s_, refill):
                """Request ``r`` prefilled into slot ``s_`` (spliced into the
                batch's cache on a ``refill``), its first token sampled and read
                back; returns its batch-1 cache."""
                t = np.zeros((1, plen), np.int32)
                p = prompts[r][-plen:]
                t[0, plen - len(p):] = p
                with obs.span("serve.prefill", cat="serve", args={
                        "req": r, "slot": s_, "prompt_tokens": len(p), "padded_tokens": plen,
                        "refill": refill} if traced else None):
                    logits, c1 = self._prefill(t, max_len)
                    if refill:
                        _splice_cache(caches, c1, s_)
                    tok[s_] = int(self._sample(logits)[0])
                results[r].append(int(tok[s_]))
                slot_req[s_], slot_left[s_] = r, max_new_tokens - 1
                return c1

            caches = None
            tok = np.zeros(b, np.int32)
            for s_ in range(b):
                if not queue:
                    break
                # a batch-1 cache is replaced whole, as the reference's splice does
                caches = prefill(queue.pop(0), s_, False)
            if caches is None:
                return results
            pol = self._policy(b)
            specs = None if pol.mesh is None else lm.cache_specs(self.cfg, pol)
            caches = _tile_cache(caches, b, pol, specs)  # the decode graph captures these tensors
            decode = _Decode(self, caches, b, plen, pol)
            step = 0
            while any(sr >= 0 for sr in slot_req):
                with obs.span("serve.decode", cat="serve", args={
                        "step": step, "live": b - slot_req.count(-1)} if traced else None):
                    logits = decode(torch.from_numpy(tok))
                    nxt = self._sample(logits).cpu().numpy()
                step += 1
                with obs.span("serve.schedule", cat="serve"):
                    for s_ in range(b):
                        r = slot_req[s_]
                        if r < 0:
                            continue
                        done = slot_left[s_] <= 0 or (
                            self.sc.eos_id is not None and results[r]
                            and results[r][-1] == self.sc.eos_id
                        )
                        if not done:
                            results[r].append(int(nxt[s_]))
                            tok[s_] = int(nxt[s_])
                            slot_left[s_] -= 1
                        if slot_left[s_] <= 0:
                            if queue:  # refill the freed slot immediately
                                prefill(queue.pop(0), s_, True)
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
        pol = self._policy(b)
        traced = obs.is_enabled()  # the spans' arguments are built only then
        with obs.span("serve.call", cat="serve", args={
                "requests": b, "slots": b, "plen": plen,
                "max_new_tokens": max_new_tokens} if traced else None):
            with obs.span("serve.prefill", cat="serve", args={
                    "requests": b, "prompt_tokens": sum(map(len, prompts)),
                    "padded_tokens": plen * b} if traced else None):
                # decode writes into the bucket's caches: safe, as the bucket's
                # next call (a later wave) comes after this wave has finished
                logits, caches = self._prefill(toks, plen + max_new_tokens)
                tok = self._sample(logits)
                t = tok.cpu().numpy()
            results: list[list[int]] = [[] for _ in range(b)]
            done = np.zeros(b, bool)
            decode = _Decode(self, caches, b, plen, pol)
            for step in range(max_new_tokens):
                for r in range(b):
                    if not done[r]:
                        results[r].append(int(t[r]))
                        if self.sc.eos_id is not None and t[r] == self.sc.eos_id:
                            done[r] = True
                if done.all():
                    break
                with obs.span("serve.decode", cat="serve", args={
                        "step": step, "live": int(b - done.sum())} if traced else None):
                    tok = self._sample(decode(tok))
                    t = tok.cpu().numpy()
        return results


class _Prefill:
    """One prefill bucket ``(batch, plen, max_len)``: ``lm.prefill`` over a
    static token buffer ``[batch, plen]``, run eagerly or, on the card,
    captured at its second call and replayed from then on, in the engine's
    prefill pool.  Calling it with tokens ``[batch, plen]`` (on any device)
    returns (logits, caches), valid until the bucket's next call."""

    def __init__(self, eng: ServeEngine, batch: int, plen: int, max_len: int,
                 pol: ShardingPolicy):
        tokens = torch.zeros((batch, plen), dtype=torch.int32, device=eng.device)
        params, cfg = eng.params, eng.cfg

        def step():  # refers to no engine: the engine holds this bucket, no cycle
            return lm.prefill(params, {"tokens": tokens}, cfg, max_len=max_len, pol=pol)

        self.tokens = tokens
        self.run = graphs.stepper(step, eng.device, eng.graph, name="serve.prefill",
                                  pool=eng._prefill_pool)

    def __call__(self, tokens: torch.Tensor):
        self.tokens.copy_(tokens)
        return self.run()


class _Decode:
    """Decode steps of one batch: ``lm.decode_step`` over caches that stay
    in place, its tokens ``[B, 1]`` and position in static device tensors
    (the position advances on the device), run eagerly or, on the card,
    replayed from a CUDA graph after the first step.  Calling it with the
    batch's tokens ``[B]`` returns the step's logits ``[B, Vp]``, valid
    until the next call."""

    def __init__(self, eng: ServeEngine, caches: list[dict], batch: int, pos: int,
                 pol: ShardingPolicy | None = None):
        dev = eng.device
        pol = eng.pol if pol is None else pol
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        position = torch.full((), pos, dtype=torch.int32, device=dev)

        def step() -> torch.Tensor:  # refers to no _Decode: no cycle keeps the graph alive
            logits, _ = lm.decode_step(eng.params, caches, {"tokens": tokens}, position, eng.cfg,
                                       pol=pol)
            position.add_(1)
            return logits.full_tensor() if is_dtensor(logits) else logits

        self.tokens = tokens
        self.run = graphs.stepper(step, dev, eng.graph, name="serve.decode", pool=eng._pool)

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens.reshape(self.tokens.shape))
        return self.run()


def _capturable(mesh) -> bool:
    """Decode steps over ``mesh`` replay from a CUDA graph by default only
    on an NCCL mesh of one rank, the one where capture was shown on the
    card (its collectives are no-ops; gloo's are not capturable, and NCCL
    across ranks has not run here)."""
    import torch.distributed as dist

    return mesh.size() == 1 and dist.get_backend() == "nccl"


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts / lists of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _whole_batch(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor leaf ``[R, B, ...]`` with the batch dim
    gathered whole (the other dims keep their placements)."""
    from torch.distributed.tensor import Replicate, Shard

    rep = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in x.placements]
    return x.redistribute(x.device_mesh, rep).to_local()


def _tile_cache(cache, b: int, pol: ShardingPolicy = ShardingPolicy(), specs=None):
    """Broadcast a batch-1 cache to b slots (every slot a copy of slot 0);
    the other leaves (``slot_pos``) are copied as they are.  No leaf shares
    storage with ``cache``: a later prefill replayed into the batch-1
    bucket's caches leaves the tiled cache as it was.  Under a mesh the
    tiled leaves are laid out at ``specs``' placements under ``pol``, each
    rank tiling its own rows of the batch-1 cache's gathered row."""
    def tile(x, spec=None):
        if not (x.dim() >= 2 and x.shape[1] == 1):  # [R, B=1, ...] per-layer stacks
            return x.clone()
        shape = (x.shape[0], b) + tuple(x.shape[2:])
        if not is_dtensor(x):
            return x.expand(shape).clone()
        row = _whole_batch(x)
        local, _ = pol.local_box(shape, spec=spec)
        t = row.expand((row.shape[0], local[1]) + tuple(row.shape[2:])).clone()
        if tuple(t.shape) != local:
            raise ValueError(f"batch-1 shard {tuple(row.shape)} does not tile to {local}")
        return pol.from_local(t, shape, spec=spec)
    return _tree_map(tile, cache) if specs is None else _tree_map(tile, cache, specs)


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
            if is_dtensor(bc):  # the rank holding batch row ``slot`` writes it
                from torch.distributed.tensor._utils import (
                    compute_local_shape_and_global_offset,
                )

                src = _whole_batch(sc_)
                _, off = compute_local_shape_and_global_offset(
                    tuple(bc.shape), bc.device_mesh, bc.placements)
                loc, i = bc.to_local(), slot - off[1]
                if 0 <= i < loc.shape[1]:
                    loc[:, i] = src[:, 0].to(loc.dtype)
            elif bc.shape[1] == 1:
                bc.copy_(sc_)
            else:
                bc[:, slot] = sc_[:, 0].to(bc.dtype)
    _tree_map(splice, batched, single)
    return batched
