"""A plain model of the continuous-batching scheduler the serving cells
drive: which tokens each served token was computed from.

The engine (the port's ``ServeEngine.generate_continuous``, as the
reference package's) keeps a fixed pool of slots.  Every prompt is
left-padded with token 0 to one prefill length, ``plen``, the next power
of two of the longest (at least 8), and every cache holds ``plen + 2 ·
new`` positions.  The first fill prefills one request a slot; each
prefill's cache replaces the batch's whole, so after the fill every slot
holds the cache of the fill's last request.  Decode steps then run over
all slots at one shared position, from ``plen`` on; each writes its
input's keys and values there.  A slot whose request has its tokens takes
the next queued request: that request is prefilled alone and its cache,
whose positions from ``plen`` on are zero, is copied into the slot.  The
positions are shared, so every position written by a decode step counts
as filled for every slot: a newcomer attends to the zero keys and values
its prefill left between ``plen`` and the current position.

So each served token is the next token of one sequence: the prompt whose
cache the slot held when the request started decoding (``owner``), zero
keys and values at ``[plen, start)``, and the request's own tokens from
``start`` on; its first token comes from its own prompt's prefill.

Both the overwritten first fill and the zero span are faults of the
engine (the reference package's as well), not a chat server's answers:
an engine whose every slot keeps its own prompt's cache serves each
request over ``owner == index`` with no zero span, and this model has to
change with it, or ``correct`` goes false on the repair.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Request:
    """How one request was served.  ``owner``: the request whose padded
    prompt filled the slot's cache at positions ``[0, plen)`` while this
    one decoded; ``start``: the position of its first decode input (its
    token 0); ``zeros``: zero keys and values at ``[plen, start)`` (none
    when ``start == plen``).  Token ``k >= 1`` is predicted at position
    ``start + k - 1``; token 0 by its own prompt's prefill."""

    index: int
    slot: int
    owner: int
    start: int
    tokens: int


@dataclasses.dataclass(frozen=True)
class Schedule:
    plen: int
    max_len: int
    requests: tuple[Request, ...]
    steps: tuple[tuple[tuple[int, int], ...], ...]  # per decode step: (request, token k) made
    prefills: tuple[int, ...]  # requests in prefill order


def plan(lengths, slots: int, new_tokens: int) -> Schedule:
    """The schedule of ``generate_continuous`` over prompts of ``lengths``
    (no end-of-sequence token: every request gets ``new_tokens``)."""
    n = len(lengths)
    plen = max(8, 1 << (max(lengths) - 1).bit_length())
    max_len = plen + 2 * new_tokens
    queue = list(range(n))
    slot_req, slot_left = [-1] * slots, [0] * slots
    made = [0] * n
    info: dict[int, dict] = {}
    prefills = []
    last = None
    for s in range(slots):
        if not queue:
            break
        r = queue.pop(0)
        prefills.append(r)
        made[r] = 1
        slot_req[s], slot_left[s] = r, new_tokens - 1
        info[r] = {"slot": s, "start": plen}
        last = r
    for r in info:
        info[r]["owner"] = last
    steps = []
    pos = plen
    while last is not None and any(r >= 0 for r in slot_req):
        step = []
        for s in range(slots):
            r = slot_req[s]
            if r < 0:
                continue
            if slot_left[s] > 0:
                if pos >= max_len:
                    raise ValueError("a served token past the cache: not modelled")
                step.append((r, made[r]))
                made[r] += 1
                slot_left[s] -= 1
            if slot_left[s] <= 0:
                if queue:
                    r2 = queue.pop(0)
                    prefills.append(r2)
                    made[r2] = 1
                    slot_req[s], slot_left[s] = r2, new_tokens - 1
                    info[r2] = {"slot": s, "start": pos + 1, "owner": r2}
                else:
                    slot_req[s] = -1
        steps.append(tuple(step))
        pos += 1
    reqs = tuple(Request(index=r, slot=info[r]["slot"], owner=info[r]["owner"],
                         start=info[r]["start"], tokens=made[r]) for r in range(n))
    return Schedule(plen=plen, max_len=max_len, requests=reqs, steps=tuple(steps),
                    prefills=tuple(prefills))
