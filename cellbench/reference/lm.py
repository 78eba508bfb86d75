"""Plain float32 reference of a dense GQA decoder (the Phi-4-mini block as
the configuration runs it), and the served tokens judged against it.

Per layer: ``x += attention(rmsnorm(x))``, ``x += mlp(rmsnorm(x))``; RMS
norm ``x / sqrt(mean(x²) + eps) · g``; rotary embedding on the first
``partial_rotary_factor`` of each head's dimensions, the two halves of
those rotated (``theta`` from the configuration, angles in float64);
causal attention with grouped keys and values, scores scaled by ``1 /
sqrt(head_dim)``; SwiGLU ``(silu(x Wg) ⊙ x Wu) Wd``; the final norm;
logits against the tied embedding.  No kernel, no cache, no batching: one
sequence at a time, matrix products in float32 with TF32 off.

A sequence is its tokens at their positions and, optionally, positions
whose keys and values are zero in every layer (see
:mod:`cellbench.reference.schedule`): such a position takes part in every
later query's softmax with a score of 0 and adds nothing to its output.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Sequence:
    tokens: np.ndarray  # int [n]
    positions: np.ndarray  # int [n], increasing
    zeros: tuple[int, int] = (0, 0)  # [lo, hi): positions with zero keys and values
    query: np.ndarray = None  # indices into tokens whose logits are wanted


def _rope(x: torch.Tensor, positions: np.ndarray, theta: float,
          fraction: float = 1.0) -> torch.Tensor:
    """x ``[n, h, hd]``; the first ``rd = fraction · hd`` dimensions of each
    head, their two halves rotated by ``pos · theta^(-i / (rd/2))``, the
    rest left as they are."""
    rd = int(round(x.shape[-1] * fraction))
    x, rest = x[..., :rd], x[..., rd:]
    half = rd // 2
    freqs = theta ** (-np.arange(half, dtype=np.float64) / half)
    ang = positions.astype(np.float64)[:, None] * freqs[None, :]
    cos = torch.as_tensor(np.cos(ang), dtype=torch.float32, device=x.device)[:, None, :]
    sin = torch.as_tensor(np.sin(ang), dtype=torch.float32, device=x.device)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], dim=-1)


def _norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def _attention(q, k, v, positions: np.ndarray, zeros: tuple[int, int]) -> torch.Tensor:
    """q ``[n, hq, hd]``, k/v ``[n, hkv, hd]`` at ``positions``; the zero
    positions ``[lo, hi)`` add keys and values of 0."""
    n, hq, hd = q.shape
    group = hq // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [hq, n, hd]
    vv = v.repeat_interleave(group, dim=1).transpose(0, 1)
    qq = q.transpose(0, 1)
    pos = torch.as_tensor(positions, device=q.device)
    s = (qq @ kk.transpose(1, 2)) / math.sqrt(hd)  # [hq, n, n]
    s = s.masked_fill(pos[None, :, None] < pos[None, None, :], float("-inf"))
    lo, hi = zeros
    # zero keys visible to each query: positions in [lo, min(hi, p + 1))
    nz = (torch.clamp(torch.minimum(pos + 1, torch.tensor(hi, device=q.device)) - lo, min=0)
          .to(torch.float32))
    mx = torch.maximum(s.amax(-1), torch.where(nz > 0, 0.0, float("-inf"))[None, :])
    e = torch.exp(s - mx[..., None])
    denom = e.sum(-1) + nz[None, :] * torch.exp(-mx)
    out = (e @ vv) / denom[..., None]
    return out.transpose(0, 1)  # [n, hq, hd]


class Model:
    """The reference over weights ``w`` (float tensors named as
    :func:`cellbench.lmweights.specs`, the norms as offsets from 1) and the
    configuration ``cfg`` (published keys: ``rms_norm_eps``, ``rope_theta``,
    ``partial_rotary_factor``, which defaults to 1; a ``rope_scaling`` is
    not modelled)."""

    def __init__(self, cfg: dict, w: dict[str, torch.Tensor], device, quantize=None):
        """``quantize``: a rounding applied to every weight matrix and to
        every activation that enters a product with one (the control's)."""
        if cfg.get("rope_scaling") is not None:
            raise NotImplementedError("the reference models no rope_scaling")
        self.cfg, self.w, self.eps, self.device = cfg, w, float(cfg["rms_norm_eps"]), device
        self.quantize = quantize or (lambda t: t)

    def _mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.quantize(a) @ w

    def _f(self, name: str, layer: int | None = None) -> torch.Tensor:
        t = self.w[name] if layer is None else self.w[name][layer]
        t = t.to(self.device, torch.float32)
        if name.endswith("norm"):
            return 1.0 + t
        return self.quantize(t)

    def logits(self, seqs: list[Sequence]) -> list[torch.Tensor]:
        """Float32 logits ``[len(query), vocab]`` of each sequence."""
        cfg = self.cfg
        hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        theta = float(cfg["rope_theta"])
        frac = float(cfg.get("partial_rotary_factor", 1.0))
        emb = self._f("embed")
        xs = [emb[torch.as_tensor(s.tokens, device=self.device)] for s in seqs]
        for li in range(cfg["num_hidden_layers"]):
            g1, g2 = self._f("attn_norm", li), self._f("mlp_norm", li)
            wq, wk, wv, wo = (self._f(n, li) for n in ("wq", "wk", "wv", "wo"))
            wg, wu, wd = (self._f(n, li) for n in ("w_gate", "w_up", "w_down"))
            for i, s in enumerate(seqs):
                x = xs[i]
                y = _norm(x, g1, self.eps)
                q = _rope(self._mm(y, wq).view(-1, hq, hd), s.positions, theta, frac)
                k = _rope(self._mm(y, wk).view(-1, hkv, hd), s.positions, theta, frac)
                v = self._mm(y, wv).view(-1, hkv, hd)
                o = _attention(q, k, v, s.positions, s.zeros).reshape(x.shape[0], -1)
                x = x + self._mm(o, wo)
                y = _norm(x, g2, self.eps)
                x = x + self._mm(torch.nn.functional.silu(self._mm(y, wg)) * self._mm(y, wu), wd)
                xs[i] = x
            del wq, wk, wv, wo, wg, wu, wd
        g = self._f("final_norm")
        out = []
        for s, x in zip(seqs, xs):
            h = _norm(x[torch.as_tensor(s.query, device=self.device)], g, self.eps)
            out.append(self._mm(h, emb.T))
        return out


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    at 448), as an operand of an fp8 product would be."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def sequences(sched, prompts: list[list[int]], served: list[list[int]], picks) -> tuple:
    """The sequences whose logits predict the served tokens of requests
    ``picks`` under schedule ``sched``, and for each sequence the served
    tokens its query rows predict (``(request, k)`` pairs)."""
    plen = sched.plen

    def padded(r):
        p = prompts[r][-plen:]
        return np.concatenate([np.zeros(plen - len(p), np.int64), np.asarray(p, np.int64)])

    seqs, targets = [], []
    for r in picks:
        req = sched.requests[r]
        toks = served[r]
        dec = list(range(1, len(toks)))  # tokens predicted by decode steps
        body = np.asarray(toks[:-1], np.int64)  # decode inputs: tokens 0 .. n-2
        own = req.owner == r
        head = padded(req.owner)
        tokens = np.concatenate([head, body])
        positions = np.concatenate([np.arange(plen), req.start + np.arange(body.size)])
        query = plen + np.arange(body.size)
        want = [(r, k) for k in dec]
        if own:  # the prefill's last row predicts token 0
            query = np.concatenate([[plen - 1], query])
            want = [(r, 0)] + want
        else:
            seqs.append(Sequence(tokens=padded(r), positions=np.arange(plen),
                                 query=np.array([plen - 1])))
            targets.append([(r, 0)])
        seqs.append(Sequence(tokens=tokens, positions=positions, zeros=(plen, req.start),
                             query=query))
        targets.append(want)
    return seqs, targets


def gaps(logits: list[torch.Tensor], targets, served, vocab: int) -> np.ndarray:
    """For each served token, how far its logit lies below the best of the
    reference's row (0 where it is the best)."""
    out = []
    for lg, want in zip(logits, targets):
        lg = lg[:, :vocab]
        tok = torch.as_tensor([served[r][k] for r, k in want], device=lg.device)
        out.append((lg.amax(-1) - lg.gather(1, tok[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out)


def control_gaps(ref_logits, low_logits, vocab: int) -> np.ndarray:
    """At every row, how far the token a lower precision puts first lies
    below the reference's best."""
    out = []
    for a, b in zip(ref_logits, low_logits):
        a, b = a[:, :vocab], b[:, :vocab]
        pick = b.argmax(-1)
        out.append((a.amax(-1) - a.gather(1, pick[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out)
