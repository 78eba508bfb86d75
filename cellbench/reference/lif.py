"""Plain reference of the distributed SNN run: LIF neurons, the sparse
exchange's bytes, and a raster judged step by step.

The network is chaotic over thousands of steps: a sum taken in another
order moves a membrane potential by an ulp, and a neuron that sits on its
threshold to that ulp then fires one step apart, after which the two runs
part.  So the reference follows the program's raster: at every step it
computes each neuron's update from the program's spikes of the step
before (the currents in float64 from the synapse list, rounded to float32,
as the configuration states float32), decides which neurons cross the
threshold, and then takes the program's spikes for the resets.  It runs in
plain PyTorch on the device it is given (on the card once the program's
state is freed: a sparse float64 product a block of steps, the update a
step), so a check at the cell's size takes seconds.  A spike
the program fired or missed is a disagreement, and its size is how far the
reference's potential lay from the threshold (mV).  A sound run disagrees
only at a rounding's distance from the threshold; a lost message, a wrong
current or a flipped spike disagrees by millivolts.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LIF:
    """Leaky integrate-and-fire constants (mV, ms, MOhm), as the
    configuration states them."""

    tau_m: float = 10.0
    v_rest: float = -65.0
    v_reset: float = -65.0
    v_thresh: float = -50.0
    r_m: float = 10.0
    t_refrac: float = 2.0
    dt: float = 0.1


def weights(pre: np.ndarray, post: np.ndarray, w: np.ndarray, m: int,
            device="cpu") -> torch.Tensor:
    """``W[pre, post]`` transposed, ``W^T[post, pre]``, as a sparse float64
    CSR matrix on ``device`` (what a step's currents are summed with)."""
    order = np.lexsort((pre, post))
    rows = torch.as_tensor(post[order], dtype=torch.int64)
    indptr = torch.zeros(m + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    with warnings.catch_warnings():  # PyTorch's notes that sparse CSR is in beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(indptr, torch.as_tensor(pre[order], dtype=torch.int64),
                                       torch.as_tensor(w[order].astype(np.float64)),
                                       size=(m, m), check_invariants=False).to(device)


def currents(spikes: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """``I[t] = s[t] @ W`` for each row of ``spikes`` ``[T, M]`` (0/1):
    float64 sums rounded to float32."""
    prod = torch.sparse.mm(wt, spikes.to(wt.device, torch.float64).T.contiguous())
    return prod.T.to(torch.float32)


class _Update:
    """One forward-Euler step before the threshold, in the program's float32
    operation order, on ``device``."""

    def __init__(self, p: LIF, device):
        def c(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        self.k, self.rest, self.r_m = c(p.dt / p.tau_m), c(p.v_rest), c(p.r_m)
        self.thresh, self.reset = c(p.v_thresh), c(p.v_reset)
        self.refrac, self.dt, self.zero = c(p.t_refrac), c(p.dt), c(0.0)

    def __call__(self, v, u, i_syn):
        """(candidate potential, refractory mask)."""
        refractory = u > self.zero
        dv = self.k * ((self.rest - v) + self.r_m * i_syn)
        return torch.where(refractory, v, v + dv), refractory

    def after(self, v_new, u, spikes):
        """The potential and refractory time once ``spikes`` have fired."""
        return (torch.where(spikes, self.reset, v_new),
                torch.where(spikes, self.refrac, torch.maximum(u - self.dt, self.zero)))


def judge(raster: np.ndarray, wt: torch.Tensor, drive: np.ndarray, p: LIF,
          block: int = 1000) -> dict:
    """The program's ``raster`` ``[T, M]`` (0/1) held to the reference step by
    step (see the module) on ``wt``'s device, the currents worked out
    ``block`` steps at a time: ``margin_mv``, the widest distance from the
    threshold of a disagreement (0 without one), and ``disagreements``."""
    dev = wt.device
    t_steps, m = raster.shape
    step = _Update(p, dev)
    v = torch.full((m,), p.v_rest, dtype=torch.float32, device=dev)
    u = torch.zeros(m, dtype=torch.float32, device=dev)
    drive = torch.as_tensor(np.asarray(drive, np.float32), device=dev)
    margin = torch.zeros((), dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    prev = torch.zeros((1, m), dtype=torch.bool, device=dev)
    for lo in range(0, t_steps, block):
        s = torch.as_tensor(np.asarray(raster[lo:lo + block], bool), device=dev)
        cur = currents(torch.cat([prev, s[:-1]]), wt)  # I[t] from s[t - 1], s[-1] = 0
        prev = s[-1:]
        for j in range(s.shape[0]):
            v_new, refractory = step(v, u, cur[j] + drive)
            fires = (v_new >= step.thresh) & ~refractory
            off = fires != s[j]
            count += off.sum()
            margin = torch.maximum(margin, torch.where(off, (v_new - step.thresh).abs(),
                                                       step.zero).max())
            v, u = step.after(v_new, u, s[j])
    return {"margin_mv": float(margin), "disagreements": int(count)}


def simulate(wt: torch.Tensor, drive: np.ndarray, steps: int, p: LIF) -> np.ndarray:
    """A free run of the plain network on ``wt``'s device (what the control
    puts in the program's place): raster ``bool[T, M]``."""
    dev = wt.device
    m = wt.shape[0]
    step = _Update(p, dev)
    v = torch.full((m,), p.v_rest, dtype=torch.float32, device=dev)
    u = torch.zeros(m, dtype=torch.float32, device=dev)
    drive = torch.as_tensor(np.asarray(drive, np.float32), device=dev)
    out = torch.zeros((steps, m), dtype=torch.bool, device=dev)
    prev = torch.zeros((m, 1), dtype=torch.float64, device=dev)
    for t in range(steps):
        i_syn = torch.sparse.mm(wt, prev)[:, 0].to(torch.float32) + drive
        v_new, refractory = step(v, u, i_syn)
        spikes = (v_new >= step.thresh) & ~refractory
        v, u = step.after(v_new, u, spikes)
        out[t] = spikes
        prev = spikes.to(torch.float64)[:, None]
    return out.cpu().numpy()


def tf32(w: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest, ties
    away from zero, as the tensor cores' conversion)."""
    bits = np.ascontiguousarray(w, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def sparse_exchange_bytes(stored: np.ndarray, mesh: tuple[int, int], block: int) -> int:
    """Bytes that cross the slow axis in one step of the ``sparse`` exchange
    on a ``(G, R)`` mesh of contiguous ranks: each group sends its whole
    group block (``R · block`` float32 spikes), once from each of its ``R``
    positions, to every other group that holds a tile of one of its ranks."""
    g, r = mesh
    grp = np.arange(stored.shape[0]) // r
    needs = np.zeros((g, g), dtype=bool)
    src, dst = np.nonzero(stored)
    needs[grp[src], grp[dst]] = True
    np.fill_diagonal(needs, False)
    return int(needs.sum()) * r * (r * block * 4)
