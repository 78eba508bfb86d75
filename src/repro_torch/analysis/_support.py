"""What the seeded planlint scenarios take from the reference's benchmark
scaffolding, copied so the port imports no ``benchmarks`` module: the
device traffic of a partition and the paper's two-tier fabric
(``benchmarks/common.py``), and the replan benchmark's edit batch
(``benchmarks/replan_bench.py``).  Each function's code equals its
source's (``tests/test_torch_copies.py``)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import device_traffic_csr
from repro_torch.core.replan import symmetric_delta

__all__ = ["build_device_traffic", "paper_fabric", "_edit_batch"]


def build_device_traffic(bm, assign: np.ndarray, n_devices: int):
    """Sparse device-traffic matrix + per-device weights for Algorithm 2.

    All benchmarks route over the CSR path (`device_traffic_csr`) — the
    dense `device_graph` constructor stays available as the parity-oracle
    input but materializes `[N, N]` and should not be used at paper scale.
    `generate_brain_model` builds its CSR with `sym=True` (both directions
    stored), so the symmetry auto-detection pass is skipped.
    """
    return device_traffic_csr(bm.graph, assign, n_devices, sym_mode="both")


def paper_fabric(n_devices: int):
    """Two-tier pod/DCN fabric approximating the paper's machine shape
    for netsim latency replays: ~1% of the devices per pod (20 pods of
    ~100 at the 2,000-GPU scale), oversubscribed spine, pod size
    snapped down so it divides ``n_devices``.  Falls back to a single
    switch when no pod split is possible.
    """
    from repro_torch import netsim

    pod = max(n_devices // 100, 2)
    while pod > 1 and n_devices % pod:
        pod -= 1
    if pod < 2:
        return netsim.single_switch(n_devices)
    return netsim.two_tier(n_devices, pod)


def _edit_batch(tb, eseed, n_edits):
    """Symmetric volume edits localized to two groups of ``tb``."""
    rng = np.random.default_rng(eseed)
    g_a, g_b = rng.choice(tb.n_groups, 2, replace=False)
    mem = np.concatenate([tb.members(int(g_a)), tb.members(int(g_b))])
    s = rng.choice(mem, n_edits)
    d = rng.choice(mem, n_edits)
    keep = s != d
    v = rng.uniform(0.5, 2.0, int(keep.sum()))
    return symmetric_delta(s[keep], d[keep], v)
