"""``k1_roofline.sim``: the synaptic accumulation's share of its roofline.
The least time of the work the window's spikes need (each fired neuron's
row in every stored tile of its block read once, each step's current
written once; ``counts.k1_bytes``) at the chip's peaks, over the device
time of the kernels named in the counters (``spike_accum_ring_kernel`` and
``compact_tiles_kernel``) in the trace."""


def read(t):
    names = t.counters.get("k1_kernels")
    if not names or "k1_least_ms" not in t.counters:
        return None
    seconds, launches = t.device_s(*names)
    if not launches or seconds <= 0:
        return None
    return 100.0 * t.counters["k1_least_ms"] / (seconds * 1e3)
