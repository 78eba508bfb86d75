"""``mfu.sim``: the whole simulated step's share of the chip's peak.  The
least time the traced steps need (``counts.sim_step``: the accumulation's
fired rows, the neuron state read and written, the exchanged bytes; the
larger of the operations at the float32 peak and the bytes at the memory
rate), over the wall seconds the same simulations took without the
profiler (``untraced_s``: each traced simulation is run just before,
untraced, under the same drive).  Bound by bytes: a share of the memory
rate, named ``mfu`` as the whole step's share of a peak."""


def read(t):
    wall = t.counters.get("untraced_s")
    if "step_least_ms" not in t.counters or not wall:
        return None
    return 100.0 * t.counters["step_least_ms"] / (wall * 1e3)
