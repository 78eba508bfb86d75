"""``kernels_per_step.sim``: CUDA kernels the device ran a simulated step,
from the profiler's trace of the window (each simulation's first, eager
step and its graph capture included)."""


def read(t):
    steps = t.counters.get("steps")
    if not steps or not t.kernels:
        return None
    return t.kernel_launches / steps
