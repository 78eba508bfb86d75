"""``device_idle.serve``: the share of the untraced twin of the traced window in
which no operation ran on the device: one minus the device's busy seconds
in the traced window (kernels, copies and fills, from the profiler's
trace) over the wall seconds the same work took without the profiler
(``untraced_s``), so that the profiler's own cost on the host does not
count as idle."""


def read(t):
    wall = t.counters.get("untraced_s")
    if not wall or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / wall)
