"""``k4_roofline.serve``: the decode attention kernel's share of its
roofline.  For every decode step of the window, the least time of the K/V
bytes of each live slot's real tokens (its prompt and what it generated so
far), q and the output (``counts.decode``), summed, over the device time
of the kernels named in the counters (K4's)."""


def read(t):
    names = t.counters.get("k4_kernels")
    least = t.counters.get("k4_least_s")
    if not names or not least:
        return None
    seconds, launches = t.device_s(*names)
    if not launches or seconds <= 0:
        return None
    return 100.0 * least / seconds
