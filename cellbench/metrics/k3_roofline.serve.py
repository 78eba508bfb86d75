"""``k3_roofline.serve``: the prefill attention kernel's share of its
roofline.  The least time of the causal pairs of every real prompt token
and of q, K, V and the output read or written once (``counts.prefill``),
summed over the window's prefills, over the device time of the kernels
named in the counters (``flash_``: K3)."""


def read(t):
    names = t.counters.get("k3_kernels")
    least = t.counters.get("k3_least_s")
    if not names or not least:
        return None
    seconds, launches = t.device_s(*names)
    if not launches or seconds <= 0:
        return None
    return 100.0 * least / seconds
