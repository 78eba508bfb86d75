"""``sim_start_ms.sim``: a simulation's start, the mean over the traced
simulations' ``snn.run`` spans of the time from the span's start to the
start of its own ``graph.steps`` span (:mod:`cellbench.spans`): the step's
state and raster made (``snn.init``), the eager warm-up step
(``graph.warmup``) and the CUDA graph's capture (``graph.capture``), on
the host's clock.  ``None`` where the program has no such spans."""
from cellbench import spans


def read(t):
    evs = spans.events()
    steps = {e.get("parent"): e for e in spans.spans("graph.steps", evs)}
    starts = [(steps[r["sid"]]["ts"] - r["ts"]) / 1e3
              for r in spans.spans("snn.run", evs) if r.get("sid") in steps]
    if not starts:
        return None
    return sum(starts) / len(starts)
