"""``prefill_share.serve``: the share of the traced calls' time the serving
engine spends in prefills: the summed ``serve.prefill`` spans (a prefill,
its sample and its first token's readback, first fill and refills) over
the summed ``serve.call`` spans, both on the host's clock
(:mod:`cellbench.spans`).  ``None`` where the program has no such spans."""
from cellbench import spans


def read(t):
    evs = spans.events()
    call = spans.total_us("serve.call", evs)
    prefills = spans.spans("serve.prefill", evs)
    if call <= 0 or not prefills:
        return None
    return 100.0 * spans.total_us("serve.prefill", evs) / call
