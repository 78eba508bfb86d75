"""``host_share.serve``: the share of the traced calls' time in neither a
prefill nor a decode step: the summed ``serve.call`` spans less the summed
``serve.prefill`` and ``serve.decode`` spans, over the summed
``serve.call`` spans (:mod:`cellbench.spans`).  What is left is the slot
bookkeeping of ``serve.schedule`` outside its refills and the call's own
set-up (the first fill's cache tiled over the slots, the decode state
made): host time in which the engine queues nothing on the card.
``None`` where the program has no such spans."""
from cellbench import spans


def read(t):
    evs = spans.events()
    call = spans.total_us("serve.call", evs)
    if call <= 0 or not spans.spans("serve.decode", evs):
        return None
    inner = spans.total_us("serve.prefill", evs) + spans.total_us("serve.decode", evs)
    return 100.0 * (call - inner) / call
