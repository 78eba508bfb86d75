"""``prefill_useful.serve``: the share of the prefilled tokens that are
prompt tokens: the summed ``prompt_tokens`` over the summed
``padded_tokens`` (the bucket's length times its batch) of the traced
calls' ``serve.prefill`` spans (:mod:`cellbench.spans`), an exact count of
the padding the prefill bucket adds.  ``None`` where the program has no
such spans."""
from cellbench import spans


def read(t):
    args = [e.get("args", {}) for e in spans.spans("serve.prefill")]
    padded = sum(a.get("padded_tokens", 0) for a in args)
    if padded <= 0:
        return None
    return 100.0 * sum(a.get("prompt_tokens", 0) for a in args) / padded
