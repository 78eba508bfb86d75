"""``mfu.serve``: the model's share of the chip's peak.  For every prefill
and decode step of the traced calls, the least time its traffic needs
(``counts.prefill`` / ``counts.decode``: real prompt tokens and generated
tokens only, bf16 at 989 TFLOP/s or 3.35 TB/s, the larger bound), summed,
over the wall seconds the same calls took without the profiler
(``untraced_s``: each traced call is made just before, untraced, with the
same prompts)."""


def read(t):
    least = t.counters.get("least_s")
    wall = t.counters.get("untraced_s")
    if not least or not wall:
        return None
    return 100.0 * least / wall
