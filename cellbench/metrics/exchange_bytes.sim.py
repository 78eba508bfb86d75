"""``exchange_bytes.sim``: bytes that cross the slow axis a step, from the
communicators' ledgers (``LoopbackComm.step_bytes``) over the traced
window's steps: an exact count of the program's exchange."""


def read(t):
    steps = t.counters.get("steps")
    if not steps or "ledger_bytes" not in t.counters:
        return None
    return t.counters["ledger_bytes"] / steps
