"""The site updates of launches whose sweep-kernel instance keeps local
memory, register spills (``occupancy``'s local bytes a thread above 0):
the program's ``sites.spilled`` counter over ``RunResult.samples``.  A
program without the counter, or a run off the card, reads nothing."""


def read(rec):
    r = rec["result"]
    counters = getattr(r, "counters", None)
    if not counters or "sites.spilled" not in counters or r.samples <= 0:
        return None
    return counters["sites.spilled"] / r.samples
