"""The split group's aux share of the counted site updates: the program's
``sites.aux`` counter over ``RunResult.samples`` (read beside
``aux_share``, the aux group's share of the clock)."""


def read(rec):
    r = rec["result"]
    counters = getattr(r, "counters", None)
    if not counters or "sites.aux" not in counters or r.samples <= 0:
        return None
    return counters["sites.aux"] / r.samples
