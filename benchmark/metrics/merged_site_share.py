"""The site updates whose site walks a merged table of the sweep kernel's
lists (one table over its Markov blanket in place of its own
incidences): the program's ``sites.merged`` counter over
``RunResult.samples``.  A program without merged tables has no such
counter and reads nothing."""


def read(rec):
    r = rec["result"]
    counters = getattr(r, "counters", None)
    if not counters or "sites.merged" not in counters or r.samples <= 0:
        return None
    return counters["sites.merged"] / r.samples
