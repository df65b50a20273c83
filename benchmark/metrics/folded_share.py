"""The site updates whose counts reached the host totals over those the
run claims: the program's ``sites.folded`` counter over
``RunResult.samples``.  1 in a sound run; a merge that leaves out some of
the counts reads the share it kept."""


def read(rec):
    r = rec["result"]
    counters = getattr(r, "counters", None)
    if not counters or "sites.folded" not in counters or r.samples <= 0:
        return None
    return counters["sites.folded"] / r.samples
