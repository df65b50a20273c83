"""The site updates the run claims whose counts never reached the host
totals: 1 - the program's ``sites.folded`` counter over
``RunResult.samples``.  0 in a sound run; a merge that leaves out one
shard's counts reads that shard's share.  A check of ``correct``: where
the counter is missing it reads 1, and so fails."""


def read(rec):
    r = rec["result"]
    counters = getattr(r, "counters", None)
    if not counters or "sites.folded" not in counters or r.samples <= 0:
        return 1.0
    return 1.0 - counters["sites.folded"] / r.samples
