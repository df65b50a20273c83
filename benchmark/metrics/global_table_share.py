"""The site updates of launches that read the sweep kernel's compact
tables from device memory, not from shared memory (a plan with
``stage_tables`` False): the program's ``sites.tables_global`` counter
over ``RunResult.samples``.  A program without the counter, or a run off
the card, reads nothing."""


def read(rec):
    r = rec["result"]
    counters = getattr(r, "counters", None)
    if not counters or "sites.tables_global" not in counters or r.samples <= 0:
        return None
    return counters["sites.tables_global"] / r.samples
