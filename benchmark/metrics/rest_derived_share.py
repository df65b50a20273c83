"""The site updates whose count the sweep kernel derives once a window
instead of reducing it at the draw (outcome 0's: a half's sweeps less the
other outcomes' counts): the program's ``sites.rest_derived`` counter
over ``RunResult.samples``.  A program that reduces every draw's count
has no such counter, nor has a run off the card, and reads nothing."""


def read(rec):
    r = rec["result"]
    counters = getattr(r, "counters", None)
    if not counters or "sites.rest_derived" not in counters or r.samples <= 0:
        return None
    return counters["sites.rest_derived"] / r.samples
