"""Seconds of the adapt steps' ranking (``adapt.rank``): the merged
marginals, the collapse candidates and the PSRF, which ends in a copy to
the host."""


def read(rec):
    spans = getattr(rec["result"], "spans", None)
    return spans["adapt.rank"]["total_s"] if spans and "adapt.rank" in spans else None
