"""Seconds of the adapt steps' burn of the new slots (``adapt.burn``: the
enqueue of ``ADAPT_BURN_SWEEPS`` sweeps, no sync)."""


def read(rec):
    spans = getattr(rec["result"], "spans", None)
    return spans["adapt.burn"]["total_s"] if spans and "adapt.burn" in spans else None
