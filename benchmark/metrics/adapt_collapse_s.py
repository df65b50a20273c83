"""Seconds of the adapt steps' exact collapses (``adapt.collapse``, host
only)."""


def read(rec):
    spans = getattr(rec["result"], "spans", None)
    return spans["adapt.collapse"]["total_s"] if spans and "adapt.collapse" in spans else None
