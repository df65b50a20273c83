"""Seconds of the Rao-Blackwell snapshots (``tick.rb``, one a tick, each
ending in the copy of the blanket indices to the host)."""


def read(rec):
    spans = getattr(rec["result"], "spans", None)
    return spans["tick.rb"]["total_s"] if spans and "tick.rb" in spans else None
