"""The engine ticks' host-bound stretch over the sampling clock: the sum
of the ``tick`` spans less their ``tick.launch`` (the windows' enqueue)
and ``tick.flush`` (the drain, with the aux tick inside it) children,
over ``RunResult.runtime``.  After each drain the card has nothing
queued, so in that stretch the host, not the card, sets the pace."""


def read(rec):
    r = rec["result"]
    spans = getattr(r, "spans", None)
    if not spans or "tick" not in spans or r.runtime <= 0:
        return None
    host = spans["tick"]["total_s"] - sum(spans.get(name, {}).get("total_s", 0.0)
                                          for name in ("tick.launch", "tick.flush"))
    return host / r.runtime
