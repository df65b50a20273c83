"""Seconds of the chain group's warm-up (``setup.warmup``): the sweep's
first launches, the kernel library's load, up to the program's sync."""


def read(rec):
    spans = getattr(rec["result"], "spans", None)
    return spans["setup.warmup"]["total_s"] if spans and "setup.warmup" in spans else None
