"""Seconds of the split group's aux build before the sampling clock
(``setup.aux``): the wide aux spec's lookup or computation, the aux
group's build and first launch."""


def read(rec):
    spans = getattr(rec["result"], "spans", None)
    return spans["setup.aux"]["total_s"] if spans and "setup.aux" in spans else None
