"""Seconds of the adapt steps' placement of the new variants: the self
time of ``adapt.place`` (the warm start, caps growth, encoding, restack
or slot writes, the transplant), its ``adapt.burn`` child left out."""


def read(rec):
    spans = getattr(rec["result"], "spans", None)
    return spans["adapt.place"]["self_s"] if spans and "adapt.place" in spans else None
