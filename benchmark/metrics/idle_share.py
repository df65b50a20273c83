"""1 - the union of device intervals over the span's wall, the mean over
the cell's cards."""


def read(rec):
    span = rec["span"]
    if not span or span["wall"] <= 0:
        return None
    busy = span["busy_s"]
    return 1.0 - sum(busy) / len(busy) / span["wall"]
