"""Host seconds of the adapt steps: the sum of the engine's ``ADAPT: ... in
X s`` lines over the whole window."""


def read(rec):
    steps = rec["adapt_s"]
    return sum(steps) if steps else None
