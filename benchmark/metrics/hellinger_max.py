"""The largest Hellinger distance, over the free vars, between the timed
run's marginals and the reference's exact marginals."""


def read(rec):
    return float(rec["hellinger"].max())
