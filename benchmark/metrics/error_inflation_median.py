"""``error_inflation`` with the median over the free vars in place of the
mean: 8 n H^2 of the middle free var.  A var collapsed by an adapt step
takes its estimate from a few RB snapshots, not from the counted updates,
and reads far above the rest; the median is that of the plain vars."""

import numpy as np


def read(rec):
    h = rec["hellinger"]
    return float(8.0 * rec["result"].samples / h.size * np.median(np.square(h)))
