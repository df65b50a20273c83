"""The error's variance over that of independent draws of the site updates
the run claims: the mean over the free vars of 8 n H^2, H the var's
Hellinger distance to the exact marginal and n the run's counted site
updates (``RunResult.samples``) over the free vars.  For a binary var
estimated from n_eff independent draws, 8 H^2 is about 1 / n_eff, so a
sound run reads the chains' mean autocorrelation time, whatever its
rate; one that folds only half its updates into the estimate, or claims
twice those it made, reads twice as much."""

import numpy as np


def read(rec):
    h = rec["hellinger"]
    return float(8.0 * rec["result"].samples / h.size * np.mean(np.square(h)))
