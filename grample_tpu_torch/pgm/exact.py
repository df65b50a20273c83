"""Exact marginals by brute-force joint enumeration (test/validation aid).

The reference validates sampling against bundled ``.MAR`` solution files
produced by external exact solvers.  For small in-memory fixtures we can
do better: enumerate the joint table directly (vectorized mixed-radix
decode, honoring evidence) and marginalize.  Used by the statistical
tests and the ``collapse`` diagnostic command.
"""

from __future__ import annotations

import numpy as np

from grample_tpu_torch.pgm.discrete import DiscreteModel, table_strides


def enumerate_assignments(cards: np.ndarray, fixed: np.ndarray = None) -> np.ndarray:
    """All joint assignments [A, V], pinning evidence-fixed vars.

    Mixed-radix, last variable fastest (the VariableIter odometer order,
    ``model/variable_iter.go:52-74`` with honorFixed).
    """
    cards = np.asarray(cards, dtype=np.int64)
    v = cards.size
    if fixed is None:
        fixed = np.full(v, -1, dtype=np.int64)
    eff = np.where(fixed >= 0, 1, cards)
    total = int(np.prod(eff))
    strides = table_strides(eff)
    idx = np.arange(total, dtype=np.int64)
    vals = (idx[:, None] // strides[None, :]) % eff[None, :]
    return np.where(fixed[None, :] >= 0, fixed[None, :], vals)


def joint_log_weights(m: DiscreteModel, assignments: np.ndarray) -> np.ndarray:
    """Unnormalized log joint weight of each assignment row.

    Uses the same log-space eps floor the samplers see (log(t + 1e-6) on
    entries below 1e-6), so exact answers match what a converged sampler
    of the floored model would produce.
    """
    from grample_tpu_torch.pgm.discrete import LOG_EPS

    logw = np.zeros(assignments.shape[0], dtype=np.float64)
    for f in m.factors:
        t = f.table
        if not f.is_log:
            t = np.log(np.where(t < LOG_EPS, t + LOG_EPS, t))
        strides = f.strides(m.cards)
        idx = assignments[:, f.scope] @ strides
        logw += t[idx]
    return logw


def exact_marginals(m: DiscreteModel, max_states: int = 1 << 22) -> np.ndarray:
    """Padded [V, K] exact conditional marginals given evidence."""
    eff = np.where(m.fixed >= 0, 1, m.cards)
    total = int(np.prod(eff.astype(np.float64)).clip(max=2 * max_states))
    if total > max_states:
        raise ValueError(f"state space {total} too large for brute force")
    assigns = enumerate_assignments(m.cards, m.fixed)
    logw = joint_log_weights(m, assigns)
    w = np.exp(logw - logw.max())
    k = m.max_card
    out = np.zeros((m.num_vars, k), dtype=np.float64)
    for i in range(m.num_vars):
        np.add.at(out[i], assigns[:, i], w)
    out /= out.sum(axis=1, keepdims=True)
    return out
