"""Rao-Blackwellised variable collapse (exact marginalization), on the host.

Counterpart of ``grample_tpu.sampler.collapse`` (reference
``sampler/gibbs-collapsed.go:98-314``), in numpy: collapsing variable v
integrates it out of the model exactly.

  1. enumerate every assignment of v's Markov blanket (evidence pinned)
     as one [A, B] array;
  2. w(a) = exp(sum of incident log-factors at a), for all rows at once;
  3. the exact conditional marginal of v is the scatter-sum of w by v's
     value; the replacement factor ``COLLAPSE-<name>`` over blanket∖{v}
     is the scatter-sum of w by the other values;
  4. every factor touching v is dropped and the replacement added; v is
     flagged collapsed and never sampled again.

Guards as in the reference: a blanket (v included) of at most
``NEIGHBOR_VAR_MAX`` = 12 vars, a replacement table within the 2^23
entry cap, at least one other var; ``oa_cap`` adds the dense-bank guard
(no incidence of the replacement factor above ``oa_cap`` local rows).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from grample_tpu_torch.pgm.discrete import (
    LOG_EPS,
    MAX_TABLE_SIZE,
    DiscreteModel,
    Factor,
    letter26,
    table_strides,
)
from grample_tpu_torch.pgm.exact import enumerate_assignments

#: Max blanket size (including the variable itself) that may be collapsed;
#: reference ``sampler/gibbs-collapsed.go:93``.
NEIGHBOR_VAR_MAX = 12


class CollapseError(ValueError):
    pass


def is_collapsible(
    m: DiscreteModel, var: int, blanket=None, oa_cap: int = 0
) -> bool:
    """Can ``var`` be collapsed under the reference's guards?

    ``oa_cap`` (0 = off) also requires every incidence of the replacement
    factor to fit the dense bank (``table_size / card <= oa_cap``), so the
    variant needs no gather-bank rows, which the sweep refuses."""
    if m.fixed[var] >= 0 or m.collapsed[var]:
        return False
    b = blanket if blanket is not None else m.blankets()[var]
    if len(b) > NEIGHBOR_VAR_MAX or len(b) < 2:
        return False
    rest = [u for u in sorted(b) if u != var]
    tsize = float(np.prod(m.cards[rest], dtype=np.float64))
    if tsize > MAX_TABLE_SIZE:
        return False
    if oa_cap > 0 and any(tsize // int(m.cards[u]) > oa_cap for u in rest):
        return False
    return True


def collapsible_vars(m: DiscreteModel) -> List[int]:
    blankets = m.blankets()
    return [v for v in range(m.num_vars) if is_collapsible(m, v, blankets[v])]


def pick_random_collapsible(
    m: DiscreteModel, rng: np.random.Generator, oa_cap: int = 0
) -> Optional[int]:
    """Uniform random eligible var, retrying up to |V| times (reference
    ``Collapse(-1)``, gibbs-collapsed.go:102-120).  The same generator
    draws as the JAX package, so the same seed picks the same vars."""
    free = np.nonzero(m.free_mask)[0]
    if free.size == 0:
        return None
    blankets = m.blankets()
    for _ in range(m.num_vars):
        v = int(rng.choice(free))
        if is_collapsible(m, v, blankets[v], oa_cap=oa_cap):
            return v
    return None


def _blanket_weights(m: DiscreteModel, var: int, what: str):
    """Checks, then (rest [B], blanket assignments [A, B+1], positions,
    weights w [A]) of the incident factors over ``var``'s blanket."""
    if var < 0 or var >= m.num_vars:
        raise CollapseError(f"invalid variable index {var}")
    blanket = sorted(m.blankets()[var])
    if len(blanket) > NEIGHBOR_VAR_MAX:
        raise CollapseError(
            f"blanket of var {var} has {len(blanket)} vars (> {NEIGHBOR_VAR_MAX})"
        )
    rest = [u for u in blanket if u != var]
    if not rest:
        raise CollapseError(what)
    rest_arr = np.array(rest, dtype=np.int64)
    tsize = int(np.prod(m.cards[rest_arr], dtype=np.float64).clip(max=2 * MAX_TABLE_SIZE))
    if tsize > MAX_TABLE_SIZE:
        raise CollapseError(f"table {tsize} exceeds {MAX_TABLE_SIZE}")
    blanket_arr = np.array(blanket, dtype=np.int64)
    pos = {int(u): i for i, u in enumerate(blanket_arr)}
    assigns = enumerate_assignments(m.cards[blanket_arr], m.fixed[blanket_arr])
    logw = np.zeros(assigns.shape[0], dtype=np.float64)
    for f in m.factors:
        if var not in f.scope:
            continue
        t = f.table
        if not f.is_log:
            t = np.log(np.where(t < LOG_EPS, t + LOG_EPS, t))
        cols = np.array([pos[int(u)] for u in f.scope], dtype=np.int64)
        logw += t[assigns[:, cols] @ f.strides(m.cards)]
    rest_cols = np.array([pos[int(u)] for u in rest_arr], dtype=np.int64)
    return rest_arr, tsize, assigns, rest_cols, pos[var], np.exp(logw)


def collapse_conditional(
    m: DiscreteModel, var: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact conditional P(var | blanket∖{var}) as one dense table.

    Returns ``(rest_vars [B], rest_strides [B], cond [T, card])``, row r
    the normalized conditional of ``var`` given the rest-assignment with
    mixed-radix index r (the table the RB mixture averages, see
    ``ChainGroup.rb_accumulate``).  Rows that conflict with evidence are
    never visited and stay at the 1e-12 seed."""
    rest_arr, tsize, assigns, rest_cols, own, w = _blanket_weights(
        m, var, "conditional would have an empty given-set")
    rest_strides = table_strides(m.cards[rest_arr])
    cond = np.full((tsize, int(m.cards[var])), 1e-12, dtype=np.float64)
    np.add.at(cond, (assigns[:, rest_cols] @ rest_strides, assigns[:, own]), w)
    cond /= cond.sum(axis=1, keepdims=True)
    return rest_arr, rest_strides, cond


def collapse_var(m: DiscreteModel, var: int) -> Tuple[DiscreteModel, np.ndarray]:
    """Return (new model variant with ``var`` collapsed, exact marginal).

    The input model is not mutated.  The marginal is the incident-factor
    enumeration over the blanket, normalized, with the reference's 1e-12
    seed (gibbs-collapsed.go:139) and log-eps factor floor."""
    if 0 <= var < m.num_vars:
        if m.fixed[var] >= 0:
            raise CollapseError(f"cannot collapse evidence-fixed var {var}")
        if m.collapsed[var]:
            raise CollapseError(f"var {var} already collapsed")
    rest_arr, tsize, assigns, rest_cols, own, w = _blanket_weights(
        m, var, "replacement factor would have 0 variables")

    card = int(m.cards[var])
    marg = np.full(card, 1e-12, dtype=np.float64)
    np.add.at(marg, assigns[:, own], w)
    marg /= marg.sum()

    table = np.zeros(tsize, dtype=np.float64)
    np.add.at(table, assigns[:, rest_cols] @ table_strides(m.cards[rest_arr]), w)
    post = Factor(name=f"COLLAPSE-{letter26(var)}", scope=rest_arr, table=table)

    out = m.clone()
    out.factors = [f.clone() for f in m.factors if var not in f.scope]
    out.factors.append(post)
    out.collapsed[var] = True
    out.marginals[var, :] = 0.0
    out.marginals[var, :card] = marg
    out.check()
    return out, marg
