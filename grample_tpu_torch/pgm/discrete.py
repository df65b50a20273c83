"""Model core: discrete variables, dense factors, validation.

Host-side (numpy) representation of a discrete factor graph.  This is the
semantic equivalent of the reference's model layer (``model/variable.go``,
``model/function.go``, ``model/model.go``) re-designed for a tensor
runtime: variables are just indices into dense arrays (cards, fixed
values, collapsed flags), and factors are flat row-major tables plus an
integer scope.  No pointer graphs — the sampling engine consumes a padded
dense encoding built from this (see ``grample_tpu_torch.pgm.encode``).

Table layout convention (must match UAI files, reference
``model/function.go:10-36``): row-major with the LAST scope variable
least significant.  ``strides[i] = prod(cards[scope[i+1:]])``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

BAYES = "BAYES"
MARKOV = "MARKOV"

#: factor tables above this size are rejected (reference model/function.go:59)
MAX_TABLE_SIZE = 1 << 23

#: log-space conversion floor (reference model/function.go:131)
LOG_EPS = 1e-6


def letter26(n: int) -> str:
    """Excel-style base-26 variable names: 0=A, 1=B, ..., ZZ+1=AAA.

    Matches the reference naming scheme (``model/variable.go:167-189``).
    """
    if n < 0:
        raise ValueError(f"invalid index {n} for letter26")
    if n == 0:
        return "A"
    n += 1
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    digits: List[str] = []
    while n > 0:
        n, rem = divmod(n - 1, 26)
        digits.append(letters[rem])
    return "".join(reversed(digits))


def table_strides(cards: Sequence[int]) -> np.ndarray:
    """Mixed-radix strides for a row-major table (last var fastest)."""
    cards = np.asarray(cards, dtype=np.int64)
    if cards.size == 0:
        return np.zeros(0, dtype=np.int64)
    strides = np.ones(cards.size, dtype=np.int64)
    for i in range(cards.size - 2, -1, -1):
        strides[i] = strides[i + 1] * cards[i + 1]
    return strides


@dataclasses.dataclass
class Factor:
    """A dense factor (clique potential / CPT) over an ordered variable scope.

    ``table`` is flat, row-major with the last scope variable least
    significant — identical to the order values appear in a UAI file.
    """

    name: str
    scope: np.ndarray  # int64 [S] variable ids, ordered
    table: np.ndarray  # float64 [prod(cards[scope])]
    is_log: bool = False

    def __post_init__(self):
        self.scope = np.asarray(self.scope, dtype=np.int64)
        self.table = np.asarray(self.table, dtype=np.float64)

    def clone(self) -> "Factor":
        return Factor(self.name, self.scope.copy(), self.table.copy(), self.is_log)

    def strides(self, cards: np.ndarray) -> np.ndarray:
        return table_strides(cards[self.scope])

    def to_log(self) -> None:
        """Convert table to natural-log space in place (idempotence-guarded).

        Zeros are floored by adding ``LOG_EPS`` before the log, exactly as
        the reference does (``model/function.go:126-142``).
        """
        if self.is_log:
            raise ValueError(f"factor {self.name}: to_log called twice")
        t = self.table
        self.table = np.log(np.where(t < LOG_EPS, t + LOG_EPS, t))
        self.is_log = True

    def eval_at(self, cards: np.ndarray, assignment: Sequence[int]) -> float:
        """Evaluate the factor at one full-scope assignment (host/test path)."""
        idx = int(np.dot(self.strides(cards), np.asarray(assignment, dtype=np.int64)))
        return float(self.table[idx])


@dataclasses.dataclass
class DiscreteModel:
    """A discrete Markov/Bayes network plus per-variable runtime annotations.

    Unlike the reference (which deep-clones the whole model per chain,
    ``model/model.go:32-49``) there is exactly one host copy; chain state
    lives in batched device arrays.  Collapse produces a *new* model
    variant via :meth:`clone` + factor surgery (see sampler/collapse.py).
    """

    type: str  # BAYES | MARKOV
    cards: np.ndarray  # int64 [V]
    factors: List[Factor]
    name: str = ""
    fixed: np.ndarray = None  # int64 [V]; -1 = free, else evidence value
    collapsed: np.ndarray = None  # bool [V]
    # Current best marginal estimate per variable, padded [V, max_card].
    # Populated by the engine (merged counts) or the collapse engine
    # (exact conditional marginal).  Mirrors Variable.Marginal.
    marginals: np.ndarray = None  # float64 [V, max_card]

    def __post_init__(self):
        self.cards = np.asarray(self.cards, dtype=np.int64)
        v = self.num_vars
        if self.fixed is None:
            self.fixed = np.full(v, -1, dtype=np.int64)
        else:
            self.fixed = np.asarray(self.fixed, dtype=np.int64)
        if self.collapsed is None:
            self.collapsed = np.zeros(v, dtype=bool)
        else:
            self.collapsed = np.asarray(self.collapsed, dtype=bool)
        if self.marginals is None:
            self.marginals = uniform_marginals(self.cards)

    # ---- basic accessors -------------------------------------------------
    @property
    def num_vars(self) -> int:
        return int(self.cards.size)

    @property
    def max_card(self) -> int:
        return int(self.cards.max()) if self.cards.size else 0

    @property
    def free_mask(self) -> np.ndarray:
        """Vars that are neither evidence-fixed nor collapsed."""
        return (self.fixed < 0) & ~self.collapsed

    def var_name(self, i: int) -> str:
        return letter26(i)

    def clone(self) -> "DiscreteModel":
        return DiscreteModel(
            type=self.type,
            cards=self.cards.copy(),
            factors=[f.clone() for f in self.factors],
            name=self.name,
            fixed=self.fixed.copy(),
            collapsed=self.collapsed.copy(),
            marginals=self.marginals.copy(),
        )

    # ---- derived structure ----------------------------------------------
    def var_factors(self) -> List[List[int]]:
        """Per-variable list of incident factor indices."""
        adj: List[List[int]] = [[] for _ in range(self.num_vars)]
        for fi, f in enumerate(self.factors):
            for v in f.scope:
                adj[int(v)].append(fi)
        return adj

    def blankets(self) -> List[set]:
        """Per-variable Markov blanket INCLUDING the variable itself.

        Matches ``GibbsCollapsed.FunctionsChanged`` neighbor semantics
        (``sampler/gibbs-collapsed.go:44-78``).
        """
        nb: List[set] = [set() for _ in range(self.num_vars)]
        for f in self.factors:
            for v in f.scope:
                nb[int(v)].update(int(u) for u in f.scope)
        return nb

    def to_log(self) -> None:
        """Convert all factors to log space (skips already-log factors)."""
        for f in self.factors:
            if not f.is_log:
                f.to_log()

    # ---- validation ------------------------------------------------------
    def check(self) -> None:
        """Raise ValueError on any structural problem.

        Mirrors the reference validation rules (``model/model.go:115-157``):
        known type, valid cards/fixed values, not all vars fixed, factor
        table sizes match scope cards, unique factor names.
        """
        if self.type not in (BAYES, MARKOV):
            raise ValueError(f"unknown model type {self.type!r}")
        if self.num_vars < 1:
            raise ValueError("model has no variables")
        if np.any(self.cards < 1):
            raise ValueError("variable with cardinality < 1")
        bad = (self.fixed != -1) & ((self.fixed < 0) | (self.fixed >= self.cards))
        if np.any(bad):
            raise ValueError(f"invalid fixed values at vars {np.nonzero(bad)[0]}")
        if int((self.fixed >= 0).sum()) >= self.num_vars:
            raise ValueError("all variables are fixed")
        names = set()
        for f in self.factors:
            if f.scope.size < 1:
                raise ValueError(f"factor {f.name} has empty scope")
            if np.any(f.scope < 0) or np.any(f.scope >= self.num_vars):
                raise ValueError(f"factor {f.name} has out-of-range scope")
            want = int(np.prod(self.cards[f.scope]))
            if want > MAX_TABLE_SIZE:
                raise ValueError(f"factor {f.name} table size {want} > {MAX_TABLE_SIZE}")
            if want != f.table.size:
                raise ValueError(
                    f"factor {f.name}: table size {f.table.size} != expected {want}"
                )
            if f.name in names:
                raise ValueError(f"duplicate factor name {f.name}")
            names.add(f.name)

    # ---- evidence --------------------------------------------------------
    def apply_evidence(self, assignments: Dict[int, int], reset: bool = True) -> None:
        """Fix variables to observed values.

        ``reset`` clears all previous evidence first, matching
        ``Model.ApplyEvidenceFromFile`` (``model/model.go:94-112``).
        """
        if reset:
            self.fixed[:] = -1
        for idx, val in assignments.items():
            if idx < 0 or idx >= self.num_vars:
                raise ValueError(f"evidence variable index {idx} out of range")
            if self.fixed[idx] != -1:
                raise ValueError(f"variable {idx} already has evidence {self.fixed[idx]}")
            if val < 0 or val >= self.cards[idx]:
                raise ValueError(
                    f"evidence value {val} invalid for var {idx} (card {self.cards[idx]})"
                )
            self.fixed[idx] = val


def uniform_marginals(cards: np.ndarray) -> np.ndarray:
    """Padded [V, max_card] uniform marginals (0 beyond each var's card)."""
    cards = np.asarray(cards, dtype=np.int64)
    v = cards.size
    k = int(cards.max()) if v else 0
    m = np.zeros((v, k), dtype=np.float64)
    for i in range(v):
        m[i, : cards[i]] = 1.0 / float(cards[i])
    return m


def norm_marginal(m: np.ndarray, card: int) -> np.ndarray:
    """Normalize one marginal vector to sum 1 over its first ``card`` entries.

    Zero-sum input becomes uniform; already-normalized input is returned
    unchanged — matching ``Variable.NormMarginal`` (``model/variable.go:
    106-147``).
    """
    out = np.array(m, dtype=np.float64)
    if card == 1:
        out[0] = 1.0
        return out
    s = float(out[:card].sum())
    eps = 1e-8
    if abs(s - 1.0) < eps:
        return out
    if abs(s) < eps:
        out[:card] = 1.0 / card
        return out
    out[:card] /= s
    return out


def norm_marginals(m: np.ndarray, cards: np.ndarray) -> np.ndarray:
    """Vectorized :func:`norm_marginal` over a padded [V, K] matrix."""
    m = np.asarray(m, dtype=np.float64)
    cards = np.asarray(cards, dtype=np.int64)
    k = m.shape[1]
    mask = np.arange(k)[None, :] < cards[:, None]
    m = np.where(mask, m, 0.0)
    s = m.sum(axis=1, keepdims=True)
    eps = 1e-8
    uniform = mask / np.maximum(cards[:, None], 1)
    normed = np.where(np.abs(s) < eps, uniform, m / np.where(np.abs(s) < eps, 1.0, s))
    # already-normalized rows pass through untouched (bit-for-bit)
    keep = np.abs(s - 1.0) < eps
    out = np.where(keep, m, normed)
    out[cards == 1, 0] = 1.0
    return out
