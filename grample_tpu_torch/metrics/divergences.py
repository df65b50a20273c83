"""Vectorized marginal error metrics (the ErrorSuite).

Numerically exact re-expression of the reference metrics
(``model/error.go``) over *padded dense matrices* instead of per-variable
Go loops: estimates and truths are [V, K] float64 arrays (K = max
cardinality, zero beyond each var's card), and all four divergences for
all variables are computed with bulk numpy — one pass, no Python loop.

Semantics preserved exactly:
  - both sides renormalized with a 1e-12 floor on the *total* (inputs may
    be unnormalized counts);
  - a variable fixed by evidence on either side contributes 0 to every
    metric and is excluded from the Mean-over-vars denominator;
  - Hellinger = sqrt(sum((sqrt p - sqrt q)^2)) / sqrt(2);
  - JSD = base-2 Jensen-Shannon with per-element 1e-12 clamps inside KL.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

EPS_TOT = 1e-12
EPS_KL = 1e-12


def _prep(m1, m2, cards):
    """Mask padding, renormalize each side with a floored total.

    Returns (p, q, mask) where p/q are [V, K] normalized and mask is the
    valid-entry mask.
    """
    m1 = np.asarray(m1, dtype=np.float64)
    m2 = np.asarray(m2, dtype=np.float64)
    cards = np.asarray(cards, dtype=np.int64)
    if m1.shape != m2.shape:
        raise ValueError(f"marginal shape mismatch: {m1.shape} vs {m2.shape}")
    k = m1.shape[-1]
    mask = np.arange(k)[None, :] < cards[:, None]
    m1 = np.where(mask, m1, 0.0)
    m2 = np.where(mask, m2, 0.0)
    t1 = np.maximum(m1.sum(axis=-1, keepdims=True), EPS_TOT)
    t2 = np.maximum(m2.sum(axis=-1, keepdims=True), EPS_TOT)
    return m1 / t1, m2 / t2, mask


def _free(fixed1, fixed2, nv):
    f1 = np.asarray(fixed1, dtype=np.int64) if fixed1 is not None else np.full(nv, -1)
    f2 = np.asarray(fixed2, dtype=np.int64) if fixed2 is not None else np.full(nv, -1)
    return (f1 < 0) & (f2 < 0)


def max_abs_diff(m1, m2, cards, fixed1=None, fixed2=None) -> np.ndarray:
    """Per-variable max |p - q| (0 for fixed vars). Returns [V]."""
    p, q, _ = _prep(m1, m2, cards)
    d = np.abs(p - q).max(axis=-1)
    return np.where(_free(fixed1, fixed2, d.shape[0]), d, 0.0)


def mean_abs_diff(m1, m2, cards, fixed1=None, fixed2=None) -> np.ndarray:
    """Per-variable mean |p - q| over the var's cardinality. Returns [V]."""
    p, q, _ = _prep(m1, m2, cards)
    cards = np.asarray(cards, dtype=np.int64)
    d = np.abs(p - q).sum(axis=-1) / np.maximum(cards, 1)
    return np.where(_free(fixed1, fixed2, d.shape[0]), d, 0.0)


def hellinger(m1, m2, cards, fixed1=None, fixed2=None) -> np.ndarray:
    """Per-variable Hellinger distance. Returns [V]."""
    p, q, _ = _prep(m1, m2, cards)
    d = np.sqrt(((np.sqrt(p) - np.sqrt(q)) ** 2).sum(axis=-1)) / math.sqrt(2.0)
    return np.where(_free(fixed1, fixed2, d.shape[0]), d, 0.0)


def js_divergence(m1, m2, cards, fixed1=None, fixed2=None) -> np.ndarray:
    """Per-variable base-2 Jensen-Shannon divergence. Returns [V]."""
    p, q, mask = _prep(m1, m2, cards)
    mid = 0.5 * (p + q)

    def kl(a, b):
        a = np.maximum(a, EPS_KL)
        b = np.maximum(b, EPS_KL)
        # padding contributes kl(eps, eps) = 0, so masking the sum is
        # only needed to keep log() off exact zeros — the clamp does that
        return (a * np.log2(a / b)).sum(axis=-1)

    d = 0.5 * (kl(p, mid) + kl(q, mid))
    return np.where(_free(fixed1, fixed2, d.shape[0]), d, 0.0)


@dataclasses.dataclass
class ErrorSuite:
    """The 8 summary metrics: mean/max over variables of 4 divergences."""

    mean_mean_abs: float
    mean_max_abs: float
    mean_hellinger: float
    mean_js: float
    max_mean_abs: float
    max_max_abs: float
    max_hellinger: float
    max_js: float

    def as_dict(self):
        return dataclasses.asdict(self)

    def __str__(self):
        return (
            f"MeanAbs(mean={self.mean_mean_abs:.6f} max={self.max_mean_abs:.6f}) "
            f"MaxAbs(mean={self.mean_max_abs:.6f} max={self.max_max_abs:.6f}) "
            f"Hell(mean={self.mean_hellinger:.6f} max={self.max_hellinger:.6f}) "
            f"JS(mean={self.mean_js:.6f} max={self.max_js:.6f})"
        )

    def report(self) -> str:
        """Long form with −log₂ views (reference errorReport,
        ``cmd/root.go:256-306``: higher = better, ~bits of accuracy)."""

        def nl2(x: float) -> float:
            return -math.log2(max(x, 1e-300))

        lines = ["  Metric          Mean       -lg(M)     Max        -lg(X)"]
        for title, mean, mx in (
            ("MeanAbsError", self.mean_mean_abs, self.max_mean_abs),
            ("MaxAbsError", self.mean_max_abs, self.max_max_abs),
            ("Hellinger", self.mean_hellinger, self.max_hellinger),
            ("JS Diverge", self.mean_js, self.max_js),
        ):
            lines.append(
                f"  {title:<14}  {mean:<9.6f}  {nl2(mean):<9.4f}  "
                f"{mx:<9.6f}  {nl2(mx):<9.4f}"
            )
        return "\n".join(lines)


def error_suite(m1, m2, cards, fixed1=None, fixed2=None) -> ErrorSuite:
    """Compute all 8 summary metrics between two padded marginal sets.

    Mean denominators count only vars free on BOTH sides; raises if no
    free vars exist (reference ``NewErrorSuite``, ``model/error.go:28-78``).
    """
    cards = np.asarray(cards, dtype=np.int64)
    nv = cards.size
    free = _free(fixed1, fixed2, nv)
    n_free = int(free.sum())
    if n_free < 1:
        raise ValueError("no un-fixed vars to score")

    mad = mean_abs_diff(m1, m2, cards, fixed1, fixed2)
    xad = max_abs_diff(m1, m2, cards, fixed1, fixed2)
    hel = hellinger(m1, m2, cards, fixed1, fixed2)
    jsd = js_divergence(m1, m2, cards, fixed1, fixed2)

    return ErrorSuite(
        mean_mean_abs=float(mad.sum() / n_free),
        mean_max_abs=float(xad.sum() / n_free),
        mean_hellinger=float(hel.sum() / n_free),
        mean_js=float(jsd.sum() / n_free),
        max_mean_abs=float(mad.max()),
        max_max_abs=float(xad.max()),
        max_hellinger=float(hel.max()),
        max_js=float(jsd.max()),
    )


def pad_marginals(marginals, cards) -> np.ndarray:
    """Stack a list of per-var marginal vectors into a padded [V, K] matrix."""
    cards = np.asarray(cards, dtype=np.int64)
    k = int(cards.max())
    out = np.zeros((cards.size, k), dtype=np.float64)
    for i, m in enumerate(marginals):
        m = np.asarray(m, dtype=np.float64)
        out[i, : m.size] = m
    return out
