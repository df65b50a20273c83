"""Split-half PSRF (Gelman-Rubin) convergence diagnostic, in torch.

Counterpart of ``grample_tpu.metrics.psrf`` (``:36-99``): the reference's
distance-based PSRF over per-chain half-window *count tensors*:

  - within-chain distance  W_c[v] = d(half1_c[v], half2_c[v])
  - between-chain distance B_c[v] = d(merged[v], half1_c[v]+half2_c[v])
  - W = (1e-8 + sum_c W_c) / m,  B = (1e-8 + sum_c B_c) * n/(m-1)
  - vhat = ((n-1)/n) W + ((m+1)/(m n)) B,  psrf = sqrt(4 vhat / (2 W))

Collapsed or evidence-fixed variables score exactly 1.0.  Count vectors
are smoothed with +1e-8 per entry before normalizing.  Computed in
float32 on the tensors' device.
"""

from __future__ import annotations

import math

import torch

_SMOOTH = 1e-8
_EPS_TOT = 1e-12
_EPS_KL = 1e-12


def _norm(m, card_mask):
    m = torch.where(card_mask, m, 0.0)
    tot = torch.clamp(m.sum(dim=-1, keepdim=True), min=_EPS_TOT)
    return m / tot


def _measure(name: str, a, b, card_mask, cards):
    """Distance between count/probability vectors along the last axis."""
    p = _norm(a, card_mask)
    q = _norm(b, card_mask)
    if name == "hellinger":
        return torch.sqrt(((torch.sqrt(p) - torch.sqrt(q)) ** 2).sum(dim=-1)) / math.sqrt(2.0)
    if name == "js":
        mid = 0.5 * (p + q)

        def kl(x, y):
            x = torch.clamp(x, min=_EPS_KL)
            y = torch.clamp(y, min=_EPS_KL)
            return (x * torch.log2(x / y)).sum(dim=-1)

        return 0.5 * (kl(p, mid) + kl(q, mid))
    if name == "maxabs":
        return (p - q).abs().amax(dim=-1)
    if name == "meanabs":
        return (p - q).abs().sum(dim=-1) / torch.clamp(cards, min=1)
    raise ValueError(f"unknown measure {name!r}")


def convergence_moments(
    half1,  # [M, V, K] per-chain counts, older half of the window
    half2,  # [M, V, K] per-chain counts, newer half of the window
    merged,  # [V, K] merged marginal estimate (counts or probs)
    cards,  # [V] int
    chain_mask,  # [M] bool — active chains
    measure: str = "hellinger",
):
    """The over-chain sums of the PSRF: ``(sum_w, sum_b, m)``, the summed
    within- and between-chain distances [V] float32 and the number of
    active chains.  Moments of disjoint chain sets add, so a group whose
    chains live on several devices sums its shards' moments
    (``parallel.mesh``; reference ``mesh.py:169-211``)."""
    half1, half2 = half1.to(torch.float32), half2.to(torch.float32)
    merged = merged.to(torch.float32)
    k = half1.shape[-1]
    card_mask = torch.arange(k, device=half1.device)[None, :] < cards[:, None]

    h1 = half1 + _SMOOTH * card_mask
    h2 = half2 + _SMOOTH * card_mask

    within = _measure(measure, h1, h2, card_mask, cards)  # [M, V]
    between = _measure(measure, merged[None], h1 + h2, card_mask, cards)

    cmask = chain_mask[:, None].to(within.dtype)
    return ((within * cmask).sum(dim=0), (between * cmask).sum(dim=0),
            chain_mask.sum().to(within.dtype))


def psrf_from_moments(sum_w, sum_b, m, cw: float, converged_mask):
    """Per-variable PSRF [V] float32 from the moments of all chains
    (reference ``mesh.py:214-222``)."""
    m = torch.clamp(m, min=2.0)
    n = torch.tensor(float(cw), dtype=sum_w.dtype, device=sum_w.device)

    w = (_SMOOTH + sum_w) / m
    b = (_SMOOTH + sum_b) * (n / (m - 1.0))

    vhat = ((n - 1.0) / n) * w + ((m + 1.0) / (m * n)) * b
    psrf = torch.sqrt((4.0 * vhat) / (2.0 * w))
    return torch.where(converged_mask, 1.0, psrf)


def chain_convergence(
    half1,  # [M, V, K] per-chain counts, older half of the window
    half2,  # [M, V, K] per-chain counts, newer half of the window
    merged,  # [V, K] merged marginal estimate (counts or probs)
    cards,  # [V] int
    converged_mask,  # [V] bool — fixed or collapsed vars (score 1.0)
    chain_mask,  # [M] bool — active chains
    cw: float,  # ConvergenceWindow (samples per var per window)
    measure: str = "hellinger",
):
    """Per-variable PSRF scores, shape [V] float32."""
    sum_w, sum_b, m = convergence_moments(half1, half2, merged, cards, chain_mask, measure)
    return psrf_from_moments(sum_w, sum_b, m, cw, converged_mask)
