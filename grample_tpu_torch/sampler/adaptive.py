"""Adaptive Rao-Blackwellisation controller.

Counterpart of ``grample_tpu.sampler.adaptive`` (the reference's
``ConvergenceSampler.Adapt``, ``sampler/adaptive.go:57-157``): between
sampling windows, rank the free variables by the distance-based PSRF and
add chain variants in which the chosen variables are exactly collapsed.
As in the JAX package, and unlike the reference:

  - candidates pass the full collapsibility guard (blanket size, the
    replacement table's size, and the group's dense bound
    ``collapse_oa_cap``);
  - ``policy="worst"`` collapses the worst-converged candidates (highest
    PSRF), the documented intent; ``policy="ref-tail"`` takes the
    reference code's literal tail of the descending sort (the
    best-converged);
  - new variants warm-start: by transplanting a plain slot's joint chain
    states (``adapt_init == "transplant"``, the split group) or by an
    independent redraw from the merged estimate (``"redraw"``, a single
    full-width group).
"""

from __future__ import annotations

from typing import List

from grample_tpu_torch.pgm.discrete import norm_marginals
from grample_tpu_torch.sampler.collapse import collapse_var, is_collapsible

#: burn-in (sweeps) for adaptively added chains — reference adaptive.go:145
ADAPT_BURN_SWEEPS = 2


def adapt_step(
    group,
    new_chain_count: int,
    measure: str = "hellinger",
    policy: str = "worst",
    warm_start: bool = True,
) -> List[int]:
    """Add up to ``new_chain_count`` collapsed variants to ``group`` (a
    ``ChainGroup`` or ``SplitChainGroup``).  Returns the collapsed variable
    ids (possibly empty).  Its parts are spans of ``group.tracer``:
    ``adapt.rank`` (merge, candidates, PSRF), ``adapt.collapse``,
    ``adapt.place`` (warm start, encode, restack or slot writes) and, inside
    it, ``adapt.burn``."""
    if group.num_variants >= group.max_variants:
        return []
    if group.num_chains < 2:
        raise ValueError("at least 2 chains required for adaptation")

    base = group.base
    tracer = group.tracer
    with tracer.span("adapt.rank"):
        merged = group.merged_marginals()
        collapsed_any = group.collapsed_any()
        blankets = base.blankets()
        candidates = [
            v
            for v in range(base.num_vars)
            if base.fixed[v] < 0
            and not collapsed_any[v]
            and len(blankets[v]) > 1
            and is_collapsible(base, v, blankets[v], oa_cap=group.collapse_oa_cap)
        ]
        if not candidates:
            return []

        take = min(new_chain_count, group.max_variants - group.num_variants)
        if len(candidates) <= take:
            targets = candidates
        else:
            psrf = group.convergence(measure=measure, merged=merged)
            if policy == "worst":
                order = sorted(candidates, key=lambda v: -psrf[v])
            elif policy == "ref-tail":
                order = sorted(candidates, key=lambda v: psrf[v])
            else:
                raise ValueError(f"unknown adapt policy {policy!r}")
            targets = order[:take]

    with tracer.span("adapt.collapse"):
        variants = [collapse_var(base, var)[0] for var in targets]

    # the placement's own time is the span's self time: its adapt.burn
    # child (``add_variants``' burn of the new slots) is timed apart
    with tracer.span("adapt.place"):
        warm = None
        donor = None
        if warm_start:
            if group.adapt_init == "transplant":
                donor = group.plain_slot_states()
            if donor is None:
                warm = norm_marginals(merged, base.cards)
        group.add_variants(variants, burn_sweeps=ADAPT_BURN_SWEEPS,
                           warm_marginals=warm, init_states=donor)
    return list(targets)
