"""Split chain group: plain slots on plain caps, collapse slots apart.

Counterpart of ``grample_tpu.sampler.split`` (its narrow tier).  In one
``ChainGroup`` every slot runs at the group's caps, and on Promedus-class
nets the collapse-headroom caps are both refused by the sweep kernel's
gate (the dense tables of ``max_variants`` slots outgrow the table budget
and fall into the gather bank, which sweeps as torch ops) and far slower
per site: more state rows mean fewer chains per block on the card.  This wrapper keeps the reference's
semantics (``MergeChains``, ``sampler/chain.go:96-148``: counts sum over
all chains; a var collapsed in any chain takes that chain's estimate)
while splitting the execution:

  - ``main``: a plain-caps group holding the starting simple chains at
    full ``chains_per_variant`` — the bulk of the throughput and of the
    merged counts;
  - ``aux``: a group on ``aux_caps`` (dense collapse headroom for 8
    slots) holding every adaptively collapsed variant at ``AUX_CHAINS``
    chains each — enough mixing to feed their Rao-Blackwell snapshots.

The aux group advances a bounded number of sweeps per engine tick
(``flush``), re-sized from its measured rate to ``AUX_TICK_BUDGET_SECS``,
and takes RB donor snapshots from the main group's states.

Left out from the reference: the wide aux tier (``wide_aux_spec`` with
its on-disk cache and ``PAL_AUX_OA_LIM``) and the background-build
scaffolding (``adapt_ready``, ``join_prewarm``), which answer TPU compile
times; the aux build here is synchronous (``prewarm_aux``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from grample_tpu_torch.pgm.discrete import DiscreteModel
from grample_tpu_torch.pgm.encode import COLLAPSE_OA_DENSE_CAP, compute_caps, merge_caps
from grample_tpu_torch.sampler.chains import ANNEAL_STAGES, MAX_VARIANTS, ChainGroup
from grample_tpu_torch.sampler.collapse import collapse_var, is_collapsible

#: micro-chains per collapse variant in the aux group
AUX_CHAINS = 256

#: collapse variants the aux group will hold (bounds its device arrays)
AUX_MAX_VARIANTS = 64

#: sweeps of the first aux advance per engine tick, and the floor of the
#: measured-rate resize (see ``SplitChainGroup._advance_aux``)
AUX_TICK_SWEEPS = 64

#: wall seconds of aux advance per engine tick the split group aims for
AUX_TICK_BUDGET_SECS = 3.0


def aux_caps(base_model: DiscreteModel):
    """Encode capacities for the aux (collapse) group (reference
    ``split.py:187-234``).

    Dense collapse-headroom caps for 8 slots (the dense bank up to
    ``COLLAPSE_OA_DENSE_CAP`` rows, no gather bank), merged with the true
    caps of the three widest-blanket candidate variants: the generic
    headroom (+2 colour groups) undershoots big-blanket variants, whose
    replacement factor is a clique over the blanket, and growth mid-run
    would restack the group on the budget clock."""
    caps = compute_caps(
        base_model, collapse_headroom=True, slot_hint=8, headroom_factors=2,
    )
    blankets = base_model.blankets()
    sized = sorted(
        (
            (len(blankets[v]), v)
            for v in range(base_model.num_vars)
            if is_collapsible(base_model, v, blankets[v], oa_cap=COLLAPSE_OA_DENSE_CAP)
        ),
        reverse=True,
    )
    for _, v in sized[:3]:
        variant, _m = collapse_var(base_model, v)
        caps = merge_caps(caps, compute_caps(variant, oa_dense_cap=caps.oa_dense_cap))
    return dataclasses.replace(caps, base_mode="rowgather")


def aux_group_factory(max_variants: int = MAX_VARIANTS, rb_mixture: bool = True):
    """ChainGroup factory for the aux group, shared by
    :meth:`SplitChainGroup._ensure_aux` and checkpoint resume, so that a
    resumed aux group gets the same caps and limits as a fresh one."""

    def make(model, chains_per_variant, converge_window, device, seed=0, **_kw):
        return ChainGroup(
            model,
            chains_per_variant=chains_per_variant,
            converge_window=converge_window,
            device=device,
            seed=seed,
            caps=aux_caps(model),
            max_variants=min(max_variants, AUX_MAX_VARIANTS),
            rb_mixture=rb_mixture,
        )

    return make


class SplitChainGroup:
    """Duck-typed ChainGroup: plain slots in ``main``, collapse slots in
    ``aux``.  See the module doc."""

    #: adapt_step warm start: aux variants carry no count weight, only
    #: their RB overrides matter, and those need the plain ensemble's mode
    #: diversity, so they transplant a main slot's joint states
    adapt_init = "transplant"

    def __init__(
        self,
        base_model: DiscreteModel,
        chains_per_variant: int,
        converge_window: int,
        device,
        seed: int = 0,
        max_variants: int = MAX_VARIANTS,
        rb_mixture: bool = True,
        aux_chains: int = AUX_CHAINS,
        collapse_headroom: bool = True,  # accepted for factory parity
        _main: Optional[ChainGroup] = None,
        _aux: Optional[ChainGroup] = None,
    ):
        self.base = base_model
        self.device = device
        self.cpv = int(chains_per_variant)
        self.cw = int(converge_window)
        self.seed = int(seed)
        self._max_variants = max_variants
        self.rb_mixture = bool(rb_mixture)
        self.aux_cpv = min(int(aux_chains), self.cpv)
        #: wall seconds, ticks and sweeps of aux advance (the split
        #: design's overhead, reported in run results and logs)
        self.aux_secs = 0.0
        self.aux_ticks = 0
        self.aux_tick_sweeps = 0
        self.main = _main or ChainGroup(
            base_model,
            chains_per_variant=chains_per_variant,
            converge_window=converge_window,
            device=device,
            seed=seed,
            rb_mixture=rb_mixture,
        )
        self.aux: Optional[ChainGroup] = _aux
        self._aux_sweeps = AUX_TICK_SWEEPS

    # ---- aggregate views -------------------------------------------------
    @property
    def variants(self) -> List[DiscreteModel]:
        return self.main.variants + (self.aux.variants if self.aux else [])

    @property
    def num_variants(self) -> int:
        return self.main.num_variants + (self.aux.num_variants if self.aux else 0)

    @property
    def max_variants(self) -> int:
        """Effective variant capacity: collapse variants go only to the aux
        group (capped at ``AUX_MAX_VARIANTS``), so the room the adaptive
        controller sees is main's live slots plus the aux capacity."""
        aux_cap = min(self._max_variants, AUX_MAX_VARIANTS)
        return min(self._max_variants, self.main.num_variants + aux_cap)

    @property
    def num_chains(self) -> int:
        return self.main.num_chains + (self.aux.num_chains if self.aux else 0)

    @property
    def total_samples(self) -> int:
        return self.main.total_samples + (self.aux.total_samples if self.aux else 0)

    @property
    def total_sweeps(self) -> int:
        return self.main.total_sweeps + (self.aux.total_sweeps if self.aux else 0)

    @property
    def route(self) -> str:
        """The sweep route of the throughput path, the main group's."""
        return self.main.route

    @property
    def slot_cap(self) -> int:
        return self.main.slot_cap + (self.aux.slot_cap if self.aux else 0)

    @property
    def collapse_oa_cap(self) -> int:
        """Candidate bound for adapt_step: the aux caps' dense bound."""
        return self.aux.caps.oa_dense_cap if self.aux is not None else COLLAPSE_OA_DENSE_CAP

    # ---- capacity / lifecycle -------------------------------------------
    def prewarm_aux(self) -> None:
        """Build the aux group and first-launch its sweep during engine
        start-up, so the first adapt step pays neither (the engine calls
        it before the sampling clock anchors)."""
        self._ensure_aux()

    def _ensure_aux(self) -> ChainGroup:
        if self.aux is None:
            aux = aux_group_factory(self._max_variants, self.rb_mixture)(
                self.base,
                chains_per_variant=self.aux_cpv,
                converge_window=self.cw,
                device=self.device,
                seed=self.seed + 104729,
            )
            aux.reserve(8)
            aux.warmup()
            self.aux = aux
        return self.aux

    def reserve(self, n_slots: int):
        # collapse slots live in aux and grow lazily there; main only holds
        # the starting plain chains, so a large reserve (meant for collapse
        # variants) must not pre-size full-width plain slots
        self.main.reserve(min(n_slots, 8))

    def _is_collapse(self, model: DiscreteModel) -> bool:
        v = self.base.num_vars
        return bool((model.collapsed[:v] & ~self.base.collapsed[:v]).any())

    def add_variant(self, model: DiscreteModel, burn_sweeps: int = 0,
                    warm_marginals=None, init_states=None) -> int:
        return self.add_variants([model], burn_sweeps, warm_marginals, init_states)[0]

    def add_variants(self, models, burn_sweeps: int = 0,
                     warm_marginals=None, init_states=None) -> list:
        """Route collapse variants to aux and plain ones to main, each
        against its destination's own capacity (a mixed set goes one by
        one, in order)."""
        newly = [self._is_collapse(mv) for mv in models]
        if not any(newly):
            if self.main.num_variants + len(models) > self._max_variants:
                raise RuntimeError(f"variant limit {self._max_variants} reached")
            return self.main.add_variants(models, burn_sweeps, warm_marginals, init_states)
        if not all(newly):
            return [self.add_variant(mv, burn_sweeps, warm_marginals, init_states)
                    for mv in models]
        aux = self._ensure_aux()
        if aux.num_variants + len(models) > aux.max_variants:
            raise RuntimeError(f"aux variant limit {aux.max_variants} reached")
        slots = aux.add_variants(models, burn_sweeps, warm_marginals, init_states)
        return [self.main.num_variants + s for s in slots]

    def warmup(self):
        self.main.warmup()
        if self.aux is not None and self.aux.slot_cap:
            self.aux.warmup()

    # ---- advancing -------------------------------------------------------
    def burn(self, sweeps: int):
        self.main.burn(sweeps)
        if self.aux is not None:
            self.aux.burn(sweeps)

    def burn_annealed(self, sweeps: int, stages: int = ANNEAL_STAGES):
        self.main.burn_annealed(sweeps, stages)
        if self.aux is not None:
            self.aux.burn_annealed(sweeps, stages)

    def advance(self, sweeps: Optional[int] = None, defer: bool = False) -> int:
        """Advance main; aux advances once per flush (see module doc)."""
        taken = self.main.advance(sweeps, defer=defer)
        if not defer:
            taken += self._advance_aux()
        return taken

    def _advance_aux(self) -> int:
        if self.aux is None or self.aux.num_variants == 0:
            return 0
        sweeps = min(self.cw, self._aux_sweeps)
        t0 = time.time()
        taken = self.aux.advance(sweeps)  # flushes: the wall time is the device's
        dt = time.time() - t0
        self.aux_secs += dt
        self.aux_ticks += 1
        self.aux_tick_sweeps += sweeps
        # size the next aux advance to the tick budget from the measured rate
        rate = sweeps / max(dt, 1e-6)
        self._aux_sweeps = max(
            AUX_TICK_SWEEPS, min(self.cw, int(AUX_TICK_BUDGET_SECS * rate)))
        return taken

    def flush(self) -> None:
        self.main.flush()
        self._advance_aux()

    def rb_accumulate(self) -> None:
        if self.aux is None or self.aux.num_variants == 0:
            return
        self.aux.rb_accumulate()
        # plain-slot donor snapshots from the full-width main group: its
        # chains sample the same blankets, and their chain-count weight
        # dominates the blend
        if self.main.num_variants:
            self.aux.rb_accumulate_external(
                self.main.state, self.main.cpv, n_slots=self.main.num_variants)

    def plain_slot_states(self) -> Optional[np.ndarray]:
        """Transplant donors come from the full-width main group."""
        return self.main.plain_slot_states()

    # ---- estimation ------------------------------------------------------
    def collapsed_any(self) -> np.ndarray:
        out = self.main.collapsed_any()
        if self.aux is not None:
            out = out | self.aux.collapsed_any()
        return out

    def merged_marginals(self) -> np.ndarray:
        merged = self.main.merged_marginals()
        if self.aux is None or self.aux.num_variants == 0:
            return merged
        aux_m = self.aux.merged_marginals()
        out = merged + aux_m
        # any-collapsed wins outright (reference MergeChains): the aux
        # group already resolved first-collapsing-slot order and the RB
        # mixture in its own rows
        v = self.base.num_vars
        override = self.aux.collapsed_any() & ~self.base.collapsed[:v]
        out[override] = aux_m[override]
        return out

    def convergence(self, measure: str = "hellinger", merged=None) -> np.ndarray:
        """PSRF from the main group's chains; vars collapsed in any aux
        variant score 1.0 (reference ``ChainConvergence``,
        ``sampler/chain.go:86-89``)."""
        if merged is None:
            merged = self.merged_marginals()
        vals = self.main.convergence(measure=measure, merged=merged)
        if self.aux is not None:
            vals = np.where(self.aux.collapsed_any(), 1.0, vals)
        return vals
