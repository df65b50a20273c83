"""Split chain group: plain slots on plain caps, collapse slots apart.

Counterpart of ``grample_tpu.sampler.split``.  In one ``ChainGroup``
every slot runs at the group's caps, and on Promedus-class nets the
collapse-headroom caps are both refused by the sweep kernel's dense-bank
gate (the dense tables of ``max_variants`` slots outgrow the table budget
and fall into the gather bank) and far slower per site: more state rows
mean fewer chains per block on the card.  This wrapper keeps the
reference's semantics (``MergeChains``, ``sampler/chain.go:96-148``:
counts sum over all chains; a var collapsed in any chain takes that
chain's estimate) while splitting the execution:

  - ``main``: a plain-caps group holding the starting simple chains at
    full ``chains_per_variant`` — the bulk of the throughput and of the
    merged counts;
  - ``aux``: every adaptively collapsed variant, in one of two tiers,
    picked once from the caps when the aux group is built (``_build_aux``):

    * the wide tier, on a CUDA device: the main group's full
      ``chains_per_variant`` per collapse variant, on the pooled caps of
      ``wide_aux_spec`` (measured over every collapse candidate whose
      conditioning set has at most ``PAL_AUX_OA_LIM`` = 8 outcomes, so a
      later pick encodes without caps growth).  Only those candidates may
      then be collapsed (``collapse_oa_cap`` 8).  The tier sets how many
      chains feed each collapsed var's Rao-Blackwell mixture: at 8192
      chains a variant, not 256, collapsed vars keep up with the live
      ensemble.
    * the narrow tier, wherever there is no spec (a CPU device, no
      candidate, or pooled caps the kernel's dense bank does not take):
      ``AUX_CHAINS`` chains per variant on ``aux_caps`` (dense collapse
      headroom for 8 slots), candidates up to 256 outcomes
      (``COLLAPSE_OA_DENSE_CAP``).

    The reference picks the same way from its backend: the wide tier on
    its accelerator, the narrow one on its CPU (``:114-115``).

The aux group advances a bounded number of sweeps per engine tick
(``flush``), re-sized from its measured rate to ``AUX_TICK_BUDGET_SECS``,
and takes RB donor snapshots from the main group's states.

The spec costs tens of seconds of host time on Promedus-class nets (one
collapse per candidate), so it is cached on disk under
``~/.cache/grample_tpu_torch/auxspec/``, keyed by the model's cards,
evidence and factor scopes.

Left out from the reference: the background-build scaffolding
(``adapt_ready``, ``join_prewarm``), the aux build is synchronous
(``prewarm_aux``); and the demotion of a wide group whose kernel did not
compile (``:454-461``): the tier is picked from the caps before any
launch, and a launch that fails raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import warnings
from typing import List, Optional

import numpy as np
import torch

from grample_tpu_torch.ops.sweep import kernel_refusal
from grample_tpu_torch.pgm.discrete import DiscreteModel
from grample_tpu_torch.pgm.encode import (
    COLLAPSE_OA_DENSE_CAP,
    EncodeCaps,
    caps_for_variants,
    compute_caps,
    merge_caps,
)
from grample_tpu_torch.sampler.chains import ANNEAL_STAGES, MAX_VARIANTS, ChainGroup
from grample_tpu_torch.sampler.collapse import collapse_var, is_collapsible

#: micro-chains per collapse variant in the narrow aux tier
AUX_CHAINS = 256

#: collapse variants the aux group will hold (bounds its device arrays)
AUX_MAX_VARIANTS = 64

#: sweeps of the first aux advance per engine tick, and the floor of the
#: measured-rate resize (see ``SplitChainGroup._advance_aux``)
AUX_TICK_SWEEPS = 64

#: wall seconds of aux advance per engine tick the split group aims for
AUX_TICK_BUDGET_SECS = 3.0

#: outcome bound of the wide tier's candidate pool: a var whose
#: replacement factor has an incidence of more rows is not collapsed when
#: the wide tier runs (reference ``:66-74``, which chose 8 for its
#: compiler's sake; the port keeps it, since it decides which vars may
#: collapse)
PAL_AUX_OA_LIM = 8

#: widest local table a wide spec may have: the reference kernel's
#: ``PAL_OA_MAX`` (``gibbs_pallas.py:219-221``), which its spec must meet
SPEC_OA_MAX = 256


def wide_tier_device(device) -> bool:
    """True where the wide tier runs: on a CUDA device, the counterpart of
    the reference's ``jax.default_backend() == "tpu"``."""
    return torch.device(device).type == "cuda"


def spec_cache_file(base_model: DiscreteModel) -> str:
    """On-disk cache path of ``wide_aux_spec`` for ``base_model``
    (reference ``:77-96``): the pooled caps are a function of the model's
    cards, evidence and factor scopes and of the pool's bound.  Each
    scope is hashed with its length, so that two factorizations of the
    same vars do not share a key."""
    h = hashlib.sha1()
    h.update(np.asarray(base_model.cards, dtype=np.int64).tobytes())
    h.update(np.asarray(base_model.fixed, dtype=np.int64).tobytes())
    for f in base_model.factors:
        scope = np.asarray(f.scope, dtype=np.int64)
        h.update(np.int64(scope.size).tobytes())
        h.update(scope.tobytes())
    h.update(f"|{PAL_AUX_OA_LIM}|v1".encode())
    return os.path.join(os.path.expanduser("~"), ".cache", "grample_tpu_torch", "auxspec",
                        h.hexdigest()[:24] + ".json")


def spec_accepted(caps: EncodeCaps) -> bool:
    """The reference's ``pallas_eligible`` question (``:182``) on what
    the port has: dense banks only, tables within ``SPEC_OA_MAX`` rows,
    and caps the sweep kernel takes."""
    return caps.gfac_cap == 0 and caps.oa_cap <= SPEC_OA_MAX and kernel_refusal(caps) is None


def wide_aux_spec(base_model: DiscreteModel, device) -> Optional[EncodeCaps]:
    """Pooled caps for a full-width aux group on ``device``, or None
    (reference ``:99-184``).

    None unless ``device`` is a CUDA device (``wide_tier_device``).  The
    pool is every var ``is_collapsible`` admits at ``PAL_AUX_OA_LIM``
    outcomes; the caps are the union of its collapse variants' caps
    (``caps_for_variants``, ``slot_hint`` 8), so any later adapt pick
    encodes without caps growth; they are kept where ``spec_accepted``.
    The reference also encodes the 48 widest candidates to size its
    kernel's VMEM estimate (``pal_bank_dims``, ``:160-179``); the port's
    gate reads the caps alone, so it has no such probe."""
    if not wide_tier_device(device):
        return None
    return pooled_spec(base_model)[0]


def pooled_spec(base_model: DiscreteModel):
    """(``wide_aux_spec``'s caps or None, whether they were read from the
    on-disk cache), whatever the device.  A result is written to the
    cache, None included, only where it follows from the model: no
    candidate, or caps refused.  An unexpected error warns and returns
    None without writing, so it does not outlive the process."""
    path = spec_cache_file(base_model)
    try:
        with open(path) as fh:
            d = json.load(fh)["caps"]
        return (None if d is None else EncodeCaps(**d)), True
    except (OSError, ValueError, KeyError, TypeError):
        pass
    blankets = base_model.blankets()
    cands = [v for v in range(base_model.num_vars)
             if is_collapsible(base_model, v, blankets[v], oa_cap=PAL_AUX_OA_LIM)]
    caps = None
    if cands:
        try:
            caps = caps_for_variants([collapse_var(base_model, v)[0] for v in cands],
                                     slot_hint=8)
        except Exception as exc:  # noqa: BLE001 - any failure leaves the narrow tier
            warnings.warn(f"wide aux spec not computed ({exc!r}); the narrow aux tier runs",
                          RuntimeWarning, stacklevel=2)
            return None, False
        if not spec_accepted(caps):
            caps = None
    _store_spec(path, caps)
    return caps, False


def _store_spec(path: str, caps: Optional[EncodeCaps]) -> None:
    """Write ``caps`` (or None) to ``path`` whole, by a rename; a cache
    that cannot be written is skipped."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        with os.fdopen(fd, "w") as fh:
            json.dump({"caps": None if caps is None else dataclasses.asdict(caps)}, fh)
        os.replace(tmp, path)
    except OSError:
        pass


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
    """ChainGroup factory for the narrow aux tier and for checkpoint
    resume, so that a resumed aux group gets the caps and limits of a
    fresh one (reference ``:237-266``): a snapshot whose aux chains per
    variant exceed ``AUX_CHAINS`` is a wide one, rebuilt on the wide spec
    where ``device`` has one."""

    def make(model, chains_per_variant, converge_window, device, seed=0, **_kw):
        caps = None
        if chains_per_variant > AUX_CHAINS:
            caps = wide_aux_spec(model, device)
        return ChainGroup(
            model,
            chains_per_variant=chains_per_variant,
            converge_window=converge_window,
            device=device,
            seed=seed,
            caps=caps if caps is not None else aux_caps(model),
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
        self.main = _main or ChainGroup(
            base_model,
            chains_per_variant=chains_per_variant,
            converge_window=converge_window,
            device=device,
            seed=seed,
            rb_mixture=rb_mixture,
        )
        self.aux: Optional[ChainGroup] = _aux
        if _aux is not None:
            self._adopt(_aux)
        self._aux_sweeps = AUX_TICK_SWEEPS
        #: the adapt candidate bound of the aux tier built (None until the
        #: aux build picks a tier): ``PAL_AUX_OA_LIM`` on the wide tier
        self._aux_oa_cap: Optional[int] = None
        if _aux is not None and _aux.cpv > AUX_CHAINS:
            self._aux_oa_cap = PAL_AUX_OA_LIM
        #: whether the wide spec of the aux build came from the on-disk cache
        self.aux_spec_cached = False

    # ---- the tracer ------------------------------------------------------
    @property
    def tracer(self):
        """The tracer of both groups (``ChainGroup.tracer``)."""
        return self.main.tracer

    @tracer.setter
    def tracer(self, tracer) -> None:
        self.main.tracer = tracer
        if self.aux is not None:
            self.aux.tracer = tracer

    def _adopt(self, aux: ChainGroup) -> None:
        """Make ``aux`` record into this group's tracer, its claimed site
        updates under ``sites.aux``."""
        aux.tracer = self.tracer
        aux.sites_counter = "sites.aux"

    @property
    def aux_secs(self) -> float:
        """Seconds of aux advance (``tick.aux`` spans, each ending in the
        aux window's flush): the split design's overhead."""
        return self.tracer.total("tick.aux")

    @property
    def aux_ticks(self) -> int:
        return self.tracer.count("tick.aux")

    @property
    def aux_tick_sweeps(self) -> int:
        return self.tracer.counters.get("aux.sweeps", 0)

    @property
    def aux_spec_secs(self) -> Optional[float]:
        """Host seconds of the wide spec at the aux build (the
        ``setup.aux.spec`` span); None where this group did not look for
        one: a CPU device, an aux group restored from a snapshot."""
        if not self.tracer.count("setup.aux.spec"):
            return None
        return self.tracer.total("setup.aux.spec")

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
        """Candidate bound for adapt_step, set by the aux tier built
        (reference ``:364-375``): ``PAL_AUX_OA_LIM`` on the wide tier, the
        aux caps' dense bound on the narrow one."""
        if self._aux_oa_cap is not None:
            return self._aux_oa_cap
        if self.aux is not None:
            return self.aux.caps.oa_dense_cap
        return COLLAPSE_OA_DENSE_CAP

    @property
    def aux_tier(self) -> Optional[str]:
        """``"wide"`` or ``"narrow"``: the aux group's tier (None before
        it is built)."""
        if self.aux is None:
            return None
        return "wide" if self._aux_oa_cap == PAL_AUX_OA_LIM else "narrow"

    # ---- capacity / lifecycle -------------------------------------------
    def prewarm_aux(self) -> None:
        """Build the aux group (the wide spec included) and first-launch
        its sweep during engine start-up, so the first adapt step pays
        neither (the engine calls it before the sampling clock anchors)."""
        self._ensure_aux()

    def _build_aux(self) -> ChainGroup:
        """The aux group on the wide tier where the device has a spec
        (reference ``:386-415``), else on the narrow one."""
        spec = None
        if wide_tier_device(self.device):
            with self.tracer.span("setup.aux.spec"):
                spec, self.aux_spec_cached = pooled_spec(self.base)
        if spec is None:
            return self._build_aux_legacy()
        aux = ChainGroup(
            self.base,
            chains_per_variant=self.cpv,
            converge_window=self.cw,
            device=self.device,
            seed=self.seed + 104729,
            caps=spec,
            max_variants=min(self._max_variants, AUX_MAX_VARIANTS),
            rb_mixture=self.rb_mixture,
        )
        self.aux_cpv = self.cpv
        self._aux_oa_cap = PAL_AUX_OA_LIM
        # 8 slots up front: growth restacks the group on the clock
        aux.reserve(8)
        return aux

    def _build_aux_legacy(self) -> ChainGroup:
        """The narrow tier (reference ``:417-428``)."""
        aux = aux_group_factory(self._max_variants, self.rb_mixture)(
            self.base,
            chains_per_variant=self.aux_cpv,
            converge_window=self.cw,
            device=self.device,
            seed=self.seed + 104729,
        )
        self._aux_oa_cap = aux.caps.oa_dense_cap
        aux.reserve(8)
        return aux

    def _ensure_aux(self) -> ChainGroup:
        if self.aux is None:
            aux = self._build_aux()
            self._adopt(aux)
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
        with self.tracer.span("tick.aux") as sp:
            taken = self.aux.advance(sweeps)  # flushes: the span's time is the device's
        self.tracer.add("aux.sweeps", sweeps)
        # size the next aux advance to the tick budget from the measured rate
        rate = sweeps / max(sp.seconds, 1e-6)
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
