"""Chain runtime: batched chains over stacked model variants, in torch.

Counterpart of ``grample_tpu.sampler.chains.ChainGroup``.  One sweep
launch advances every chain of every active variant at once:

  - variant slot axis  [N]: distinct factor graphs (the base model, or a
    collapse variant: the reference's "chain"),
  - micro-chain axis   [C]: independent chains per variant,

with state ``[N, C, V+1]`` int32 and split-half window counts
``[N, 2, C, V+1, K]`` int32 resident on ``device``.  Slot capacity grows
in powers of two; caps grow when a variant does not fit them.

``merged_marginals`` is the reference's ``MergeChains``: every chain
contributes its uniform-initialized marginal (1/card per entry) plus its
counts, and a var collapsed in any variant takes that variant's estimate
(first collapsing slot wins): the Rao-Blackwell mixture once it has
``RB_MIN_SNAPSHOTS`` snapshots, else the static collapse marginal.

Adaptively added variants start from transplanted donor states or from
independent draws of the merged estimate (``add_variants``); a split
group's aux group takes RB donor snapshots from its main group's states
(``rb_accumulate_external``).  Each window's seed is a pure function of
(seed, step) (``window_seed``), as the reference's ``fold_in(key, step)``,
so a checkpoint that stores ``_step`` resumes bit for bit.

The sweep tensors are an ``ops.sweep.SweepStack``, which alone knows
their format and the kernel's facts.  A window is issued in one place,
``_advance_fn``, over the launches that ``launches`` yields (slot holder,
first slot, first chain, active slots, sweep stack): one here, over the
group's own tensors.  ``advance`` counts the launch counters and
``flush`` folds the pending deltas, reduced by ``_reduce`` (the identity
here).  ``parallel.mesh.ShardedChainGroup`` keeps its tensors in shards
on several devices, of one process or of several, and replaces only the
geometry: placement (``_place``, ``_write_slots``,
``restore_device_state``), ``launches``, ``_reduce``, the host reads
(``state``, ``halves``, ``_slot_state``, ``_rb_index_rows``) and
``convergence``.

Not ported: the reference's TPU workarounds (slot chunking, counted
sub-windows, the compile-error fallback).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from grample_tpu_torch.metrics.psrf import chain_convergence
from grample_tpu_torch.ops.sweep import (
    SweepStack,
    check_supported,
    hash_block,
    rest_derived,
    route_for,
)
from grample_tpu_torch.pgm.discrete import DiscreteModel
from grample_tpu_torch.pgm.encode import (
    EncodeCaps,
    EncodedModel,
    compute_caps,
    encode_model,
    merge_caps,
    stack_variants,
)
from grample_tpu_torch.sampler.collapse import collapse_conditional
from grample_tpu_torch.tracing import Tracer

MAX_VARIANTS = 128  # reference ConvergenceSampler.MaxChains (adaptive.go:49)

#: Default tempered burn-in stages (see :meth:`ChainGroup.burn_annealed`).
ANNEAL_STAGES = 20

#: Snapshots an RB mixture needs before it replaces the static collapse
#: marginal in ``merged_marginals`` (reference ``chains.py:64-72``): one
#: snapshot is a single correlated draw of the blanket distribution.
RB_MIN_SNAPSHOTS = 2

#: Per-snapshot decay of the RB mixture's running sums and weights
#: (reference ``chains.py:74-85``): the mixture tracks the live ensemble
#: over an effective window of about 1/(1-γ) snapshots.
RB_DECAY = 0.85


def _rb_indices(state, slots, rest, strides):
    """Mixed-radix blanket indices [n, C] for the RB mixture: state
    [N, C, V+1], slots [n], rest/strides [n, B] (sentinel-padded, stride
    0).  One gather straight to [n, C, B], no [n, C, V+1] copy (reference
    ``chains.py:101-114``, there an XLA program)."""
    c = state.shape[1]
    chains = torch.arange(c, device=state.device)
    g = state[slots[:, None, None], chains[None, :, None], rest[:, None, :]]
    return (g * strides[:, None, :]).sum(dim=2)


def window_seed(seed: int, step: int) -> int:
    """The int32 seed of window ``step`` of a group seeded ``seed``: a
    pure function of the pair (the reference derives the window key as
    ``fold_in(key, step)``, ``chains.py:253-255``)."""
    word = int(np.random.SeedSequence([int(seed) & (2**64 - 1), int(step)])
               .generate_state(1)[0])
    return word - (1 << 32) if word >= (1 << 31) else word


def shard_seed(seed: int, v0: int, block0: int) -> int:
    """The int32 seed that makes a launch starting at variant ``v0`` and
    chain block ``block0`` draw what the whole window seeded ``seed``
    draws there (``parallel.mesh``'s module doc); ``seed`` itself at
    (0, 0)."""
    x = (int(seed) + 65537 * int(v0) + 257 * int(block0)) & 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ChainGroup:
    """All chains of a run: stacked variants × micro-chains on ``device``."""

    #: adapt_step warm start (see sampler/adaptive.py): full-width collapse
    #: variants dominate the merged counts, and an independent redraw from
    #: the merged estimate re-equilibrates them (reference ``:144-148``)
    adapt_init = "redraw"

    #: the tracer counter of the site updates this group claims
    #: (``advance``); a split group's aux group counts under ``sites.aux``
    sites_counter = "sites.main"

    #: device tensors, built by ``_place`` at the first restack
    kstack = None  # the sweep tensors [Ncap, ...] (``ops.sweep.SweepStack``)
    state = None  # [Ncap, C, V+1] int32
    halves = None  # [Ncap, 2, C, V+1, K] int32

    def __init__(
        self,
        base_model: DiscreteModel,
        chains_per_variant: int,
        converge_window: int,
        device,
        seed: int = 0,
        caps: Optional[EncodeCaps] = None,
        group_cap: int = 0,
        max_variants: int = MAX_VARIANTS,
        collapse_headroom: bool = False,
        rb_mixture: bool = True,
    ):
        base_model.check()
        self.base = base_model
        self.device = torch.device(device)
        self.cpv = int(chains_per_variant)
        self.cw = int(converge_window)
        self.seed = int(seed)
        self.max_variants = max_variants
        #: spans and counters; the engine puts its run's tracer here
        self.tracer = Tracer()
        # collapse headroom sizes the caps for max_variants collapse
        # variants with two spare factor slots per var; plain groups never
        # mutate the factor graph and get none (reference ``:170-180``)
        self.caps = caps or compute_caps(
            base_model,
            group_cap=group_cap,
            collapse_headroom=collapse_headroom,
            slot_hint=max_variants if collapse_headroom else 1,
            headroom_factors=2 if collapse_headroom else 0,
        )
        self._set_caps(self.caps)
        self.cb = hash_block(self.cpv)
        self._step = 0

        self.variants: List[DiscreteModel] = []
        self.encs: List[EncodedModel] = []
        self.slot_cap = 0
        self.totals: Optional[np.ndarray] = None  # host f64 [Ncap, V+1, K]
        self.total_samples = 0  # counted site updates across all chains
        self.total_sweeps = 0
        # deferred windows not yet folded into ``totals``: each its
        # ``_window_delta`` (left on the devices) and its ``sites.merged``
        # updates — the engine dispatches many windows without a host sync
        # per window
        self._pending: List[tuple] = []
        # Rao-Blackwell mixture (see rb_accumulate): conditional tables by
        # var; decayed snapshot sums, weights and undecayed counts keyed
        # (slot, var) for each collapsing variant's own chains, and keyed
        # var for plain-slot donors (chain-count weighted)
        self.rb_mixture = bool(rb_mixture)
        self._rb_cond: dict = {}
        self._rb_sum: dict = {}
        self._rb_n: dict = {}
        self._rb_count: dict = {}
        self._rbp_sum: dict = {}
        self._rbp_w: dict = {}
        self._rbp_snaps: dict = {}

    # ---- capacity management --------------------------------------------
    @property
    def num_variants(self) -> int:
        return len(self.variants)

    @property
    def num_chains(self) -> int:
        return self.num_variants * self.cpv

    @property
    def local_chains(self) -> int:
        """Chains of one variant that one launch advances; the hash lane
        width ``cb`` divides it."""
        return self.cpv

    @property
    def v1(self) -> int:
        return self.caps.num_vars + 1

    @property
    def kdim(self) -> int:
        return self.caps.max_card

    @property
    def collapse_oa_cap(self) -> int:
        """Dense bound a collapse variant must meet to join this group
        (``adapt_step`` passes it to ``is_collapsible``): variants that
        would need gather rows of their own stay excluded on either
        route (reference ``:240-247``)."""
        return self.caps.oa_dense_cap

    def _set_caps(self, caps: EncodeCaps) -> None:
        """Take ``caps`` and the sweep route they give: ``"kernel"``
        where the CUDA kernel takes them, else ``"ops"``
        (``ops.gibbs_bank``).  Re-evaluated whenever the caps grow, as
        the reference's ``_refresh_pallas`` (``:261-286``, ``:334``)."""
        check_supported(caps)
        self.caps = caps
        self.route = route_for(caps)

    def _next_seed(self) -> int:
        """Advance ``_step`` and return that window's int32 seed."""
        self._step += 1
        return window_seed(self.seed, self._step)

    def _host_init_state(
        self, enc: EncodedModel, warm_marginals: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Initial [C, V+1] states on the host: free vars uniform, or drawn
        independently from ``warm_marginals`` [V(+1), K] (the redraw warm
        start of adaptively added variants); evidence pinned.  The same
        draws as the reference for the same ``_step`` (``:346-373``)."""
        rng = np.random.default_rng(self._step * 7919 + 13)
        self._step += 1
        cards = np.asarray(enc.cards, dtype=np.int64)  # [V+1]
        v1 = cards.size
        if warm_marginals is None:
            u = rng.random((self.cpv, v1))
            draw = np.floor(u * cards[None, :]).astype(np.int32)
        else:
            k = self.kdim
            probs = np.zeros((v1, k), dtype=np.float64)
            probs[: warm_marginals.shape[0], : warm_marginals.shape[1]] = warm_marginals
            valid = np.arange(k)[None, :] < cards[:, None]
            probs = np.where(valid, np.maximum(probs, 1e-12), 0.0)
            probs /= probs.sum(axis=1, keepdims=True)
            cdf = np.cumsum(probs, axis=1)  # [V+1, K]
            u = rng.random((self.cpv, v1, 1))
            draw = (u > cdf[None]).sum(axis=2).astype(np.int32)
            draw = np.minimum(draw, (cards - 1)[None, :]).astype(np.int32)
        fixedv = np.asarray(enc.fixed, dtype=np.int32)
        return np.where(fixedv[None, :] >= 0, fixedv[None, :], draw)

    def _transplant_states(self, enc: EncodedModel, rows: np.ndarray) -> np.ndarray:
        """[C, V+1] initial states subsampled from donor chain states
        ``rows`` [M, V+1]: without replacement when M > C, with it when
        M < C; evidence re-pinned (reference ``:375-396``).  Donor chains
        are exchangeable, so the subsample keeps their joint law."""
        if rows.ndim != 2 or rows.shape[1] != self.v1:
            raise ValueError(f"init_states shape {rows.shape} != (M, {self.v1})")
        rng = np.random.default_rng(self._step * 7919 + 13)
        self._step += 1
        if rows.shape[0] < self.cpv:
            pick = rng.integers(0, rows.shape[0], size=self.cpv)
        elif rows.shape[0] > self.cpv:
            pick = rng.choice(rows.shape[0], size=self.cpv, replace=False)
        else:
            pick = np.arange(self.cpv)
        st = rows[pick].astype(np.int32)
        fixedv = np.asarray(enc.fixed, dtype=np.int32)
        return np.where(fixedv[None, :] >= 0, fixedv[None, :], st)

    def plain_slot_states(self) -> Optional[np.ndarray]:
        """Host copy [C, V+1] of the first base-model (plain) slot's chain
        states, the transplant donor of adaptively added collapse
        variants; None when every slot is collapsed (``:398-408``)."""
        v = self.caps.num_vars
        base_col = self.base.collapsed[:v]
        for slot, mv in enumerate(self.variants):
            if not (mv.collapsed[:v] & ~base_col).any():
                return self._slot_state(slot)
        return None

    def _slot_state(self, slot: int) -> np.ndarray:
        """Host copy [C, V+1] of one slot's chain states."""
        return self.state[slot].cpu().numpy()

    def _encode_grown(self, model: DiscreteModel) -> tuple:
        """``encode_model`` with caps growth; returns (enc, grew).

        On growth the caps become the merge of the old caps and the
        model's own (reference ``chains.py:320-336``), the sweep route is
        chosen again, and every existing variant is re-encoded; the device
        stack is NOT rebuilt here (callers restack)."""
        try:
            return encode_model(model, self.caps), False
        except ValueError:
            caps = merge_caps(
                self.caps,
                compute_caps(model, oa_dense_cap=self.caps.oa_dense_cap),
            )
            self._set_caps(caps)
            self.encs = [encode_model(mv, self.caps) for mv in self.variants]
            return encode_model(model, self.caps), True

    def reserve(self, n_slots: int):
        """Pre-size slot capacity to avoid intermediate restacks."""
        cap = _next_pow2(max(1, n_slots))
        if cap > self.slot_cap:
            self._restack(cap)

    def _restack(self, new_slot_cap: Optional[int] = None):
        """Rebuild stacked device arrays, preserving live slot state."""
        self.flush()  # pending deltas are shaped for the OLD slot capacity
        if new_slot_cap is not None:
            self.slot_cap = self._round_cap(new_slot_cap)
        if self.slot_cap == 0:
            return
        # exact variant caps need not fit the base model: grow them
        base_enc = self.encs[0] if self.encs else self._encode_grown(self.base)[0]
        padded = list(self.encs) + [base_enc] * (self.slot_cap - len(self.encs))
        self._place(stack_variants(padded),
                    np.stack([self._host_init_state(enc) for enc in padded]))
        old_tot = self.totals
        self.totals = np.zeros((self.slot_cap, self.v1, self.kdim), dtype=np.float64)
        if old_tot is not None:
            n = min(old_tot.shape[0], self.slot_cap)
            self.totals[:n] = old_tot[:n]

    def _round_cap(self, slot_cap: int) -> int:
        """The slot capacity a request for ``slot_cap`` slots gets."""
        return slot_cap

    def _place(self, stack: dict, state: np.ndarray) -> None:
        """Put a restack's tensors on the device: the sweep tensors of the
        stacked encoding ``stack`` (``stack_variants`` output, leading
        axis Ncap) and the fresh states ``state`` [Ncap, C, V+1], over
        which the slots held so far keep their states; the window halves
        start at zero."""
        self.kstack = SweepStack(stack, self.route, [self.device])
        new_state = torch.as_tensor(state, device=self.device)
        if self.state is not None:
            n = min(self.state.shape[0], self.slot_cap)
            new_state[:n] = self.state[:n]
        self.state = new_state
        self.halves = torch.zeros(
            (self.slot_cap, 2, self.cpv, self.v1, self.kdim),
            dtype=torch.int32, device=self.device,
        )

    def _write_slots(self, slots: List[int], stack: Optional[dict],
                     state: np.ndarray) -> None:
        """Write new variants into free slots ``slots``: their stacked
        encoding ``stack`` (``stack_variants`` output; None after a
        restack, which placed them already) and their states ``state``
        [n, C, V+1]."""
        if stack is not None:
            self.kstack.write(slots, stack)
        self.state[slots] = torch.as_tensor(state, device=self.device)

    def add_variant(self, model: DiscreteModel, burn_sweeps: int = 0,
                    warm_marginals: Optional[np.ndarray] = None,
                    init_states: Optional[np.ndarray] = None) -> int:
        """Add a model variant (a logical chain); returns its slot index."""
        return self.add_variants([model], burn_sweeps, warm_marginals, init_states)[0]

    def add_variants(self, models: List[DiscreteModel], burn_sweeps: int = 0,
                     warm_marginals: Optional[np.ndarray] = None,
                     init_states: Optional[np.ndarray] = None) -> List[int]:
        """Add variants with one device update per stack key, growing the
        caps (and restacking) when one does not fit them.

        Each new slot's chains start from ``init_states`` [M, V+1]
        (transplanted donor rows, see ``_transplant_states``), else from
        independent draws of ``warm_marginals``, else uniform.
        ``burn_sweeps`` uncounted sweeps then run over the whole group
        (reference ``chains.py:465-600``)."""
        if not models:
            return []
        if self.num_variants + len(models) > self.max_variants:
            raise RuntimeError(f"variant limit {self.max_variants} reached")
        grew_any = False
        new_encs: List[EncodedModel] = []
        for mv in models:
            enc, grew = self._encode_grown(mv)
            if grew:
                grew_any = True
                # earlier members of this batch used the old caps
                new_encs = [encode_model(m2, self.caps) for m2 in models[:len(new_encs)]]
            new_encs.append(enc)
        slot0 = len(self.variants)
        slots = list(range(slot0, slot0 + len(models)))
        self.variants.extend(models)
        self.encs.extend(new_encs)
        restack = grew_any or slots[-1] >= self.slot_cap
        if restack:
            self._restack(max(self.slot_cap, _next_pow2(slots[-1] + 1)))
        st = np.stack([
            self._transplant_states(enc, np.asarray(init_states))
            if init_states is not None
            else self._host_init_state(enc, warm_marginals)
            for enc in new_encs
        ])
        self._write_slots(
            slots, None if restack else stack_variants(new_encs), st)
        self.totals[slots] = 0.0
        if burn_sweeps > 0:
            with self.tracer.span("adapt.burn"):  # the new slots' burn (adapt_step's)
                self.burn(burn_sweeps)
        return slots

    # ---- advancing -------------------------------------------------------
    def launches(self):
        """(slot holder, first slot, first chain, active slots, sweep stack)
        of each launch that a window of the active slot prefix makes: the
        holder's ``state``, ``halves`` and ``device`` are the launch's."""
        yield self, 0, 0, max(1, self.num_variants), self.kstack

    def _advance_fn(self, sweeps: int, half: int, count: bool, fresh: bool = False,
                    beta: float = 1.0):
        """Advance the ACTIVE slot prefix by one window, each launch seeded
        by ``shard_seed`` from the window's seed; ``fresh`` zeroes the
        window halves first, ``beta`` scales the log tables."""
        seed = self._next_seed()
        for h, v0, c0, na, stack in self.launches():
            if fresh:
                h.halves.zero_()
            st, hv = stack.advance(h.device, h.state[:na], h.halves[:na],
                                   shard_seed(seed, v0, c0 // self.cb), sweeps, half, count,
                                   self.cb, beta)
            h.state[:na] = st
            h.halves[:na] = hv

    def warmup(self):
        """Build and first-launch the sweep (one counted and one uncounted
        sweep), then restore the exact prior state, window and step.
        Engines call it before anchoring time budgets."""
        if self.slot_cap == 0:
            return
        step = self._step
        held = [(h, h.state.clone(), h.halves.clone()) for h, *_ in self.launches()]
        self._advance_fn(1, 0, count=True)
        self._advance_fn(1, 1, count=False)
        for h, state, halves in held:
            h.halves.sum().item()  # sync: wait out first-launch overheads
            h.state, h.halves = state, halves
        self._step = step

    def burn(self, sweeps: int, beta: float = 1.0):
        """Uncounted sweeps for all chains (burn-in), on the log tables
        times ``beta``."""
        if sweeps <= 0 or self.slot_cap == 0:
            return
        self._advance_fn(int(sweeps), int(sweeps), count=False, beta=beta)
        self.total_sweeps += sweeps

    def burn_annealed(self, sweeps: int, stages: int = ANNEAL_STAGES):
        """Tempered burn-in: β ramps 1/stages → 1 over equal sweep blocks.

        Gibbs quenches on near-deterministic models: from uniform init each
        chain freezes into a local mode within a few sweeps.  Ramping the
        log-potentials (tables × β) lets the ensemble re-equilibrate while
        the landscape sharpens.  The β=1 stationary chain is untouched —
        this is purely an initialization policy (reference
        ``chains.py:693-735``).
        """
        if sweeps <= 0 or self.slot_cap == 0:
            return
        stages = max(1, min(int(stages), int(sweeps)))
        per = sweeps // stages
        for i in range(stages):
            n = per + (sweeps - per * stages if i == stages - 1 else 0)
            self.burn(n, (i + 1.0) / stages)

    def advance(self, sweeps: Optional[int] = None, defer: bool = False) -> int:
        """Advance all chains one convergence window (counted).

        Resets and refills the split-half window tensors, adds the window
        counts into the running totals, and returns site updates taken.
        ``defer=True`` leaves the window's count delta on the device
        (``flush`` folds it into the host totals later), so the engine can
        launch many windows back to back without a host sync.  Each
        launch's counters (``SweepStack.launch_counts``) are counted here,
        but ``sites.merged``, which ``flush`` reduces with the deltas.
        """
        sweeps = self.cw if sweeps is None else int(sweeps)
        self._advance_fn(sweeps, sweeps // 2, count=True, fresh=True)
        self.total_sweeps += sweeps
        # counted sites are deterministic: every grouped (free) var of an
        # active variant counts once per sweep per chain
        free = [int(mv.free_mask.sum()) for mv in self.variants]
        taken = sweeps * self.cpv * sum(free)
        self.total_samples += taken
        self.tracer.add(self.sites_counter, taken)
        merged = 0
        for h, v0, _c0, na, stack in self.launches():
            counts = stack.launch_counts(h.device, na, self.local_chains, sweeps,
                                         free[v0:v0 + na])
            merged += counts.pop("sites.merged")
            for name, n in counts.items():
                self.tracer.add(name, n)
        self._pending.append((self._window_delta(), merged))
        if not defer:
            self.flush()
        return taken

    def _window_delta(self):
        """[(first slot, counts summed over the launch's chains
        [active slots, V+1, K] int64, on its device)], one per launch."""
        return [(v0, h.halves[:na].sum(dim=(1, 2))) for h, v0, _c0, na, _ in self.launches()]

    def _reduce(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` summed over the processes of the group (one: as is)."""
        return arr

    def flush(self) -> None:
        """Fold the pending windows into the host totals (one sync): their
        deltas and ``sites.merged`` updates summed, reduced by ``_reduce``
        once, then counted under ``sites.merged``, ``sites.folded`` (every
        outcome of the real vars) and, where the launches run the CUDA
        kernel, ``sites.rest_derived`` (``ops.sweep.rest_derived``).  The
        totals stay exact: integer counts below 2**53."""
        if not self._pending:
            return
        acc = np.zeros(self.totals.size + 1, dtype=np.int64)
        deltas = acc[:-1].reshape(self.totals.shape)
        for window, merged in self._pending:
            acc[-1] += merged
            for v0, d in window:
                deltas[v0:v0 + d.shape[0]] += d.cpu().numpy()
        self._pending.clear()
        acc = self._reduce(acc)  # one collective on a mesh of several processes
        deltas = acc[:-1].reshape(self.totals.shape)
        v = self.caps.num_vars
        self.tracer.add("sites.merged", acc[-1])
        self.tracer.add("sites.folded", deltas[:, :v].sum())
        if any(stack.kernel for *_, stack in self.launches()):
            self.tracer.add("sites.rest_derived", rest_derived(deltas, v))
        self.totals += deltas

    def restore_device_state(self, state, halves):
        """Place checkpointed chain state [Ncap, C, V+1] and window halves
        [Ncap, 2, C, V+1, K] (int32, any device or numpy) on ``device``."""
        self.state = torch.as_tensor(state, dtype=torch.int32, device=self.device)
        self.halves = torch.as_tensor(halves, dtype=torch.int32, device=self.device)

    # ---- estimation ------------------------------------------------------
    def rb_accumulate(self) -> None:
        """Take one Rao-Blackwell snapshot for every collapsed var.

        The true RB estimator averages the exact conditional
        P(var | blanket) over the collapsed variant's chain states: those
        chains sample the base joint with var integrated out, so the
        mixture converges to the var's true marginal, where the
        reference's static collapse-time marginal (the incident-factor
        enumeration) does not.  Plain slots also sample every blanket and
        donate snapshots too (reference ``chains.py:800-861``).  The
        engine calls this once per tick; states a window apart are
        decorrelated enough to stack like fresh samples.
        """
        if not self.rb_mixture:
            return
        v = self.caps.num_vars
        base_col = self.base.collapsed[:v]
        own, plain = [], []  # (slot, var) pairs collapsed in a slot; plain slots
        col_any = np.zeros(v, dtype=bool)
        for slot, mv in enumerate(self.variants):
            extra = mv.collapsed[:v] & ~base_col
            col_any |= extra
            own.extend((slot, int(var)) for var in np.nonzero(extra)[0])
            if not extra.any():
                plain.append(slot)
        if not own:
            return
        donors = [(p, int(cv)) for cv in np.nonzero(col_any)[0] for p in plain]
        probs = self._rb_snapshot(None, own + donors)
        for key, pr in zip(own, probs[: len(own)]):
            if key in self._rb_sum:
                self._rb_sum[key] = self._rb_sum[key] * RB_DECAY + pr
                self._rb_n[key] = self._rb_n[key] * RB_DECAY + 1.0
                self._rb_count[key] += 1
            else:
                self._rb_sum[key] = pr
                self._rb_n[key] = 1.0
                self._rb_count[key] = 1
        per_var: dict = {}
        for (_p, var), pr in zip(donors, probs[len(own):]):
            per_var.setdefault(var, []).append(pr)
        for var, prs in per_var.items():
            # same-tick donor slots combine at equal weight: the decay
            # applies once per tick, not between sibling slots
            self._rbp_accum(var, np.mean(prs, axis=0), self.cpv * len(prs))

    def rb_accumulate_external(self, states, chains_per_slot: int,
                               n_slots: int = 1) -> None:
        """Take plain-slot donor snapshots from ANOTHER group's base-model
        chain states ``states`` [N >= n_slots, C, V+1]: the split group
        feeds its full-width main slots here, so the aux group's collapsed
        vars follow the main ensemble (reference ``:863-882``)."""
        if not self.rb_mixture or self.num_variants == 0:
            return
        v = self.caps.num_vars
        col_vars = np.nonzero(self.collapsed_any() & ~self.base.collapsed[:v])[0]
        pairs = [(s, int(cv)) for cv in col_vars for s in range(n_slots)]
        if not pairs:
            return
        per_var: dict = {}
        for (_s, var), pr in zip(pairs, self._rb_snapshot(states, pairs)):
            per_var.setdefault(var, []).append(pr)
        for var, prs in per_var.items():
            self._rbp_accum(var, np.mean(prs, axis=0), chains_per_slot * len(prs))

    def _rbp_accum(self, var: int, probs: np.ndarray, weight: float):
        if var in self._rbp_sum:
            self._rbp_sum[var] = self._rbp_sum[var] * RB_DECAY + probs * weight
            self._rbp_w[var] = self._rbp_w[var] * RB_DECAY + weight
            self._rbp_snaps[var] += 1
        else:
            self._rbp_sum[var] = probs * weight
            self._rbp_w[var] = float(weight)
            self._rbp_snaps[var] = 1

    def _rb_snapshot(self, states, pairs) -> List[np.ndarray]:
        """One RB snapshot per (slot, var) pair: the normalized base
        conditional of ``var`` averaged over the chains of slot ``slot``
        of ``states`` [N, C, V+1] (None: the group's own chains)."""
        infos = []
        for _slot, var in pairs:
            if var not in self._rb_cond:
                self._rb_cond[var] = collapse_conditional(self.base, var)
            infos.append(self._rb_cond[var])
        bmax = max(info[0].size for info in infos)
        # sentinel column (var V, stride 0) pads ragged blankets
        rest = np.full((len(pairs), bmax), self.caps.num_vars, dtype=np.int64)
        strides = np.zeros((len(pairs), bmax), dtype=np.int64)
        for i, (r, s, _c) in enumerate(infos):
            rest[i, : r.size] = r
            strides[i, : r.size] = s
        idx = self._rb_index_rows(states, np.array([s for s, _ in pairs]), rest, strides)
        out = []
        for (_r, _s, cond), row in zip(infos, idx):
            counts = np.bincount(row, minlength=cond.shape[0]).astype(np.float64)
            out.append(counts @ cond / counts.sum())
        return out

    def _rb_index_rows(self, states, slots: np.ndarray, rest: np.ndarray,
                       strides: np.ndarray) -> np.ndarray:
        """Host [n, C] blanket indices (``_rb_indices``) of slots ``slots``
        of ``states`` (None: the group's own chains)."""
        states = self.state if states is None else states
        dev = states.device
        return _rb_indices(
            states,
            torch.as_tensor(slots, device=dev),
            torch.as_tensor(rest, device=dev),
            torch.as_tensor(strides, device=dev),
        ).cpu().numpy()

    def collapsed_any(self) -> np.ndarray:
        """[V] bool: collapsed in any active variant."""
        v = self.caps.num_vars
        out = np.zeros(v, dtype=bool)
        for mv in self.variants:
            out |= mv.collapsed[:v]
        return out

    def merged_marginals(self) -> np.ndarray:
        """Merged (unnormalized) marginal estimate [V, K] float64.

        Reference MergeChains: per chain a uniform 1/card seed plus its
        counts, summed over chains; a var collapsed in any variant takes
        the first collapsing slot's estimate instead (reference
        ``chains.py:945-993``): the chain-count-weighted blend of its own
        decayed RB mixture and the plain-slot donors' once either has
        ``RB_MIN_SNAPSHOTS`` snapshots, else the static collapse marginal.
        Rows are on different scales; every consumer normalizes per row.
        """
        self.flush()
        v, k = self.caps.num_vars, self.kdim
        cards = self.base.cards
        valid = np.arange(k)[None, :] < cards[:, None]
        uniform = valid / np.maximum(cards[:, None], 1)
        merged = self.num_chains * uniform + self.totals[: self.num_variants, :v].sum(axis=0)
        seen = np.zeros(v, dtype=bool)
        for slot, mv in enumerate(self.variants):
            for var in np.nonzero(mv.collapsed[:v] & ~seen)[0]:
                var_i = int(var)
                merged[var] = 0.0
                have_own = (self.rb_mixture and
                            self._rb_count.get((slot, var_i), 0) >= RB_MIN_SNAPSHOTS)
                have_plain = (self.rb_mixture and
                              self._rbp_snaps.get(var_i, 0) >= RB_MIN_SNAPSHOTS)
                if have_own or have_plain:
                    num, den = 0.0, 0.0
                    if have_own:
                        nrb = self._rb_n[(slot, var_i)]
                        w = nrb * self.cpv
                        num = self._rb_sum[(slot, var_i)] / nrb * w
                        den = w
                    if have_plain:
                        num = num + self._rbp_sum[var_i]
                        den = den + self._rbp_w[var_i]
                    est = num / den
                    merged[var, : est.size] = est
                else:
                    merged[var, : mv.marginals.shape[1]] = mv.marginals[var]
                seen[var] = True
        return merged

    def convergence(self, measure: str = "hellinger",
                    merged: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-variable PSRF over all active micro-chains. Returns [V];
        evidence and collapsed vars count as converged."""
        v = self.caps.num_vars
        if merged is None:
            merged = self.merged_marginals()
        nact = self.num_variants
        h = self.halves[:nact, :, :, :v, :]  # [Nact, 2, C, V, K]
        m_chains = nact * self.cpv
        dev = self.device
        converged = (self.base.fixed >= 0) | self.collapsed_any()
        vals = chain_convergence(
            h[:, 0].reshape(m_chains, v, self.kdim),
            h[:, 1].reshape(m_chains, v, self.kdim),
            torch.as_tensor(merged, dtype=torch.float32, device=dev),
            torch.as_tensor(self.base.cards, dtype=torch.int32, device=dev),
            torch.as_tensor(converged, device=dev),
            torch.ones(m_chains, dtype=torch.bool, device=dev),
            float(self.cw),
            measure=measure,
        )
        return vals.cpu().numpy().astype(np.float64)
