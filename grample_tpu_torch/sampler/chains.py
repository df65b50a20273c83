"""Chain runtime: batched chains over stacked model variants, in torch.

Counterpart of ``grample_tpu.sampler.chains.ChainGroup``, plain subset.
One sweep launch advances every chain of every active variant at once:

  - variant slot axis  [N]: distinct factor graphs (logical chains),
  - micro-chain axis   [C]: independent chains per variant,

with state ``[N, C, V+1]`` int32 and split-half window counts
``[N, 2, C, V+1, K]`` int32 resident on ``device``.  Slot capacity grows
in powers of two.

``merged_marginals`` is the reference's ``MergeChains`` for plain chains:
every chain contributes its uniform-initialized marginal (1/card per
entry) plus its counts.  Collapse variants, the Rao-Blackwell mixture,
and the reference's TPU workarounds (slot chunking, counted sub-windows,
the compile-error fallback) are not part of this port.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from grample_tpu_torch.metrics.psrf import chain_convergence
from grample_tpu_torch.ops.sweep import (
    advance_chains,
    check_supported,
    hash_block,
    sweep_tensors,
)
from grample_tpu_torch.pgm.discrete import DiscreteModel
from grample_tpu_torch.pgm.encode import (
    EncodeCaps,
    EncodedModel,
    compute_caps,
    encode_model,
    stack_variants,
)

MAX_VARIANTS = 128  # reference ConvergenceSampler.MaxChains (adaptive.go:49)

#: Default tempered burn-in stages (see :meth:`ChainGroup.burn_annealed`).
ANNEAL_STAGES = 20


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class ChainGroup:
    """All chains of a run: stacked variants × micro-chains on ``device``."""

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
    ):
        base_model.check()
        self.base = base_model
        self.device = torch.device(device)
        self.cpv = int(chains_per_variant)
        self.cw = int(converge_window)
        self.seed = int(seed)
        self.max_variants = max_variants
        # plain groups never mutate the factor graph: no spare factor slots
        self.caps = caps or compute_caps(
            base_model, group_cap=group_cap, headroom_factors=0
        )
        check_supported(self.caps)
        #: window seeds: one int32 per launched window
        self.gen = torch.Generator().manual_seed(self.seed)
        self.cb = hash_block(self.cpv)
        self._step = 0

        self.variants: List[DiscreteModel] = []
        self.encs: List[EncodedModel] = []
        self.slot_cap = 0
        self.kstack = None  # kernel-order sweep tensors [Ncap, ...]
        self.state = None  # [Ncap, C, V+1] int32
        self.halves = None  # [Ncap, 2, C, V+1, K] int32
        self.totals: Optional[np.ndarray] = None  # host f64 [Ncap, V+1, K]
        self.total_samples = 0  # counted site updates across all chains
        self.total_sweeps = 0
        # deferred window deltas: (device [Ncap, V+1, K] int64, n_active)
        # pairs not yet folded into ``totals`` — the engine dispatches many
        # windows without a host sync per window
        self._pending: List[tuple] = []

    # ---- capacity management --------------------------------------------
    @property
    def num_variants(self) -> int:
        return len(self.variants)

    @property
    def num_chains(self) -> int:
        return self.num_variants * self.cpv

    @property
    def v1(self) -> int:
        return self.caps.num_vars + 1

    @property
    def kdim(self) -> int:
        return self.caps.max_card

    def _next_seed(self) -> int:
        """Window seed (int32).  Advances ``_step`` as the reference's
        per-window key fold does, so later host inits line up with it."""
        self._step += 1
        return int(torch.randint(-2**31, 2**31, (1,), generator=self.gen,
                                 dtype=torch.int64))

    def _host_init_state(self, enc: EncodedModel) -> np.ndarray:
        """Initial [C, V+1] states on the host: free vars uniform, evidence
        pinned.  The same draws as the reference for the same ``_step``
        (``chains.py:346-373``)."""
        rng = np.random.default_rng(self._step * 7919 + 13)
        self._step += 1
        cards = np.asarray(enc.cards, dtype=np.int64)  # [V+1]
        u = rng.random((self.cpv, cards.size))
        draw = np.floor(u * cards[None, :]).astype(np.int32)
        fixedv = np.asarray(enc.fixed, dtype=np.int32)
        return np.where(fixedv[None, :] >= 0, fixedv[None, :], draw)

    def reserve(self, n_slots: int):
        """Pre-size slot capacity to avoid intermediate restacks."""
        cap = _next_pow2(max(1, n_slots))
        if cap > self.slot_cap:
            self._restack(cap)

    def _restack(self, new_slot_cap: Optional[int] = None):
        """Rebuild stacked device arrays, preserving live slot state."""
        self.flush()  # pending deltas are shaped for the OLD slot capacity
        if new_slot_cap is not None:
            self.slot_cap = new_slot_cap
        if self.slot_cap == 0:
            return
        base_enc = self.encs[0] if self.encs else encode_model(self.base, self.caps)
        padded = list(self.encs) + [base_enc] * (self.slot_cap - len(self.encs))
        self.kstack = sweep_tensors(stack_variants(padded), self.device)

        new_state = torch.as_tensor(
            np.stack([self._host_init_state(enc) for enc in padded]),
            device=self.device,
        )
        if self.state is not None:
            n = min(self.state.shape[0], self.slot_cap)
            new_state[:n] = self.state[:n]
        self.state = new_state
        self.halves = torch.zeros(
            (self.slot_cap, 2, self.cpv, self.v1, self.kdim),
            dtype=torch.int32, device=self.device,
        )
        old_tot = self.totals
        self.totals = np.zeros((self.slot_cap, self.v1, self.kdim), dtype=np.float64)
        if old_tot is not None:
            n = min(old_tot.shape[0], self.slot_cap)
            self.totals[:n] = old_tot[:n]

    def add_variant(self, model: DiscreteModel) -> int:
        """Add a model variant (a logical chain); returns its slot index."""
        return self.add_variants([model])[0]

    def add_variants(self, models: List[DiscreteModel]) -> List[int]:
        """Add variants with one device update per stack key; each must
        encode within the group's caps."""
        if not models:
            return []
        if self.num_variants + len(models) > self.max_variants:
            raise RuntimeError(f"variant limit {self.max_variants} reached")
        new_encs = [encode_model(mv, self.caps) for mv in models]
        slot0 = len(self.variants)
        slots = list(range(slot0, slot0 + len(models)))
        self.variants.extend(models)
        self.encs.extend(new_encs)
        if slots[-1] >= self.slot_cap:
            self._restack(_next_pow2(slots[-1] + 1))
        else:
            fresh = sweep_tensors(stack_variants(new_encs), self.device)
            for k, v in fresh.items():
                self.kstack[k][slots] = v
        st = np.stack([self._host_init_state(enc) for enc in new_encs])
        self.state[slots] = torch.as_tensor(st, device=self.device)
        self.totals[slots] = 0.0
        return slots

    # ---- advancing -------------------------------------------------------
    def _advance_fn(self, sweeps: int, half: int, count: bool):
        """Advance the ACTIVE slot prefix by one window."""
        nact = max(1, self.num_variants)
        st, hv = advance_chains(
            {k: v[:nact] for k, v in self.kstack.items()},
            self.state[:nact], self.halves[:nact], self._next_seed(),
            sweeps, half, count=count, cb=self.cb,
        )
        self.state[:nact] = st
        self.halves[:nact] = hv

    def warmup(self):
        """Build and first-launch the sweep (one counted and one uncounted
        sweep), then restore the exact prior state, window and seeds.
        Engines call it before anchoring time budgets."""
        if self.slot_cap == 0:
            return
        step, gen_state = self._step, self.gen.get_state()
        state, halves = self.state.clone(), self.halves.clone()
        self._advance_fn(1, 0, count=True)
        self._advance_fn(1, 1, count=False)
        self.halves.sum().item()  # sync: wait out first-launch overheads
        self.state, self.halves = state, halves
        self._step = step
        self.gen.set_state(gen_state)

    def burn(self, sweeps: int):
        """Uncounted sweeps for all chains (burn-in)."""
        if sweeps <= 0 or self.slot_cap == 0:
            return
        self._advance_fn(int(sweeps), int(sweeps), count=False)
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
        stack0 = self.kstack
        try:
            for i in range(stages):
                beta = (i + 1.0) / stages
                n = per + (sweeps - per * stages if i == stages - 1 else 0)
                # scale only the log-potential tables; the rest is structural
                self.kstack = stack0 if beta >= 1.0 else {
                    **stack0, "k_tables": stack0["k_tables"] * beta}
                self.burn(n)
        finally:
            self.kstack = stack0

    def advance(self, sweeps: Optional[int] = None, defer: bool = False) -> int:
        """Advance all chains one convergence window (counted).

        Resets and refills the split-half window tensors, adds the window
        counts into the running totals, and returns site updates taken.
        ``defer=True`` leaves the window's count delta on the device
        (``flush`` folds it into the host totals later), so the engine can
        launch many windows back to back without a host sync.
        """
        sweeps = self.cw if sweeps is None else int(sweeps)
        self.halves.zero_()
        self._advance_fn(sweeps, sweeps // 2, count=True)
        self._pending.append((self.halves.sum(dim=(1, 2)), self.num_variants))
        self.total_sweeps += sweeps
        # counted sites are deterministic: every grouped (free) var of an
        # active variant counts once per sweep per chain
        taken = sweeps * self.cpv * sum(
            int(mv.free_mask.sum()) for mv in self.variants
        )
        self.total_samples += taken
        if not defer:
            self.flush()
        return taken

    def flush(self) -> None:
        """Fold all pending window deltas into the host totals (one sync)."""
        for delta, nact in self._pending:
            d = delta.cpu().numpy().astype(np.float64)
            d[nact:] = 0.0
            self.totals += d
        self._pending.clear()

    # ---- estimation ------------------------------------------------------
    def merged_marginals(self) -> np.ndarray:
        """Merged (unnormalized) marginal estimate [V, K] float64: per
        chain a uniform 1/card seed plus its counts, summed over chains
        (reference MergeChains)."""
        self.flush()
        v, k = self.caps.num_vars, self.kdim
        cards = self.base.cards
        valid = np.arange(k)[None, :] < cards[:, None]
        uniform = valid / np.maximum(cards[:, None], 1)
        return self.num_chains * uniform + self.totals[: self.num_variants, :v].sum(axis=0)

    def convergence(self, measure: str = "hellinger",
                    merged: Optional[np.ndarray] = None) -> np.ndarray:
        """Per-variable PSRF over all active micro-chains. Returns [V]."""
        v = self.caps.num_vars
        if merged is None:
            merged = self.merged_marginals()
        nact = self.num_variants
        h = self.halves[:nact, :, :, :v, :]  # [Nact, 2, C, V, K]
        m_chains = nact * self.cpv
        dev = self.device
        vals = chain_convergence(
            h[:, 0].reshape(m_chains, v, self.kdim),
            h[:, 1].reshape(m_chains, v, self.kdim),
            torch.as_tensor(merged, dtype=torch.float32, device=dev),
            torch.as_tensor(self.base.cards, dtype=torch.int32, device=dev),
            torch.as_tensor(self.base.fixed >= 0, device=dev),
            torch.ones(m_chains, dtype=torch.bool, device=dev),
            float(self.cw),
            measure=measure,
        )
        return vals.cpu().numpy().astype(np.float64)
