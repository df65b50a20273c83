"""The port's ChainGroup: initial states equal the reference's, counted
windows converge to the exact marginals, runs are reproducible; collapse
variants, caps growth and the Rao-Blackwell mixture against the
reference's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.pgm.encode as ref_encode
import grample_tpu.sampler.chains as ref_chains
import grample_tpu.sampler.collapse as ref_collapse
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
import grample_tpu_torch.sampler.chains as port_chains
import grample_tpu_torch.sampler.collapse as port_collapse
from grample_tpu.sampler.chains import ChainGroup as RefChainGroup
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.chains import ChainGroup

from tests import torch_models


def _hell_bound(n_eff: float) -> float:
    """5 sigma of a max Hellinger error over a handful of binary vars with
    ``n_eff`` independent draws each: H ≈ |Δp| / sqrt(8 p q) and
    sigma(Δp) = sqrt(p q / n), so sigma(H) ≈ 1 / sqrt(8 n)."""
    return 5.0 / np.sqrt(8.0 * n_eff)


@pytest.mark.parametrize("how", ["add_variant", "reserve_add_variants"])
@pytest.mark.parametrize("name", ["grid4_evid", "rand8_card4"])
def test_initial_states_match_reference(name, how):
    """Host chain init draws the reference's numbers for the same seed and
    the same sequence of slot operations (``chains.py:346-373``)."""
    groups = []
    for pgm, cls, kw in ((ref_pgm, RefChainGroup, {}),
                         (port_pgm, ChainGroup, {"device": "cpu"})):
        m = torch_models.build(pgm, name)
        g = cls(m, chains_per_variant=16, converge_window=4, seed=3, **kw)
        if how == "add_variant":
            g.add_variant(m)
            g.add_variant(m)
            g.add_variant(m)
        else:
            g.reserve(2)
            g.add_variants([m, m])
        groups.append(g)
    ref, port = groups
    assert port.slot_cap == ref.slot_cap
    np.testing.assert_array_equal(port.state.numpy(), np.asarray(ref.state))


def test_advance_and_merge_vs_exact():
    m = torch_models.chain_model(port_pgm, seed=12345)
    truth = exact_marginals(m)
    g = ChainGroup(m, chains_per_variant=128, converge_window=100, device="cpu", seed=1)
    g.add_variant(m)
    g.add_variant(m)
    g.burn(50)
    for _ in range(4):
        g.advance()
    assert g.num_chains == 256
    assert g.total_samples == 256 * 4 * 100 * m.num_vars
    h = hellinger(g.merged_marginals(), truth, m.cards)
    # 256 chains x 400 counted sweeps; a chain of 4 binary vars mixes in a
    # few sweeps, so n_eff >= 256 * 400 / 4
    assert h.max() < _hell_bound(256 * 400 / 4), h


@pytest.mark.parametrize("name", ["grid4_evid", "grid3_card3_evid"])
def test_annealed_burn_and_deferred_windows_vs_exact(name):
    """The engine's sequence: tempered burn-in, then deferred windows
    flushed once; taken = sweeps x chains x free vars."""
    m = torch_models.build(port_pgm, name)
    truth = exact_marginals(m)
    g = ChainGroup(m, chains_per_variant=256, converge_window=40, device="cpu", seed=9)
    g.add_variants([m, m])
    g.warmup()
    g.burn_annealed(40, stages=4)
    taken = sum(g.advance(defer=True) for _ in range(5))
    free = int(m.free_mask.sum())
    assert taken == g.total_samples == 5 * 40 * 512 * free
    assert len(g._pending) == 5
    merged = g.merged_marginals()
    assert not g._pending
    counted = g.totals[:2, :-1].sum(axis=(0, 2))
    np.testing.assert_array_equal(counted[m.free_mask], 5 * 40 * 512)
    assert counted[~m.free_mask].sum() == 0
    h = hellinger(merged, truth, m.cards, m.fixed)
    assert h.max() < _hell_bound(512 * 200 / 8), h


def test_same_seed_same_result():
    m = torch_models.chain_model(port_pgm, seed=7)

    def run(seed):
        g = ChainGroup(m, chains_per_variant=32, converge_window=40, device="cpu", seed=seed)
        g.add_variant(m)
        g.burn(10)
        g.advance()
        return g.merged_marginals(), g.state.clone()

    (a, sa), (b, sb) = run(7), run(7)
    np.testing.assert_array_equal(a, b)
    assert torch.equal(sa, sb)
    c, _ = run(8)
    assert not np.array_equal(a, c)


def test_warmup_is_neutral():
    """warmup launches the sweep but restores state, window and seeds."""
    m = torch_models.build(port_pgm, "grid3")
    runs = []
    for warm in (False, True):
        g = ChainGroup(m, chains_per_variant=16, converge_window=8, device="cpu", seed=4)
        g.add_variant(m)
        if warm:
            g.warmup()
        g.advance()
        runs.append((g.state.clone(), g.halves.clone(), g.totals.copy()))
    for x, y in zip(*runs):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def test_burn_annealed_restores_tables():
    m = torch_models.build(port_pgm, "grid3")
    g = ChainGroup(m, chains_per_variant=8, converge_window=8, device="cpu", seed=2)
    g.add_variant(m)
    tables = g.kstack.tensors[g.device]["k_tables"].clone()
    g.burn_annealed(12, stages=3)
    assert torch.equal(g.kstack.tensors[g.device]["k_tables"], tables)
    assert g.total_sweeps == 12


def test_convergence_scores():
    m = torch_models.chain_model(port_pgm, seed=3)
    m.apply_evidence({3: 1})
    g = ChainGroup(m, chains_per_variant=64, converge_window=100, device="cpu", seed=3)
    g.add_variant(m)
    g.add_variant(m)
    g.burn(20)
    g.advance()
    for measure in ("hellinger", "js", "maxabs", "meanabs"):
        psrf = g.convergence(measure=measure)
        assert psrf.shape == (m.num_vars,)
        assert psrf[3] == 1.0  # fixed
        assert np.isfinite(psrf).all()
    # distance-PSRF floor is sqrt(2*(n-1)/n) ~ sqrt(2) for free vars
    assert (g.convergence()[:3] > 1.2).all()


def test_capacity_growth_preserves_totals():
    m = torch_models.chain_model(port_pgm, seed=4)
    g = ChainGroup(m, chains_per_variant=16, converge_window=20, device="cpu", seed=4)
    g.add_variant(m)
    g.advance()
    before = g.totals[0].copy()
    assert g.slot_cap == 1
    g.add_variant(m)
    assert g.slot_cap == 2
    g.add_variant(m)
    assert g.slot_cap == 4
    np.testing.assert_array_equal(g.totals[0], before)
    g.advance()
    assert g.num_chains == 48
    assert g.totals[3].sum() == 0  # inactive slot contributes nothing
    with pytest.raises(RuntimeError, match="variant limit"):
        ChainGroup(m, 4, 4, device="cpu", max_variants=1).add_variants([m, m])


# ---- collapse variants and the Rao-Blackwell mixture ------------------------

def test_rb_constants_match_reference():
    assert port_chains.RB_DECAY == ref_chains.RB_DECAY == 0.85
    assert port_chains.RB_MIN_SNAPSHOTS == ref_chains.RB_MIN_SNAPSHOTS == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_rb_indices_match_reference(seed):
    """One gather to [n, C, B] gives the reference's blanket indices."""
    rng = np.random.default_rng(seed)
    n_slots, c, v1, n, b = 4, 16, 10, 7, 5
    state = rng.integers(0, 3, (n_slots, c, v1)).astype(np.int32)
    slots = rng.integers(0, n_slots, n).astype(np.int32)
    rest = rng.integers(0, v1, (n, b)).astype(np.int32)
    strides = rng.integers(0, 9, (n, b)).astype(np.int32)
    want = np.asarray(ref_chains._rb_indices(jnp.asarray(state), jnp.asarray(slots),
                                             jnp.asarray(rest), jnp.asarray(strides)))
    got = port_chains._rb_indices(torch.as_tensor(state), torch.as_tensor(slots).long(),
                                  torch.as_tensor(rest).long(), torch.as_tensor(strides))
    np.testing.assert_array_equal(got.numpy(), want)


#: slot layouts: (MODELS entry, per-slot collapsed var or None for plain)
RB_CASES = {
    "own": ("star8", [0, 3]),
    "donors": ("star8", [None, 0, 3]),
    "evidence": ("full8_evid", [2, None, 5, 2]),
}


def _rb_groups(case, rb_mixture=True):
    """The same group in both packages: base model, collapse variants and
    exact variant caps (the base does not fit them: caps grow)."""
    name, layout = RB_CASES[case]
    groups = []
    for pgm, enc, col, cls, kw in (
            (ref_pgm, ref_encode, ref_collapse, RefChainGroup, {}),
            (port_pgm, port_encode, port_collapse, ChainGroup, {"device": "cpu"})):
        m = torch_models.build(pgm, name)
        variants = [m if v is None else col.collapse_var(m, v)[0] for v in layout]
        caps = enc.caps_for_variants(variants, slot_hint=len(variants))
        g = cls(m, chains_per_variant=32, converge_window=8, seed=5, caps=caps,
                rb_mixture=rb_mixture, **kw)
        g.reserve(len(variants))
        g.add_variants(variants)
        groups.append(g)
    return groups


def _set_states(ref, port, rng):
    """The same random chain states and window totals in both groups."""
    cards = port.base.cards
    st = np.floor(rng.random(port.state.shape) * np.append(cards, 1)).astype(np.int32)
    fixed = np.append(port.base.fixed, 0)
    st = np.where(fixed >= 0, fixed, st).astype(np.int32)
    ref.state = jnp.asarray(st)
    port.state = torch.as_tensor(st)
    tot = rng.integers(0, 50, port.totals.shape).astype(np.float64)
    ref.totals, port.totals = tot.copy(), tot.copy()


@pytest.mark.parametrize("case", sorted(RB_CASES))
def test_rb_mixture_matches_reference(case):
    """Given the same states and totals, every snapshot's running sums,
    weights and counts, and the merged marginals, equal the reference's to
    float64 rounding: own snapshots, plain-slot donors, the
    RB_MIN_SNAPSHOTS gate (the static marginal stands until then) and the
    RB_DECAY weights."""
    ref, port = _rb_groups(case)
    assert dataclasses.asdict(port.caps) == {
        **dataclasses.asdict(ref.caps), "base_mode": "rowgather"}
    np.testing.assert_array_equal(port.state.numpy(), np.asarray(ref.state))
    rng = np.random.default_rng(17)
    col = port.collapsed_any()
    np.testing.assert_array_equal(col, ref.collapsed_any())
    first = next(s for s, mv in enumerate(port.variants) if mv.collapsed.any())
    for snap in range(1, 5):
        _set_states(ref, port, rng)
        ref.rb_accumulate()
        port.rb_accumulate()
        for name in ("_rb_n", "_rb_count", "_rbp_snaps"):
            assert getattr(port, name) == pytest.approx(getattr(ref, name), rel=1e-12), name
        for name in ("_rb_sum", "_rbp_sum", "_rbp_w"):
            want, got = getattr(ref, name), getattr(port, name)
            assert set(got) == set(want), name
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=name)
        merged = port.merged_marginals()
        np.testing.assert_allclose(merged, ref.merged_marginals(), rtol=1e-12)
        static = port.variants[first].marginals
        var = int(np.nonzero(port.variants[first].collapsed)[0][0])
        if snap < port_chains.RB_MIN_SNAPSHOTS:
            np.testing.assert_array_equal(merged[var], static[var])
        else:
            assert not np.allclose(merged[var], static[var], rtol=1e-6)
    key = (first, var)
    n_own = sum(port_chains.RB_DECAY ** i for i in range(4))
    assert port._rb_n[key] == pytest.approx(n_own, rel=1e-12)
    assert port._rb_count[key] == 4
    plain = [s for s, mv in enumerate(port.variants) if not mv.collapsed.any()]
    if plain:
        assert port._rbp_w[var] == pytest.approx(n_own * 32 * len(plain), rel=1e-12)
    else:
        assert not port._rbp_w


@pytest.mark.parametrize("case", ["own", "donors"])
def test_rb_mixture_off_matches_reference(case):
    """``rb_mixture=False``: no snapshots; every collapsed var keeps its
    static collapse marginal, as in the reference."""
    ref, port = _rb_groups(case, rb_mixture=False)
    rng = np.random.default_rng(3)
    for _ in range(3):
        _set_states(ref, port, rng)
        ref.rb_accumulate()
        port.rb_accumulate()
    assert not port._rb_sum and not port._rbp_sum
    merged = port.merged_marginals()
    np.testing.assert_allclose(merged, ref.merged_marginals(), rtol=1e-12)
    for slot, mv in enumerate(port.variants):
        for var in np.nonzero(mv.collapsed)[0]:
            first = next(s for s, w in enumerate(port.variants) if w.collapsed[var])
            np.testing.assert_array_equal(merged[var], port.variants[first].marginals[var])


def test_collapse_variant_group_converges_to_exact():
    """A group of a 64-row collapse variant of the 8-var star and a plain
    slot converges to the exact marginals on the CPU, the collapsed centre
    included (its RB mixture), as ``tests/test_pallas.py:197-235``; PSRF
    counts the collapsed var as converged."""
    m = torch_models.build(port_pgm, "star8")
    truth = exact_marginals(m)
    variant, _ = port_collapse.collapse_var(m, 0)
    caps = port_encode.caps_for_variants([variant], slot_hint=2)
    assert caps.oa_cap == 64
    g = ChainGroup(m, chains_per_variant=256, converge_window=32, device="cpu",
                   seed=5, caps=caps)
    g.reserve(2)
    g.add_variants([variant, m])
    assert g.caps.oa_cap == 64 and g.caps.adj_cap > caps.adj_cap  # grown for the base
    g.burn(30)
    for _ in range(6):
        g.advance(32)
        g.rb_accumulate()
    h = hellinger(g.merged_marginals(), truth, m.cards)
    # 512 chains x 192 counted sweeps on a tree that mixes within ~4
    # sweeps: 5 sigma with n_eff >= 512 * 192 / 4, plus at most 3e-3 of
    # bias from each chain's uniform seed over 192 counted sweeps; the
    # centre's RB mixture averages the exact conditional over >= 512
    # chains per snapshot and is tighter still
    assert h.max() < _hell_bound(512 * 192 / 4) + 3e-3, h
    assert g._rb_count[(0, 0)] == 6 and g._rbp_snaps[0] == 6
    psrf = g.convergence()
    assert psrf[0] == 1.0 and np.isfinite(psrf).all()
    assert (psrf[1:] > 1.0).all()
