"""The port's ChainGroup: initial states equal the reference's, counted
windows converge to the exact marginals, runs are reproducible."""

import numpy as np
import pytest
import torch

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu_torch.pgm.discrete as port_pgm
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
    tables = g.kstack["k_tables"].clone()
    g.burn_annealed(12, stages=3)
    assert torch.equal(g.kstack["k_tables"], tables)
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
