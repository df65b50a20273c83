"""The port's adaptive sampler against the reference's: the stateless
window seed, warm and transplanted chain inits, ``aux_caps``,
``adapt_step``'s targets and ``rb_accumulate_external`` on identical
states; the split group's routing, merge and capacity; and adaptive
engine runs held against exact marginals."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.pgm.encode as ref_encode
import grample_tpu.sampler.adaptive as ref_adaptive
import grample_tpu.sampler.collapse as ref_collapse
import grample_tpu.sampler.engine as ref_engine
import grample_tpu.sampler.split as ref_split
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
import grample_tpu_torch.sampler.adaptive as port_adaptive
import grample_tpu_torch.sampler.collapse as port_collapse
import grample_tpu_torch.sampler.engine as port_engine
import grample_tpu_torch.sampler.split as port_split
from grample_tpu.sampler.chains import ChainGroup as RefChainGroup
from grample_tpu_torch import cli
from grample_tpu_torch.convert import carry_group_state
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.chains import RB_DECAY, ChainGroup, window_seed
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.sampler.split import AUX_MAX_VARIANTS, SplitChainGroup
from grample_tpu_torch.uai.writer import write_mar, write_model

from tests import torch_models


def quiet(_msg):
    pass


# ---- the window seed (a function of seed and step) -------------------------

def test_window_seed_values():
    seeds = {window_seed(s, k) for s in (0, 1, 2**40) for k in range(1, 50)}
    assert len(seeds) == 3 * 49
    assert all(-2**31 <= x < 2**31 for x in seeds)
    assert window_seed(7, 3) == window_seed(7, 3)
    assert window_seed(-1, 3) == window_seed(2**64 - 1, 3)


@pytest.mark.parametrize("k", [1, 3])
def test_window_seed_is_function_of_seed_and_step(k):
    """A group advanced k windows and a fresh group given its state and
    step take the same next window: same seed, state and halves."""
    m = torch_models.build(port_pgm, "grid4_evid")

    def fresh():
        g = ChainGroup(m, chains_per_variant=32, converge_window=6, device="cpu", seed=11)
        g.add_variants([m, m])
        return g

    a = fresh()
    a.warmup()
    for _ in range(k):
        a.advance()
    b = fresh()
    b.restore_device_state(a.state, a.halves)
    b._step = a._step
    assert a._step == b._step > k
    seeds = [[], []]
    for g, log in zip((a, b), seeds):
        launch = g._advance_fn
        g._advance_fn = lambda *args, g=g, log=log, launch=launch, **kw: (
            log.append(window_seed(g.seed, g._step + 1)), launch(*args, **kw))
        g.advance()
    assert seeds[0] == seeds[1] and len(seeds[0]) == 1
    assert torch.equal(a.state, b.state) and torch.equal(a.halves, b.halves)
    assert a._step == b._step


# ---- chain inits equal the reference's --------------------------------------

def _pair(name, cpv=16, **kw):
    """The same group in both packages, 2 plain slots."""
    groups = []
    for pgm, cls, extra in ((ref_pgm, RefChainGroup, {}),
                            (port_pgm, ChainGroup, {"device": "cpu"})):
        m = torch_models.build(pgm, name)
        g = cls(m, chains_per_variant=cpv, converge_window=8, seed=5, **kw, **extra)
        g.add_variants([m, m])
        groups.append(g)
    return groups


@pytest.mark.parametrize("name", ["grid4_evid", "rand8_card4", "grid3_card3_evid"])
def test_warm_init_matches_reference(name):
    """``_host_init_state(enc, warm_marginals)`` draws the reference's
    states for the same ``_step`` (merged-marginal redraw)."""
    ref, port = _pair(name)
    rng = np.random.default_rng(3)
    warm = rng.random((port.caps.num_vars, port.kdim))
    for step in (0, 7, 123):
        ref._step = port._step = step
        want = ref._host_init_state(ref.encs[0], warm)
        got = port._host_init_state(port.encs[0], warm)
        np.testing.assert_array_equal(got, want)
        assert port._step == ref._step == step + 1


@pytest.mark.parametrize("rows", [5, 16, 40])
def test_transplant_states_match_reference(rows):
    """``_transplant_states`` picks the reference's donor rows for the same
    ``_step`` (with replacement below, without above, identity at cpv)."""
    ref, port = _pair("grid4_evid")
    rng = np.random.default_rng(rows)
    donors = rng.integers(0, 2, (rows, port.v1)).astype(np.int32)
    for step in (2, 31):
        ref._step = port._step = step
        want = ref._transplant_states(ref.encs[0], donors)
        got = port._transplant_states(port.encs[0], donors)
        np.testing.assert_array_equal(got, want)
    assert (got[:, [5, 10]] == [1, 0]).all()  # evidence re-pinned
    with pytest.raises(ValueError, match="init_states shape"):
        port._transplant_states(port.encs[0], donors[:, :-1])


def _caps_fields(caps):
    d = dataclasses.asdict(caps)
    d["base_mode"] = {"matmul": "rowgather"}.get(d["base_mode"], d["base_mode"])
    return d


@pytest.mark.parametrize("net", ["grid10", "promedus", "star8"])
def test_aux_caps_match_reference(net):
    """``aux_caps`` field for field: headroom for 8 slots merged with the
    three widest candidates' caps, rowgather."""
    caps = {}
    for pgm, split in ((ref_pgm, ref_split), (port_pgm, port_split)):
        if net == "grid10":
            m = torch_models.grid(pgm, 10, seed=1)
        elif net == "promedus":
            m, evidence = torch_models.promedus_like(pgm, seed=1)
            m.apply_evidence(evidence)
        else:
            m = torch_models.build(pgm, net)
        caps[split] = split.aux_caps(m)
    assert _caps_fields(caps[port_split]) == _caps_fields(caps[ref_split])
    assert caps[port_split].base_mode == "rowgather" and caps[port_split].gfac_cap == 0
    if net == "promedus":
        assert (caps[port_split].oa_cap, caps[port_split].num_rows) == (256, 4200)


# ---- adapt_step and rb_accumulate_external on identical states --------------

def _random_window(g, rng):
    """Random chain states, window halves (every free chain site counted
    cw times) and totals for a reference group ``g``."""
    n, c, v1 = g.slot_cap, g.cpv, g.v1
    cards = np.append(g.base.cards, 1)
    fixed = np.append(g.base.fixed, 0)
    st = np.floor(rng.random((n, c, v1)) * cards).astype(np.int32)
    g.state = jnp.asarray(np.where(fixed >= 0, fixed, st).astype(np.int32))
    k = g.kdim
    halves = np.zeros((n, 2, c, v1, k), np.float32)
    for var in np.nonzero(fixed < 0)[0]:
        p = rng.dirichlet(np.ones(int(cards[var])), size=(n, 2, c))
        halves[:, :, :, var, : cards[var]] = rng.multinomial(g.cw // 2, p.reshape(-1, cards[var])) \
            .reshape(n, 2, c, cards[var])
    g.halves = jnp.asarray(halves)
    g.totals = rng.integers(0, 50, g.totals.shape).astype(np.float64)


def _capture(group):
    """Replace ``group.add_variants`` by a recorder of its arguments."""
    calls = []

    def record(variants, burn_sweeps=0, warm_marginals=None, init_states=None):
        calls.append((variants, burn_sweeps, warm_marginals, init_states))
        return list(range(len(variants)))

    group.add_variants = record
    return calls


@pytest.mark.parametrize("init", ["redraw", "transplant"])
@pytest.mark.parametrize("policy", ["worst", "ref-tail"])
def test_adapt_step_matches_reference(policy, init):
    """On identical carried-over states, ``adapt_step`` picks the
    reference's targets and passes the same collapse variants, burn,
    warm marginals or transplant donors to ``add_variants``."""
    ref, port = _pair("grid4_evid", cpv=32, collapse_headroom=True)
    assert port.collapse_oa_cap == ref.collapse_oa_cap
    _random_window(ref, np.random.default_rng(7))
    carry_group_state(ref, port)
    ref.adapt_init = port.adapt_init = init
    calls = {}
    for mod, g in ((ref_adaptive, ref), (port_adaptive, port)):
        calls[mod] = _capture(g)
        targets = mod.adapt_step(g, 3, policy=policy)
        assert len(targets) == 3
        calls[mod].append(targets)
    (rv, rb, rw, ri), rt = calls[ref_adaptive]
    (pv, pb, pw, pi), pt = calls[port_adaptive]
    assert pt == rt and pb == rb == port_adaptive.ADAPT_BURN_SWEEPS
    assert [np.nonzero(v.collapsed)[0].tolist() for v in pv] == [[t] for t in pt]
    for a, b in zip(pv, rv):
        np.testing.assert_allclose(a.marginals, b.marginals, rtol=1e-12)
    if init == "redraw":
        assert pi is None and ri is None
        np.testing.assert_array_equal(pw, rw)
    else:
        assert pw is None and rw is None
        np.testing.assert_array_equal(pi, np.asarray(ri))


def _rb_pair(layout, name="star8"):
    """Both packages' groups over the same collapse variants (exact caps)."""
    groups = []
    for pgm, enc, col, cls, kw in (
            (ref_pgm, ref_encode, ref_collapse, RefChainGroup, {}),
            (port_pgm, port_encode, port_collapse, ChainGroup, {"device": "cpu"})):
        m = torch_models.build(pgm, name)
        variants = [m if v is None else col.collapse_var(m, v)[0] for v in layout]
        caps = enc.caps_for_variants(variants, slot_hint=len(variants))
        g = cls(m, chains_per_variant=32, converge_window=8, seed=5, caps=caps, **kw)
        g.add_variants(variants)
        groups.append(g)
    return groups


@pytest.mark.parametrize("layout", [[0, 3], [None, 2]])
def test_rb_accumulate_external_matches_reference(layout):
    """External donor snapshots (a main group's 2 plain slots of 48
    chains) give the reference's sums and decayed weights at rtol 1e-12,
    snapshot after snapshot, and the same merged marginals."""
    ref, port = _rb_pair(layout)
    rng = np.random.default_rng(23)
    v1 = port.v1
    for snap in range(1, 5):
        ext = np.floor(rng.random((2, 48, v1)) * np.append(port.base.cards, 1)).astype(np.int32)
        ref.rb_accumulate_external(jnp.asarray(ext), 48, n_slots=2)
        port.rb_accumulate_external(torch.as_tensor(ext), 48, n_slots=2)
        assert port._rbp_snaps == ref._rbp_snaps
        assert set(port._rbp_sum) == set(ref._rbp_sum) == {v for v in layout if v is not None}
        for var in ref._rbp_sum:
            np.testing.assert_allclose(port._rbp_sum[var], ref._rbp_sum[var], rtol=1e-12)
            assert port._rbp_w[var] == pytest.approx(ref._rbp_w[var], rel=1e-12)
        np.testing.assert_allclose(port.merged_marginals(), ref.merged_marginals(), rtol=1e-12)
    var = max(port._rbp_w)
    assert port._rbp_w[var] == pytest.approx(96 * (1 - RB_DECAY**4) / (1 - RB_DECAY), rel=1e-12)


def test_constants_match_reference():
    assert port_adaptive.ADAPT_BURN_SWEEPS == ref_adaptive.ADAPT_BURN_SWEEPS == 2
    for name in ("AUX_CHAINS", "AUX_MAX_VARIANTS", "AUX_TICK_SWEEPS", "AUX_TICK_BUDGET_SECS"):
        assert getattr(port_split, name) == getattr(ref_split, name), name
    assert port_engine.ADAPT_TICK_WORK_SECS == ref_engine.ADAPT_TICK_WORK_SECS == 10.0
    assert ChainGroup.adapt_init == RefChainGroup.adapt_init == "redraw"
    assert SplitChainGroup.adapt_init == ref_split.SplitChainGroup.adapt_init == "transplant"


# ---- semantic mirrors of the reference's tests ------------------------------

def test_transplant_init_and_plain_slot_states():
    """``init_states`` seeds a new slot with a subsample of donor rows
    (reference ``tests/test_chains.py:286-315``)."""
    m = torch_models.chain_model(port_pgm, seed=1)
    g = ChainGroup(m, chains_per_variant=16, converge_window=8, device="cpu", seed=9)
    g.add_variant(m)
    g.burn(10)
    donor = g.plain_slot_states()
    assert donor.shape == (16, m.num_vars + 1)
    variant, _ = port_collapse.collapse_var(m, 0)
    g.add_variant(variant, init_states=donor)
    donor_set = {tuple(r) for r in donor.tolist()}
    assert all(tuple(r) in donor_set for r in g.state[1].tolist())
    g2 = ChainGroup(m, chains_per_variant=16, converge_window=8, device="cpu", seed=9)
    g2.add_variant(variant)
    assert g2.plain_slot_states() is None  # a collapsed slot is no donor
    g3 = ChainGroup(m, chains_per_variant=8, converge_window=8, device="cpu", seed=9)
    g3.add_variant(variant, init_states=donor)
    assert g3.state.shape == (1, 8, m.num_vars + 1)
    assert all(tuple(r) in donor_set for r in g3.state[0].tolist())


def test_adapt_step_warm_starts():
    """A transplant policy seeds the new slot from a plain slot's rows; a
    redraw policy from the merged estimate; the new slots then burn 2
    sweeps over the whole group (reference ``tests/test_chains.py:345-375``)."""
    m = torch_models.chain_model(port_pgm, seed=2)
    g = ChainGroup(m, chains_per_variant=32, converge_window=8, device="cpu", seed=13)
    g.add_variants([m, m])
    g.burn(20)
    g.advance(8)
    donor = {tuple(r) for r in g.plain_slot_states().tolist()}
    g.adapt_init = "transplant"
    calls = []
    add = g.add_variants
    g.add_variants = lambda vs, **kw: calls.append(kw) or add(vs, **kw)
    sweeps = g.total_sweeps
    added = port_adaptive.adapt_step(g, 1)
    assert len(added) == 1 and g.num_variants == 3
    assert {tuple(r) for r in calls[0]["init_states"].tolist()} == donor
    assert calls[0]["warm_marginals"] is None and g.total_sweeps == sweeps + 2
    g.adapt_init = "redraw"
    port_adaptive.adapt_step(g, 1)
    assert calls[1]["init_states"] is None and calls[1]["warm_marginals"].shape == (4, 2)
    port_adaptive.adapt_step(g, 1, warm_start=False)
    assert calls[2]["init_states"] is None and calls[2]["warm_marginals"] is None
    g2 = ChainGroup(m, chains_per_variant=8, converge_window=8, device="cpu", seed=1)
    g2.add_variants([m, m])
    g2.advance()
    with pytest.raises(ValueError, match="adapt policy"):
        port_adaptive.adapt_step(g2, 1, policy="best")


def test_collapse_headroom_caps_stay_dense():
    """Headroom caps classify replacement factors dense, and a blanket-10
    variant encodes with no gather-bank rows and passes the kernel's gate
    (reference ``tests/test_collapse.py:172-195``)."""
    from grample_tpu_torch.ops.sweep import kernel_refusal

    m = torch_models.build(port_pgm, "star10")
    caps = port_encode.compute_caps(m, collapse_headroom=True, slot_hint=8)
    assert caps.oa_dense_cap == port_encode.COLLAPSE_OA_DENSE_CAP
    assert caps.gfac_cap == 0 and caps.oa_cap == 256
    variant, _ = port_collapse.collapse_var(m, 0)
    caps = port_encode.merge_caps(caps, port_encode.compute_caps(
        variant, oa_dense_cap=caps.oa_dense_cap))
    enc = port_encode.encode_model(variant, caps)
    assert enc.gb_mask.sum() == 0
    assert kernel_refusal(caps) is None


def test_adapt_guard_skips_gather_candidates():
    """adapt_step never builds a variant outside the group's dense bound:
    the star's centre (512-row tables) is skipped, leaves are taken
    (reference ``tests/test_collapse.py:197-214``)."""
    m = torch_models.star(port_pgm, 10, seed=1, lo=0.2)
    g = ChainGroup(m, chains_per_variant=8, converge_window=8, device="cpu", seed=1,
                   collapse_headroom=True)
    g.add_variants([m, m])
    g.advance(8)
    added = port_adaptive.adapt_step(g, 4)
    assert added and 0 not in added
    assert all(port_collapse.is_collapsible(m, v, oa_cap=g.collapse_oa_cap) for v in added)


def test_split_capacity_reporting():
    """max_variants is main's live slots plus the aux capacity (reference
    ``tests/test_collapse.py:217-231``); the aux limit is enforced."""
    m = torch_models.star(port_pgm, 3, seed=1, lo=0.2)
    g = SplitChainGroup(m, chains_per_variant=8, converge_window=8, device="cpu", seed=1,
                        aux_chains=8, max_variants=128)
    g.add_variants([m, m])
    assert g.max_variants == 2 + AUX_MAX_VARIANTS
    variant, _ = port_collapse.collapse_var(m, 0)
    g.add_variant(variant)
    assert g.max_variants == 2 + AUX_MAX_VARIANTS
    assert g.aux.max_variants == AUX_MAX_VARIANTS
    with pytest.raises(RuntimeError, match="aux variant limit"):
        g.add_variants([variant] * AUX_MAX_VARIANTS)


def test_split_routing_merge_and_psrf():
    """Plain variants go to main, collapse variants to aux; the merge's
    collapsed rows come from aux (any-collapsed-wins); PSRF pins them at
    1.0 (reference ``tests/test_split.py:30-55``)."""
    m = torch_models.build(port_pgm, "flip3")
    g = SplitChainGroup(m, chains_per_variant=64, converge_window=16, device="cpu",
                        seed=3, aux_chains=32)
    g.add_variants([m, m])
    assert g.aux is None and g.main.num_variants == 2
    assert g.collapse_oa_cap == port_encode.COLLAPSE_OA_DENSE_CAP
    variant, _ = port_collapse.collapse_var(m, 0)
    slot = g.add_variant(variant, burn_sweeps=2)
    assert slot == 2 and g.aux.num_variants == 1 and g.num_variants == 3
    assert g.num_chains == 2 * 64 + 32 and g.aux_cpv == 32
    assert g.collapsed_any().tolist() == [True] + [False] * 8
    assert g.collapse_oa_cap == g.aux.caps.oa_dense_cap
    g.burn(4)
    g.advance(16)
    assert g.aux_ticks == 1 and g.aux_tick_sweeps == 16 and g.aux_secs > 0
    merged = g.merged_marginals()
    np.testing.assert_allclose(merged[0], g.aux.merged_marginals()[0])
    np.testing.assert_allclose(merged[1:], g.main.merged_marginals()[1:]
                               + g.aux.merged_marginals()[1:])
    assert g.convergence()[0] == 1.0
    assert g.total_samples == g.main.total_samples + g.aux.total_samples > 0
    with pytest.raises(RuntimeError, match="variant limit"):
        SplitChainGroup(m, 8, 8, device="cpu", max_variants=1).add_variants([m, m])


def test_split_rb_main_donors():
    """The aux group takes donor snapshots from the main group's
    full-width states, one per tick (reference
    ``tests/test_chains.py:204-231``)."""
    m = torch_models.chain_model(port_pgm, seed=4)
    truth = exact_marginals(m)
    g = SplitChainGroup(m, chains_per_variant=128, converge_window=16, device="cpu",
                        seed=7, aux_chains=16)
    g.add_variants([m, m])
    variant, _ = port_collapse.collapse_var(m, 2)
    g.add_variant(variant)
    g.burn(30)
    for _ in range(6):
        g.advance(16)
        g.rb_accumulate()
    assert g.aux._rbp_snaps.get(2) == 6
    np.testing.assert_allclose(g.aux._rbp_w[2], 2 * 128 * (1 - RB_DECAY**6) / (1 - RB_DECAY),
                               rtol=1e-12)
    est = g.merged_marginals()[2, :2]
    # 6 snapshots of the exact conditional over >= 256 chains: 5 sigma of
    # a binary mean over 1536 draws is 0.064
    assert np.abs(est / est.sum() - truth[2, :2]).max() < 0.064


def test_caps_growth_in_adaptive_group_keeps_totals():
    """A variant outgrowing the group's caps restacks it: pending deltas
    are flushed first and every slot's totals kept."""
    m = torch_models.build(port_pgm, "star8")
    g = ChainGroup(m, chains_per_variant=16, converge_window=8, device="cpu", seed=3)
    g.add_variants([m, m])
    g.advance(defer=True)
    g.advance(defer=True)
    assert len(g._pending) == 2
    want = g.totals[:2] + sum(d.numpy() for window, _ in g._pending for _, d in window)[:2]
    caps = g.caps
    variant, _ = port_collapse.collapse_var(m, 0)  # 64-row tables: caps grow
    g.add_variant(variant)
    assert g.caps != caps and g.caps.oa_cap == 64 and not g._pending
    np.testing.assert_array_equal(g.totals[:2], want)
    assert g.totals[2].sum() == 0
    g.advance()
    assert np.isfinite(g.merged_marginals()).all()


# ---- engine runs --------------------------------------------------------------

def _net(tmp_path, name, evidence=None):
    m = torch_models.MODELS[name][0](port_pgm)
    path = str(tmp_path / f"{name}.uai")
    with open(path, "w") as fh:
        fh.write(write_model(m))
    if evidence:
        with open(path + ".evid", "w") as fh:
            fh.write(f"{len(evidence)} " + " ".join(f"{k} {v}" for k, v in evidence.items()))
        m.apply_evidence(evidence)
    truth = exact_marginals(m)
    with open(path + ".MAR", "w") as fh:
        fh.write(write_mar([truth[i, : m.cards[i]] for i in range(m.num_vars)]))
    return path, truth


@pytest.mark.parametrize("split", ["off", "on"])
def test_adaptive_engine_flip_symmetric(tmp_path, split):
    """Adaptation collapses vars, whose static marginals are exactly 0.5
    on a flip-symmetric net; the trace carries the experiment CSV
    (reference ``tests/test_engine.py:62-89``)."""
    path, _ = _net(tmp_path, "flip3")
    trace = str(tmp_path / "t.jsonl")
    lines = []
    cfg = EngineConfig(model_path=path, device="cpu", use_solution=True, sampler="adaptive",
                       burnin=9 * 10, converge_window=9 * 20, chains=2, chains_per_variant=32,
                       chain_adds=2, max_iters=9 * 64 * 20 * 6, seed=42, status_secs=0.2,
                       trace_path=trace, experiment=True, rb_mixture=False,
                       split_group=split)
    res = Engine(cfg, log=lines.append).run()
    assert res.variants > 2 and res.collapsed
    assert any(ln.startswith("ADAPT: ") for ln in lines)
    assert any("split group" in ln for ln in lines) == (split == "on")
    for v in res.collapsed:
        np.testing.assert_allclose(res.marginals[v], [0.5, 0.5], atol=1e-9)
    assert (res.aux_secs > 0) == (split == "on")
    text = open(trace).read()
    for section in ("RunSecs, MaxHell", "// VARS (ESTIMATED)", "// OPERATING PARAMS"):
        assert section in text
    csv = [ln for ln in text.splitlines() if ln[:1].isdigit()]
    assert csv and int(csv[-1].split(", ")[-1]) == len(res.collapsed)
    summary = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"samples"')][0]
    assert summary["aux_secs"] == res.aux_secs and summary["collapsed"] == res.collapsed


def test_adaptive_engine_vs_exact(tmp_path):
    """``-s adaptive`` on a 3x3 grid, one window per tick: adaptation
    collapses every var within 5 ticks, and every marginal (each then an
    RB mixture) is within 5 sigma of exact."""
    path, truth = _net(tmp_path, "grid3")
    cfg = EngineConfig(model_path=path, device="cpu", use_solution=True, sampler="adaptive",
                       burnin=9 * 30, converge_window=9 * 25, chains=2, chains_per_variant=128,
                       chain_adds=2, max_iters=9 * 128 * 25 * 120, max_secs=600.0, seed=5,
                       status_secs=1e-6)
    lines = []
    res = Engine(cfg, log=lines.append).run()
    adapts = [ln for ln in lines if ln.startswith("ADAPT: ")]
    assert len(adapts) == 5 and res.collapsed == list(range(9)) and res.variants == 11
    ticks = sum(ln.startswith("  Samps:") for ln in lines)
    assert ticks >= 12
    # every var's estimate averages its exact conditional over >= 7 decayed
    # snapshots since its collapse (weight >= (1 - 0.85**7) / 0.15 = 4.5)
    # of >= 384 chains (its own 128 and 256 plain donors) a window apart:
    # n_eff >= 1700, 5 sigma(H) = 5 / sqrt(8 n_eff) = 0.043
    h = hellinger(res.marginals, truth, np.full(9, 2))
    assert h.max() < 5.0 / np.sqrt(8 * 1700), (h, adapts)
    assert (res.convergence["hellinger"] == 1.0).all()


def test_want_split_gate():
    """The port's gate: split where the kernel takes the plain caps but
    refuses the collapse-headroom caps (the Promedus-shaped net), a
    single group where it takes both (the 10x10 grid); on/off override."""
    grid = torch_models.grid(port_pgm, 10, seed=1)
    prom, evidence = torch_models.promedus_like(port_pgm, seed=1)
    prom.apply_evidence(evidence)
    cfg = EngineConfig(model_path="", sampler="adaptive")
    assert not Engine._want_split(cfg, grid)
    assert Engine._want_split(cfg, prom)
    assert Engine._want_split(dataclasses.replace(cfg, split_group="on"), grid)
    assert not Engine._want_split(dataclasses.replace(cfg, split_group="off"), prom)


def test_config_checks():
    with pytest.raises(ValueError, match="not adaptive"):
        Engine(EngineConfig(model_path="", chain_adds=2))
    with pytest.raises(ValueError, match="split_group"):
        Engine(EngineConfig(model_path="", sampler="adaptive", split_group="maybe"))
    with pytest.raises(ValueError, match="unknown sampler"):
        Engine(EngineConfig(model_path="", sampler="gibbs"))


def test_cli_adaptive_flags(tmp_path, capsys):
    """The reference's adaptive flags reach the engine: ``-a``,
    ``--measure``, ``--adapt-policy``, ``--no-warm-start``, ``--reserve``."""
    path, _ = _net(tmp_path, "grid4_evid", {5: 1, 10: 0})
    trace = str(tmp_path / "t.jsonl")
    rc = cli.main(["sample", "-m", path, "-d", "-o", "-s", "adaptive", "--device", "cpu",
                   "--vchains", "16", "-b", "160", "-w", "160", "-x", "2", "-e", "4",
                   "-a", "3", "--measure", "js", "--adapt-policy", "ref-tail",
                   "--no-warm-start", "--reserve", "8", "--split-group", "off", "-t", trace])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ADAPT: 5 chains (+3: collapsed vars" in out and "FINAL" in out
    params = json.loads(open(trace).read().split("// OPERATING PARAMS\n")[1].splitlines()[0])
    assert (params["chain_adds"], params["measure"], params["adapt_policy"],
            params["warm_start"], params["reserve_slots"]) == (3, "js", "ref-tail", False, 8)
