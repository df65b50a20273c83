"""The split group's wide aux tier against the reference's: the pooled
caps of ``wide_aux_spec`` and their on-disk cache, the split group built
on them, adapt steps on carried-over states, an adaptive engine run held
against exact marginals, and wide snapshots that cross the two packages.

The port runs the wide tier on a CUDA device; here its device test
(``split.wide_tier_device``) is patched.  The reference runs it on its
accelerator: its spec is computed with ``jax.default_backend`` patched to
``"tpu"`` for that one call, and its wide group is then built with the
backend real and ``wide_aux_spec`` patched to return that spec, through
``_build_aux`` (its ``_ensure_aux`` demotes a wide group that is not on
its kernel), so it sweeps by its XLA path on the CPU.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.sampler.adaptive as ref_adaptive
import grample_tpu.sampler.checkpoint as ref_checkpoint
import grample_tpu.sampler.collapse as ref_collapse
import grample_tpu.sampler.split as ref_split
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.sampler.adaptive as port_adaptive
import grample_tpu_torch.sampler.collapse as port_collapse
import grample_tpu_torch.sampler.split as port_split
from grample_tpu_torch.convert import carry_group_state
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.pgm.encode import COLLAPSE_OA_DENSE_CAP
from grample_tpu_torch.sampler.checkpoint import load_checkpoint, save_checkpoint
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.sampler.split import PAL_AUX_OA_LIM, SplitChainGroup

from tests import torch_models
from tests.test_torch_adaptive import _capture, _caps_fields, _net, _random_window
from tests.test_torch_checkpoint import _assert_same_snapshot


def _model(pgm, name):
    """A small net of this file, evidence applied, built with ``pgm``'s
    package: the 4x4 grid, the 60-var Promedus-shaped net, the 8-var star."""
    if name == "promedus60":
        m, evidence = torch_models.promedus_like(pgm, seed=1, v=60)
        m.apply_evidence(evidence)
        return m
    return torch_models.build(pgm, {"grid4": "grid4_evid", "star8": "star8"}[name])


NETS = ("grid4", "promedus60", "star8")


@pytest.fixture
def home(tmp_path, monkeypatch):
    """``HOME`` (where both packages keep their spec caches) in the test's
    tmp dir."""
    monkeypatch.setenv("HOME", str(tmp_path))
    return tmp_path


@pytest.fixture
def wide(home, monkeypatch):
    """The port's wide tier on the CPU: its device test says yes."""
    monkeypatch.setattr(port_split, "wide_tier_device", lambda device: True)


def _ref_spec(m, monkeypatch):
    """The reference's ``wide_aux_spec`` as on its accelerator: the
    backend reads ``"tpu"`` for this call only."""
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        return ref_split.wide_aux_spec(m)


def _cands(pgm_collapse, m):
    blankets = m.blankets()
    return [v for v in range(m.num_vars)
            if pgm_collapse.is_collapsible(m, v, blankets[v], oa_cap=PAL_AUX_OA_LIM)]


def _cache_files(home, package):
    d = home / ".cache" / package / "auxspec"
    return sorted(os.listdir(d)) if d.exists() else []


# ---- the pooled caps ---------------------------------------------------------

def test_constants_match_reference():
    assert port_split.PAL_AUX_OA_LIM == ref_split.PAL_AUX_OA_LIM == 8
    from grample_tpu.ops.gibbs_pallas import PAL_OA_MAX

    assert port_split.SPEC_OA_MAX == PAL_OA_MAX


@pytest.mark.parametrize("net", NETS)
def test_pooled_caps_match_reference(net, home, monkeypatch):
    """The port's spec on a CUDA device equals the reference's on its
    accelerator, field for field but the base mode, over the same
    candidate pool; each package caches it in its own directory."""
    rm, pm = _model(ref_pgm, net), _model(port_pgm, net)
    assert _cands(port_collapse, pm) == _cands(ref_collapse, rm) != []
    want = _ref_spec(rm, monkeypatch)
    got = port_split.wide_aux_spec(pm, "cuda:0")
    assert want is not None and got is not None
    assert _caps_fields(got) | {"base_mode": None} == _caps_fields(want) | {"base_mode": None}
    assert (got.oa_cap <= PAL_AUX_OA_LIM and got.gfac_cap == 0 and got.slot_hint == 8
            and port_split.spec_accepted(got))
    assert len(_cache_files(home, "grample_tpu_torch")) == 1
    assert len(_cache_files(home, "grample_tpu")) == 1  # the reference's own


def test_promedus_pool_is_narrower_than_the_dense_bound():
    """The wide tier admits fewer candidates than the narrow one: the OA-8
    pool is a subset of the OA-256 pool, strictly smaller on the
    Promedus-shaped net."""
    m = _model(port_pgm, "promedus60")
    blankets = m.blankets()
    narrow = [v for v in range(m.num_vars)
              if port_collapse.is_collapsible(m, v, blankets[v], oa_cap=COLLAPSE_OA_DENSE_CAP)]
    pool = _cands(port_collapse, m)
    assert set(pool) < set(narrow)


# ---- refusals ----------------------------------------------------------------

def test_spec_none_on_cpu(home):
    """No spec for a CPU device (the reference: a backend other than its
    accelerator), and nothing computed or cached."""
    m = _model(port_pgm, "grid4")
    assert port_split.wide_aux_spec(m, "cpu") is None
    assert port_split.wide_aux_spec(m, torch.device("cpu")) is None
    assert _cache_files(home, "grample_tpu_torch") == []


def test_spec_refuses_gather_bank(home, monkeypatch):
    """Pooled caps with a gather bank are refused, and the refusal (a
    function of the model) is cached."""
    m = _model(port_pgm, "grid4")
    spec = port_split.wide_aux_spec(m, "cuda")
    gather = torch_models.all_gather(spec)
    assert not port_split.spec_accepted(gather)
    assert not port_split.spec_accepted(dataclasses.replace(spec, oa_cap=512))
    os.remove(port_split.spec_cache_file(m))
    monkeypatch.setattr(port_split, "caps_for_variants", lambda variants, slot_hint: gather)
    assert port_split.wide_aux_spec(m, "cuda") is None
    with open(port_split.spec_cache_file(m)) as fh:
        assert json.load(fh) == {"caps": None}


def test_spec_none_without_candidates(home):
    """A net with no candidate within 8 outcomes (one 12-var factor: each
    var's replacement factor has 2048 rows an incidence) has no spec."""
    m = torch_models.wide_factor(port_pgm, 12, seed=2)
    assert _cands(port_collapse, m) == []
    assert port_split.wide_aux_spec(m, "cuda") is None
    assert port_split.pooled_spec(m) == (None, True)  # the cached refusal


# ---- the cache ---------------------------------------------------------------

def test_spec_cache_read_back(home, monkeypatch):
    """A second call reads the file and collapses nothing."""
    m = _model(port_pgm, "promedus60")
    first, cached = port_split.pooled_spec(m)
    assert first is not None and not cached
    assert port_split.spec_cache_file(m).startswith(
        str(home / ".cache" / "grample_tpu_torch" / "auxspec") + os.sep)

    def no_collapse(*_a, **_kw):
        raise AssertionError("a cached spec collapsed a var")

    monkeypatch.setattr(port_split, "collapse_var", no_collapse)
    assert port_split.pooled_spec(m) == (first, True)
    assert port_split.wide_aux_spec(m, "cuda") == first
    assert not (home / ".cache" / "grample_tpu").exists()


def test_spec_cache_key():
    """The key follows the evidence and the factorization, not the tables."""
    a = _model(port_pgm, "grid4")
    b = torch_models.grid(port_pgm, 4, seed=3)
    b.apply_evidence({5: 1})
    c = torch_models.grid(port_pgm, 4, seed=99)
    c.apply_evidence({5: 1, 10: 0})
    assert port_split.spec_cache_file(a) != port_split.spec_cache_file(b)
    assert port_split.spec_cache_file(a) == port_split.spec_cache_file(c)
    two = port_pgm.DiscreteModel(type="MARKOV", cards=[2] * 4, factors=[
        port_pgm.Factor("a", [0, 1], np.ones(4)), port_pgm.Factor("b", [2, 3], np.ones(4))])
    one = port_pgm.DiscreteModel(type="MARKOV", cards=[2] * 4, factors=[
        port_pgm.Factor("a", [0, 1, 2, 3], np.ones(16))])
    assert port_split.spec_cache_file(two) != port_split.spec_cache_file(one)


def test_spec_error_writes_no_file(home, monkeypatch):
    """An error while the spec is computed warns, gives no spec, and
    writes no file, so the next call computes it."""
    m = _model(port_pgm, "grid4")
    real = port_split.collapse_var

    def failing(*_a, **_kw):
        raise MemoryError("host memory")

    monkeypatch.setattr(port_split, "collapse_var", failing)
    with pytest.warns(RuntimeWarning, match="narrow aux tier"):
        assert port_split.pooled_spec(m) == (None, False)
    assert not os.path.exists(port_split.spec_cache_file(m))
    monkeypatch.setattr(port_split, "collapse_var", real)
    spec, cached = port_split.pooled_spec(m)
    assert spec is not None and not cached


# ---- the split group on the wide tier ----------------------------------------

@pytest.mark.parametrize("net", ["grid4", "promedus60"])
def test_split_group_on_wide_tier(net, wide):
    """Full-width aux slots on the spec's caps, the OA-8 candidate bound,
    and no caps growth as every candidate (up to 8) is added."""
    m = _model(port_pgm, net)
    spec = port_split.wide_aux_spec(m, "cuda")
    g = SplitChainGroup(m, chains_per_variant=64, converge_window=8, device="cpu", seed=3)
    g.add_variants([m, m])
    assert g.collapse_oa_cap == COLLAPSE_OA_DENSE_CAP and g.aux_tier is None
    g.prewarm_aux()
    assert g.aux_tier == "wide" and g.aux_cpv == g.aux.cpv == 64
    assert g.collapse_oa_cap == PAL_AUX_OA_LIM and g.aux.caps == spec
    assert g.aux_spec_cached and g.aux.slot_cap == 8
    assert g.aux.max_variants == port_split.AUX_MAX_VARIANTS
    picks = _cands(port_collapse, m)[:8]
    g.add_variants([port_collapse.collapse_var(m, v)[0] for v in picks], burn_sweeps=2)
    assert g.aux.caps == spec and g.aux.slot_cap == 8 and g.aux.num_variants == len(picks)
    g.advance()
    assert g.aux_ticks == 1 and g.aux.total_samples > 0


def test_split_group_narrow_without_spec(wide):
    """Where the pool is empty (a 2x2 grid at card 9: every candidate's
    incidences have 9 rows) the narrow tier runs, device or not."""
    m = torch_models.grid(port_pgm, 2, seed=4, card=9)
    assert port_split.wide_aux_spec(m, "cuda") is None
    g = SplitChainGroup(m, chains_per_variant=512, converge_window=8, device="cpu", seed=3)
    g.add_variants([m, m])
    g.prewarm_aux()
    assert g.aux_tier == "narrow" and g.aux_cpv == g.aux.cpv == port_split.AUX_CHAINS
    assert g.collapse_oa_cap == COLLAPSE_OA_DENSE_CAP == g.aux.caps.oa_dense_cap
    assert g.aux_spec_secs is not None and g.aux_spec_cached


def test_split_group_narrow_on_cpu(home):
    """Unpatched, a CPU group builds the narrow tier and looks for no spec."""
    m = _model(port_pgm, "grid4")
    g = SplitChainGroup(m, chains_per_variant=512, converge_window=8, device="cpu", seed=3)
    g.add_variants([m, m])
    g.prewarm_aux()
    assert g.aux_tier == "narrow" and g.aux_cpv == port_split.AUX_CHAINS
    assert g.aux_spec_secs is None and _cache_files(home, "grample_tpu_torch") == []


# ---- adapt steps on carried-over states ---------------------------------------

def _wide_pair(net, monkeypatch, cpv=32, aux_vars=(0,)):
    """Both packages' split groups over one net, each with 2 plain main
    slots and the wide aux tier holding the collapse variants of
    ``aux_vars``; the reference's random states carried onto the port's."""
    rm, pm = _model(ref_pgm, net), _model(port_pgm, net)
    spec = _ref_spec(rm, monkeypatch)
    monkeypatch.setattr(ref_split, "wide_aux_spec", lambda model: spec)
    ref = ref_split.SplitChainGroup(rm, chains_per_variant=cpv, converge_window=8, seed=5)
    port = SplitChainGroup(pm, chains_per_variant=cpv, converge_window=8, device="cpu", seed=5)
    for g, col in ((ref, ref_collapse), (port, port_collapse)):
        m = g.base
        g.add_variants([m, m])
        g.aux = g._build_aux()
        g.aux.add_variants([col.collapse_var(m, v)[0] for v in aux_vars])
    assert ref.aux.cpv == port.aux.cpv == ref.aux_cpv == port.aux_cpv == cpv
    assert ref.collapse_oa_cap == port.collapse_oa_cap == PAL_AUX_OA_LIM
    rng = np.random.default_rng(11)
    for r, p in ((ref.main, port.main), (ref.aux, port.aux)):
        _random_window(r, rng)
        carry_group_state(r, p)
    return ref, port


@pytest.mark.parametrize("policy", ["worst", "ref-tail"])
@pytest.mark.parametrize("net", ["grid4", "promedus60"])
def test_adapt_step_on_wide_tier_matches_reference(net, policy, wide, monkeypatch):
    """On carried-over states the two wide split groups pick the same vars
    (the OA-8 pool), pass the same variants and the same transplanted
    donor states, and merge to the same marginals."""
    ref, port = _wide_pair(net, monkeypatch)
    np.testing.assert_allclose(port.merged_marginals(), ref.merged_marginals(), rtol=1e-12)
    calls = {}
    for mod, g in ((ref_adaptive, ref), (port_adaptive, port)):
        calls[mod] = _capture(g)
        targets = mod.adapt_step(g, 3, policy=policy)
        assert len(targets) == 3
        calls[mod].append(targets)
    (rv, rb, rw, ri), rt = calls[ref_adaptive]
    (pv, pb, pw, pi), pt = calls[port_adaptive]
    assert pt == rt and pb == rb and pw is None and rw is None
    assert set(pt) <= set(_cands(port_collapse, port.base))
    assert [np.nonzero(v.collapsed)[0].tolist() for v in pv] == [[t] for t in pt]
    for a, b in zip(pv, rv):
        np.testing.assert_allclose(a.marginals, b.marginals, rtol=1e-12)
    np.testing.assert_array_equal(pi, np.asarray(ri))


def test_carry_wide_aux_state(wide, monkeypatch):
    """``carry_group_state`` carries a reference aux group of full-width
    slots onto the port's wide aux: state, halves, totals and RB sums."""
    ref, port = _wide_pair("grid4", monkeypatch, aux_vars=(0, 6, 9))
    ref.aux.rb_accumulate()
    ref.aux.rb_accumulate_external(ref.main.state, ref.main.cpv, n_slots=2)
    carry_group_state(ref.aux, port.aux)
    assert port.aux.caps == port_split.wide_aux_spec(port.base, "cuda")
    _assert_same_snapshot(port.aux, ref.aux)
    np.testing.assert_allclose(port.merged_marginals(), ref.merged_marginals(), rtol=1e-12)


# ---- the estimator -----------------------------------------------------------

def test_adaptive_engine_wide_tier_vs_exact(tmp_path, wide):
    """``-s adaptive`` with the split group on the wide tier, on the 4x4
    grid with evidence, one window per tick: the log names the tier, every
    free var is collapsed, and every marginal is within 5 sigma of exact."""
    path, truth = _net(tmp_path, "grid4_evid", {5: 1, 10: 0})
    cfg = EngineConfig(model_path=path, device="cpu", use_evidence=True, use_solution=True,
                       sampler="adaptive", burnin=16 * 30, converge_window=16 * 25, chains=2,
                       chains_per_variant=128, chain_adds=2, max_iters=16 * 128 * 25 * 200,
                       max_secs=600.0, seed=5, status_secs=1e-6, split_group="on")
    lines = []
    res = Engine(cfg, log=lines.append).run()
    tier = [ln for ln in lines if ln.startswith("aux group: ")]
    assert tier[0].startswith("aux group: wide tier, 128 chains per variant, candidate bound 8; "
                              "wide spec found, ")
    assert tier[0].endswith("s of host time, computed")
    assert tier[-1].startswith("aux group: wide tier, 128 chains per variant, candidate bound 8: ")
    adapts = [ln for ln in lines if ln.startswith("ADAPT: ")]
    free = [v for v in range(16) if v not in (5, 10)]
    assert res.collapsed == free and len(adapts) == 7
    ticks = sum(ln.startswith("  Samps:") for ln in lines)
    assert ticks >= len(adapts) + 8
    # as tests/test_torch_adaptive.py::test_adaptive_engine_vs_exact: every
    # var's estimate averages its exact conditional over >= 7 decayed
    # snapshots since its collapse of >= 384 chains (its own 128 and 256
    # plain donors) a window apart: n_eff >= 1700
    m = _model(port_pgm, "grid4")
    h = hellinger(res.marginals, truth, m.cards, m.fixed)
    assert h.max() < 5.0 / np.sqrt(8 * 1700), (h, adapts)


# ---- wide snapshots across the packages --------------------------------------

#: chains per variant of the wide snapshots: a snapshot is recognised as
#: wide by aux chains per variant above ``AUX_CHAINS`` (reference
#: ``split.py:247``)
SNAP_CPV = 512


def _wide_group(m, seed=9):
    """A port split group on the wide tier that has burnt in, counted a
    window and taken two RB snapshots, with two collapse variants."""
    g = SplitChainGroup(m, chains_per_variant=SNAP_CPV, converge_window=12, device="cpu",
                        seed=seed)
    g.add_variants([m, m])
    g.add_variants([port_collapse.collapse_var(m, v)[0] for v in (0, 6)], burn_sweeps=2)
    g.burn(10)
    for _ in range(2):
        g.advance()
        g.rb_accumulate()
    return g


def test_wide_snapshot_resumes_bit_exact(tmp_path, wide):
    """A wide split snapshot resumes on the spec's caps with its aux
    width and candidate bound, and runs on bit for bit."""
    m = _model(port_pgm, "grid4")
    a = _wide_group(m)
    a.advance()
    a.rb_accumulate()
    b = _wide_group(m)
    assert b.aux_tier == "wide" and b.aux_cpv == SNAP_CPV
    path = str(tmp_path / "wide.npz")
    save_checkpoint(path, b)
    del b
    b2, meta = load_checkpoint(path, m)
    assert meta["split"]["aux_cpv"] == SNAP_CPV
    assert b2.aux.caps == port_split.wide_aux_spec(m, "cuda") and b2.aux.cpv == SNAP_CPV
    assert b2.aux_tier == "wide" and b2.collapse_oa_cap == PAL_AUX_OA_LIM
    b2.advance()
    b2.rb_accumulate()
    for x, y in ((a.main, b2.main), (a.aux, b2.aux)):
        assert torch.equal(x.state, y.state) and torch.equal(x.halves, y.halves)
        np.testing.assert_array_equal(x.totals, y.totals)
        assert (x._step, x.total_samples, x._rbp_snaps) == (y._step, y.total_samples,
                                                             y._rbp_snaps)
    np.testing.assert_array_equal(a.merged_marginals(), b2.merged_marginals())


def test_port_wide_snapshot_loads_in_reference(tmp_path, wide, monkeypatch):
    """A wide snapshot the port wrote loads in the reference's
    ``load_checkpoint`` (its ``wide_aux_spec`` returning its spec) with
    equal aux caps, aux width and candidate bound."""
    m = _model(port_pgm, "grid4")
    port = _wide_group(m)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, port)
    rm = _model(ref_pgm, "grid4")
    spec = _ref_spec(rm, monkeypatch)
    monkeypatch.setattr(ref_split, "wide_aux_spec", lambda model: spec)
    ref, _ = ref_checkpoint.load_checkpoint(path, rm)
    assert isinstance(ref, ref_split.SplitChainGroup)
    assert ref.aux.caps == spec and _caps_fields(port.aux.caps) == _caps_fields(spec) | {
        "base_mode": "rowgather"}
    assert ref.aux_cpv == port.aux_cpv == ref.aux.cpv == SNAP_CPV
    assert ref.collapse_oa_cap == port.collapse_oa_cap == PAL_AUX_OA_LIM
    _assert_same_snapshot(port.main, ref.main)
    _assert_same_snapshot(port.aux, ref.aux)
    np.testing.assert_allclose(port.merged_marginals(), ref.merged_marginals(), rtol=1e-12)


def test_reference_wide_snapshot_loads_in_port(tmp_path, wide, monkeypatch):
    """A wide snapshot the reference wrote loads in the port on the
    port's spec, and continues."""
    ref, _ = _wide_pair("grid4", monkeypatch, cpv=SNAP_CPV, aux_vars=(0, 6))
    ref.aux.rb_accumulate()
    path = str(tmp_path / "ref.npz")
    ref_checkpoint.save_checkpoint(path, ref)
    m = _model(port_pgm, "grid4")
    port, meta = load_checkpoint(path, m)
    assert meta["split"]["aux_cpv"] == SNAP_CPV
    assert port.aux.caps == port_split.wide_aux_spec(m, "cuda")
    assert port.aux_cpv == port.aux.cpv == SNAP_CPV and port.aux_tier == "wide"
    _assert_same_snapshot(port.main, ref.main)
    _assert_same_snapshot(port.aux, ref.aux)
    np.testing.assert_allclose(port.merged_marginals(), ref.merged_marginals(), rtol=1e-12)
    before = port.total_samples
    port.advance()
    assert port.total_samples > before
