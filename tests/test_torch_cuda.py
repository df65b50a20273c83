"""The CUDA sweep kernel on the card, against its plain PyTorch version,
at the plain models' widths, at the wide local tables of collapse
variants (64 to 1024 rows, scopes up to 11), on collapse-headroom
encodings and, in its gather form, on encodings with a flat-table gather
bank (against ``window_ops``); the adaptive sampler and kill-and-resume on the card; groups
sharded over a virtual mesh of the card, and over two and four cards
where the machine has them (a case that needs more cards than the
machine has skips inside the test).

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports no JAX, so it runs on a GPU machine that has
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.ops import gibbs_cuda, layout, sweep
from grample_tpu_torch.ops.gibbs_bank import window_ops
from grample_tpu_torch.ops.gibbs_torch import window_plain
from grample_tpu_torch.parallel.mesh import ShardedChainGroup, chain_mesh
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.adaptive import adapt_step
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.sampler.checkpoint import load_checkpoint, save_checkpoint
from grample_tpu_torch.sampler.collapse import collapse_var, is_collapsible
from grample_tpu_torch.sampler.split import (
    AUX_CHAINS,
    PAL_AUX_OA_LIM,
    SplitChainGroup,
    aux_caps,
    wide_aux_spec,
)

from tests import torch_models

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    """``HOME`` in the test's tmp dir: a split group on the card caches
    its wide aux spec under it."""
    monkeypatch.setenv("HOME", str(tmp_path))


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _long_chain(v=2000):
    """A binary chain long enough that its lists and tables need more than
    48 KB of shared memory (the kernel then runs with the dynamic
    shared-memory attribute raised)."""
    return torch_models.chain_model(port_pgm, seed=21, v=v)


def _kernel_vs_plain(encs, device, c, count=True, half_point=1):
    """One window of 3 sweeps (half point 1 unless given; 0 and 3 leave a
    half without sweeps) through the plain version (``window_ops`` where
    the encoding has a gather bank) and through every form of the kernel
    (the form the wrapper's rule picks, thread per chain, site-parallel),
    from the same state: at most 0.1 % of sites differ after it, tail rows
    stay, and (counted) counts agree wherever the states agree, outcome
    0's (which the kernel derives after the sweeps) among them, each half's
    total is chains x sweeps x live rows, every live row of every chain
    counts its half's sweeps, and padding rows count nothing."""
    kst = sweep.sweep_tensors(port_encode.stack_variants(encs), device)
    args = [kst[k] for k in sweep.KERNEL_KEYS]
    n, caps = len(encs), encs[0].caps
    nvp, nslot = caps.num_rows, caps.num_slots
    rng = np.random.default_rng(2)
    cards = np.stack([e.cards for e in encs])[np.arange(n)[:, None], kst["pal_oon"].cpu().numpy()]
    init = np.floor(rng.random((n, nvp, c)) * cards[:, :, None])
    state = torch.as_tensor(init.astype(np.int32), device=device)
    if gibbs_cuda.uses_gather(kst):
        sp, cp = window_ops(kst, state.clone(), -77, 3, half_point, count, 512)
    else:
        sp, cp = window_plain(*args, state.clone(), -77, 3, half_point, count, 512)
    live = kst["k_kmask"].bool().any(dim=3).reshape(n, nslot)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for form in (None, False, True):  # the rule's pick, thread per chain, site-parallel
        plan = None if form is None else gibbs_cuda.plan_launch(kst, c, count, sms, form)
        before = gibbs_cuda.gibbs_window.launches
        sk, ck = gibbs_cuda.gibbs_window(kst, state.clone(), -77, 3, half_point, count, 512,
                                         plan)
        torch.cuda.synchronize()
        assert gibbs_cuda.gibbs_window.launches == before + 1
        assert (plan or gibbs_cuda.plan_launch(kst, c, count, sms)).gather \
            == gibbs_cuda.uses_gather(kst)
        assert (sk[:, :nslot] != sp[:, :nslot]).float().mean().item() <= 1e-3, form
        assert torch.equal(sk[:, nslot:], state[:, nslot:])
        if not count:
            assert ck is None and cp is None
            continue
        agree = (sk[:, :nslot] == sp[:, :nslot]).all(dim=0)
        assert torch.equal(ck[:, :, :, agree], cp[:, :, :, agree]), form
        assert torch.equal(ck[:, :, 0][:, :, agree], cp[:, :, 0][:, :, agree]), form
        for half, sweeps in ((0, half_point), (1, 3 - half_point)):
            want = c * sweeps * int(live.sum())
            assert ck[:, half].sum().item() == cp[:, half].sum().item() == want, form
            per_row = ck[:, half].sum(dim=1)  # [N, NSLOT, C]
            assert torch.equal(per_row, (sweeps * live.to(torch.int32))[:, :, None]
                               .expand_as(per_row)), form
        assert ck.sum(dim=(1, 2, 4))[~live].sum().item() == 0


def test_long_lists_stay_in_device_memory(cuda_device):
    """A 20000-var chain: its work lists outgrow shared memory, so the
    kernel reads them (and the tables) from device memory."""
    enc_m = _long_chain(20000)
    enc = port_encode.encode_model(enc_m, port_encode.compute_caps(enc_m, headroom_factors=0))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc]), "cpu")
    plan = gibbs_cuda.plan_launch(kst, 8192, True, 132)
    assert not plan.stage_lists and not plan.stage_tables
    _kernel_vs_plain([enc, enc], cuda_device, 8192)


@pytest.mark.parametrize("half_point", [0, 1, 3])
@pytest.mark.parametrize("name", ["grid4_evid", "grid3_card3_evid", "rand8_card4", "long_chain"])
def test_kernel_matches_plain_on_card(cuda_device, name, half_point):
    m = _long_chain() if name == "long_chain" else torch_models.build(port_pgm, name)
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    _kernel_vs_plain([enc, enc], cuda_device, 1024 if name == "long_chain" else 4096,
                     half_point=half_point)


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("card", [8, 16])
def test_full_card_launch_at_wide_cards(cuda_device, card, count):
    """2 x 131072 chains of a 3x3 grid at card 8 and 16 fill the card: the
    rule launches a thread per chain in 1024-thread blocks, which the
    instances that hold 8 and 16 logits a thread must fit in registers."""
    m = torch_models.grid(port_pgm, 3, seed=5, card=card)
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc, enc]), cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = gibbs_cuda.plan_launch(kst, 131072, count, sms)
    assert not plan.sites and plan.threads == 1024
    occ = gibbs_cuda.occupancy(card, plan)
    assert occ["max_threads"] >= plan.threads and occ["blocks_per_sm"] >= 1, occ
    assert occ["registers"] * plan.threads <= 65536, occ
    _kernel_vs_plain([enc, enc], cuda_device, 131072, count)


def _objdet_model(v, seed):
    """The benchmark's ObjectDetection-shaped net (``objdet60``: cards
    11-16, pairwise tables of up to 256 entries), or cut to ``v`` vars by
    the same rules, as a port model with its evidence applied."""
    from benchmark import nets, registry

    spec = registry.config("objdet60")["net"]
    net = (nets.build(spec, seed) if v == spec["v"] else nets.builder(spec["builder"])(
        seed, structure_seed=spec["structure_seed"], v=v, drop=3, evidence={6: 4}))
    m = port_pgm.DiscreteModel(type="MARKOV", cards=net["cards"], factors=[
        port_pgm.Factor(f"f{i}", list(scope), table)
        for i, (scope, table) in enumerate(net["factors"])])
    m.apply_evidence(net["evidence"])
    return m


@pytest.mark.parametrize("count,half_point", [(True, 0), (True, 1), (True, 3), (False, 1)])
def test_card16_kernel_matches_plain_on_objdet(cuda_device, count, half_point):
    """The card-16 instance of the kernel's plain (dense) form on a 12-var
    objdet-shaped net of cards 11-16, 2 variants x 4096 chains: the rule's
    pick, thread per chain and site-parallel, counted (at half points 0, 1
    and 3) and uncounted, against ``window_plain``."""
    m = _objdet_model(12, 23)
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc, enc]), "cpu")
    assert kst["k_kmask"].shape[3] == 16 and not gibbs_cuda.uses_gather(kst)
    _kernel_vs_plain([enc, enc], cuda_device, 4096, count, half_point)


@pytest.mark.parametrize("mesh", [False, True])
def test_launch_counters_on_card(cuda_device, mesh):
    """Counted windows of the 60-var objdet net on the card, by a
    ``ChainGroup`` and by a ``ShardedChainGroup`` on a 2x2 virtual mesh of
    the card: every launch reads the compact tables from device memory, so
    ``sites.tables_global`` equals the claimed updates, and
    ``sites.spilled`` equals them where ``occupancy`` reports local memory
    for the launch's plan and is 0 where it does not."""
    m = _objdet_model(60, 7)
    caps = port_encode.compute_caps(m, headroom_factors=0)
    if mesh:
        grid = chain_mesh(variant_ways=2, devices=[cuda_device] * 4)
        g = ShardedChainGroup(m, 8192, 20, seed=3, caps=caps, mesh=grid)
    else:
        g = ChainGroup(m, 8192, 20, cuda_device, seed=3, caps=caps)
    g.reserve(2)
    g.add_variants([m, m])
    taken = g.advance() + g.advance(defer=True)
    g.flush()
    counters = g.tracer.counters
    assert counters["sites.main"] == counters["sites.folded"] == taken > 0
    assert counters["sites.tables_global"] == taken
    rest = g.totals[:, :caps.num_vars, 0].sum()
    assert counters["sites.rest_derived"] == rest and 0 < rest < taken
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    launches = [(h, na, stack) for h, _, _, na, stack in g.launches() if stack.kernel]
    plans = {gibbs_cuda.plan_launch(stack.cut(h.device, na), g.local_chains, True, sms)
             for h, na, stack in launches}
    assert len(plans) == 1 and len(launches) == (4 if mesh else 1)
    spilled = gibbs_cuda.occupancy(16, plans.pop())["local_bytes"] > 0
    assert counters["sites.spilled"] == (taken if spilled else 0)


def _smoke_encs(net):
    """Two variants of the smoke run's 10x10 grid, or of its
    Promedus-shaped net, at their plain caps."""
    if net == "grid10":
        models, caps = torch_models.grid10_variants(port_pgm)
        m = models[0]
    else:
        m, evidence = torch_models.promedus_like(port_pgm, seed=1)
        m.apply_evidence(evidence)
        caps = port_encode.compute_caps(m, headroom_factors=0)
    return [port_encode.encode_model(m, caps)] * 2


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("sites", [False, True])
@pytest.mark.parametrize("net", ["grid10", "promedus"])
def test_merged_lists_equal_unmerged_on_card(cuda_device, monkeypatch, net, sites, count):
    """The kernel on the merged lists (``ops.layout``: most sites walk one
    table over their Markov blanket) against the kernel on the same
    encoding's unmerged lists, in both forms, counted and uncounted: the
    same launch plan, and states and counts equal bit for bit, since a
    merged row is the sum the unmerged walk makes."""
    stack = port_encode.stack_variants(_smoke_encs(net))
    kst = sweep.sweep_tensors(stack, cuda_device)
    with monkeypatch.context() as mp:
        mp.setattr(layout, "MERGE_MAX_ROWS", 0)
        raw = sweep.sweep_tensors(stack, cuda_device)
    merged = layout.walk_counts(kst["c_lists"].cpu().numpy())[:, 3]
    assert (merged > 0).all() and not layout.walk_counts(raw["c_lists"].cpu().numpy())[:, 3].any()
    c = 2048 if sites else 32768
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plans = [gibbs_cuda.plan_launch(k, c, count, sms, sites) for k in (kst, raw)]
    assert len({(p.sites, p.threads, p.stage_lists, p.stage_tables) for p in plans}) == 1
    n, nvp = kst["k_kmask"].shape[0], kst["pal_oon"].shape[1]
    cards = np.asarray(stack["cards"])[np.arange(n)[:, None], kst["pal_oon"].cpu().numpy()]
    init = np.floor(np.random.default_rng(4).random((n, nvp, c)) * cards[:, :, None])
    state = torch.as_tensor(init.astype(np.int32), device=cuda_device)
    sm, cm = gibbs_cuda.gibbs_window(kst, state.clone(), 1234567, 6, 3, count, 512, plans[0])
    sr, cr = gibbs_cuda.gibbs_window(raw, state.clone(), 1234567, 6, 3, count, 512, plans[1])
    torch.cuda.synchronize()
    assert torch.equal(sm, sr) and not torch.equal(sm, state)
    assert (cm is None and cr is None) if not count else torch.equal(cm, cr)


def test_merged_site_counter_reads_the_lists_share(cuda_device, tmp_path, monkeypatch):
    """An engine run of ``-s simple`` on the Promedus-shaped net on the
    card: ``sites.merged`` over ``RunResult.samples`` is the share of live
    sites on merged tables that the group's lists hold."""
    from grample_tpu_torch.sampler.engine import Engine, EngineConfig
    from grample_tpu_torch.uai.writer import write_model

    m, _ = torch_models.promedus_like(port_pgm, seed=1)
    path = str(tmp_path / "promedus.uai")
    with open(path, "w") as fh:
        fh.write(write_model(m))
    seen = []

    def spy(kst):
        seen.append(kst["c_lists"][:, [layout.H_SITES, layout.H_MERGED]].astype(np.int64))
        return layout.merged_sites(kst)

    monkeypatch.setattr(sweep, "merged_sites", spy)
    cfg = EngineConfig(model_path=path, device="cuda", burnin=100, converge_window=200,
                       chains=2, chains_per_variant=8192, max_secs=4.0, seed=3)
    res = Engine(cfg, log=lambda line: None).run()
    live, merged = seen[-1][:2].sum(axis=0)
    assert 0 < merged < live and res.samples > 0
    assert res.counters["sites.merged"] * live == merged * res.samples


def _wide_encs(name):
    """Stacked encodings with wide local tables: (encodings, rows, scope)."""
    if name == "wide10":  # a dv-rel-shaped 10-var binary factor: 512 rows
        m = torch_models.wide_factor(port_pgm, 10, seed=2)
        variants = [m, m]
    elif name == "star11_c0":  # a collapse factor over a blanket of 12
        m = torch_models.star(port_pgm, 11, seed=4, lo=0.2)
        variants = [collapse_var(m, 0)[0]] * 2
    elif name == "promedus8":  # chip_smoke.py's 8 widest collapse variants
        m, evidence = torch_models.promedus_like(port_pgm, seed=1)
        m.apply_evidence(evidence)
        variants = [collapse_var(m, v)[0] for v in torch_models.widest_collapsible(port_pgm, m, 8)]
    else:
        variants = [torch_models.collapsed(port_pgm, name)[1]] * 2
    caps = port_encode.caps_for_variants(variants, slot_hint=len(variants))
    assert sweep.kernel_refusal(caps) is None
    return [port_encode.encode_model(v, caps) for v in variants], caps.oa_cap, caps.scope_cap


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("name,rows,scope", [
    ("star8_c0", 64, 7), ("star6_card3_c0", 81, 5), ("star10_c0", 256, 9),
    ("promedus8", 256, 9), ("wide10", 512, 10), ("star11_c0", 1024, 11),
])
def test_wide_kernel_matches_plain_on_card(cuda_device, name, rows, scope, count):
    """The kernel's wide-table form (the reference's counted-loop lookup,
    ``gibbs_pallas.py:355-367``, and past its 256-row bound) against the
    plain version, counted and uncounted."""
    encs, oa, s = _wide_encs(name)
    assert (oa, s) == (rows, scope)
    _kernel_vs_plain(encs, cuda_device, 2048 if name == "promedus8" else 4096, count)


def test_collapse_group_on_card_vs_exact(cuda_device):
    """A 64-row collapse variant of the 8-var star and a plain slot, on the
    card through the kernel: every marginal (the collapsed centre's RB
    mixture included) within 5 sigma of exact."""
    m = torch_models.build(port_pgm, "star8")
    truth = exact_marginals(m)
    variant, _ = collapse_var(m, 0)
    caps = port_encode.caps_for_variants([variant], slot_hint=2)
    g = ChainGroup(m, chains_per_variant=4096, converge_window=50, device=cuda_device,
                   seed=7, caps=caps)
    g.reserve(2)
    g.add_variants([variant, m])
    before = gibbs_cuda.gibbs_window.launches
    g.burn(50)
    for _ in range(8):
        g.advance(defer=True)
        g.rb_accumulate()
    assert gibbs_cuda.gibbs_window.launches == before + 9
    h = hellinger(g.merged_marginals(), truth, m.cards)
    # 8192 chains x 400 counted sweeps on a tree mixing within ~4 sweeps,
    # plus at most 1.5e-3 of bias from each chain's uniform seed
    assert h.max() < 5.0 / np.sqrt(8 * 8192 * 400 / 4) + 1.5e-3, h
    assert g.convergence()[0] == 1.0


@pytest.mark.parametrize("name", ["grid4_evid", "grid3_card3_evid", "rand8_card4"])
def test_chain_group_on_card_vs_exact(cuda_device, name):
    """Tempered burn-in and deferred counted windows on the card converge
    to the exact marginals, through the kernel."""
    m = torch_models.build(port_pgm, name)
    truth = exact_marginals(m)
    g = ChainGroup(m, chains_per_variant=1024, converge_window=100,
                   device=cuda_device, seed=3)
    g.add_variants([m, m])
    before = gibbs_cuda.gibbs_window.launches
    g.burn_annealed(100, stages=5)
    for _ in range(4):
        g.advance(defer=True)
    h = hellinger(g.merged_marginals(), truth, m.cards, m.fixed)
    assert gibbs_cuda.gibbs_window.launches == before + 9
    # 2048 chains x 400 counted sweeps, n_eff >= 2048 * 400 / 8:
    # 5 sigma(H) ~ 5 / sqrt(8 n_eff), plus at most 1.5e-3 bias from each
    # chain's uniform 1/card seed over 400 counted sweeps
    assert h.max() < 5.0 / np.sqrt(8 * 2048 * 400 / 8) + 1.5e-3, h
    psrf = g.convergence()
    assert np.isfinite(psrf).all() and (psrf[m.fixed >= 0] == 1.0).all()


def _headroom_encs(case):
    """Collapse-headroom encodings: the shared test cases, or 8 collapse
    variants of the Promedus-shaped net at ``aux_caps`` (NVp 4200, local
    tables of 256 rows: the split group's aux encoding)."""
    if case != "promedus_aux":
        variants, caps, _ = torch_models.headroom_variants(port_pgm, case)
    else:
        m, evidence = torch_models.promedus_like(port_pgm, seed=1)
        m.apply_evidence(evidence)
        caps = aux_caps(m)
        assert caps.oa_cap == 256 and caps.num_rows == 4200
        variants = [collapse_var(m, v)[0] for v in torch_models.widest_collapsible(port_pgm, m, 8)]
    assert sweep.kernel_refusal(caps) is None
    return [port_encode.encode_model(v, caps) for v in variants]


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("case", ["grid4", "rand8", "star8_aux", "promedus_aux"])
def test_headroom_kernel_matches_plain_on_card(cuda_device, case, count):
    """Empty colour groups, dead spare incidences and long tails: the
    kernel against its plain version on the encodings adaptive runs use."""
    c = 2 * AUX_CHAINS if case == "promedus_aux" else 4096
    _kernel_vs_plain(_headroom_encs(case), cuda_device, c, count)


@pytest.mark.parametrize("split", [False, True])
def test_adaptive_group_on_card_vs_exact(cuda_device, split):
    """Two plain slots plus adaptively collapsed variants (a single group on
    headroom caps, or the split group), on the card through the kernel:
    every marginal within 5 sigma of exact, collapsed vars pinned in PSRF."""
    m = torch_models.build(port_pgm, "grid4_evid")
    truth = exact_marginals(m)
    if split:
        g = SplitChainGroup(m, chains_per_variant=2048, converge_window=50,
                            device=cuda_device, seed=7)
    else:
        g = ChainGroup(m, chains_per_variant=2048, converge_window=50, device=cuda_device,
                       seed=7, collapse_headroom=True)
    g.add_variants([m, m])
    before = gibbs_cuda.gibbs_window.launches
    g.burn(50)
    g.advance()
    added = adapt_step(g, 2) + adapt_step(g, 2)
    assert len(added) == 4 and g.num_variants == 6
    for _ in range(8):
        g.advance(defer=True)
        g.flush()
        g.rb_accumulate()
    assert gibbs_cuda.gibbs_window.launches > before + 9
    h = hellinger(g.merged_marginals(), truth, m.cards, m.fixed)
    # >= 4096 plain chains x 400 counted sweeps on a 4x4 grid mixing
    # within ~8 sweeps, plus at most 1.5e-3 of bias from the uniform seeds
    assert h.max() < 5.0 / np.sqrt(8 * 4096 * 400 / 8) + 1.5e-3, h
    assert (g.convergence()[added] == 1.0).all()


@pytest.mark.parametrize("net", ["grid4_evid", "promedus120"])
def test_wide_aux_tier_on_card(cuda_device, net):
    """On the card the split group builds its aux group on the wide tier
    (full width, the pooled caps, candidate bound 8); one window of its
    collapse variants at those caps through every form of the kernel
    against the plain version, and the group's own aux advance launches
    the kernel."""
    if net == "promedus120":
        m, evidence = torch_models.promedus_like(port_pgm, seed=1, v=120)
        m.apply_evidence(evidence)
    else:
        m = torch_models.build(port_pgm, net)
    g = SplitChainGroup(m, chains_per_variant=4096, converge_window=20, device=cuda_device,
                        seed=7)
    g.add_variants([m, m])
    g.prewarm_aux()
    spec = wide_aux_spec(m, cuda_device)
    assert g.aux_tier == "wide" and g.aux.caps == spec and g.aux_cpv == 4096
    assert g.collapse_oa_cap == PAL_AUX_OA_LIM and g.aux.route == "kernel"
    blankets = m.blankets()
    picks = [v for v in range(m.num_vars)
             if is_collapsible(m, v, blankets[v], oa_cap=PAL_AUX_OA_LIM)][:8]
    variants = [collapse_var(m, v)[0] for v in picks]
    _kernel_vs_plain([port_encode.encode_model(v, spec) for v in variants], cuda_device, 4096)
    g.add_variants(variants, burn_sweeps=2)
    assert g.aux.caps == spec
    before = gibbs_cuda.gibbs_window.launches
    g.flush()
    assert g.aux_ticks == 1 and gibbs_cuda.gibbs_window.launches > before


def test_kill_and_resume_bit_exact_on_card(cuda_device, tmp_path):
    """Two uninterrupted windows on the card equal one window, a save, a
    load and one window: state, halves and totals bit for bit."""
    m = torch_models.build(port_pgm, "grid4_evid")

    def fresh():
        g = ChainGroup(m, chains_per_variant=4096, converge_window=20, device=cuda_device,
                       seed=9)
        g.add_variants([m, m])
        g.burn(10)
        g.advance()
        return g

    a = fresh()
    a.advance()
    b = fresh()
    path = str(tmp_path / "kill.npz")
    save_checkpoint(path, b)
    del b
    b2, _ = load_checkpoint(path, m, device=cuda_device)
    b2.advance()
    assert torch.equal(a.state, b2.state) and torch.equal(a.halves, b2.halves)
    np.testing.assert_array_equal(a.totals, b2.totals)
    assert (a.total_samples, a.total_sweeps) == (b2.total_samples, b2.total_sweeps)


# ---- chains sharded over a mesh ----------------------------------------------

def _mesh_pair(m, device, mesh, cpv, **kw):
    g = ShardedChainGroup(m, cpv, 20, seed=9, mesh=mesh, **kw)
    p = ChainGroup(m, cpv, 20, device, seed=9, **kw)
    p.cb = g.cb
    return g, p


def _assert_shards_equal(g, p):
    assert torch.equal(g.state, p.state.cpu()) and torch.equal(g.halves, p.halves.cpu())
    np.testing.assert_array_equal(g.totals, p.totals)
    np.testing.assert_allclose(g.convergence(), p.convergence(), rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("cpv", [4096, 65536])
def test_sharded_equals_unsharded_on_card(cuda_device, shape, cpv):
    """A group sharded over a virtual mesh of the card equals the unsharded
    group with the same hash width bit for bit, in both kernel forms (the
    small shards launch site-parallel, the large ones a thread per chain);
    every shard launches the kernel."""
    m = torch_models.build(port_pgm, "grid4_evid")
    mesh = chain_mesh(variant_ways=shape[0], devices=[cuda_device] * (shape[0] * shape[1]))
    g, p = _mesh_pair(m, cuda_device, mesh, cpv, collapse_headroom=True)
    before = gibbs_cuda.gibbs_window.launches
    for x in (g, p):
        x.reserve(4)
        x.add_variants([m, m, collapse_var(m, 6)[0]])
        x.burn_annealed(12, stages=3)
        x.advance()
        x.rb_accumulate()
        x.add_variant(collapse_var(m, 9)[0], burn_sweeps=2, init_states=x.plain_slot_states())
        x.advance(defer=True)
        x.flush()
    assert gibbs_cuda.gibbs_window.launches == before + 6 * (shape[0] * shape[1] + 1)
    _assert_shards_equal(g, p)
    np.testing.assert_array_equal(g.merged_marginals(), p.merged_marginals())


def test_sharded_checkpoint_crosses_meshes_on_card(cuda_device, tmp_path):
    m = torch_models.build(port_pgm, "grid4_evid")
    g, p = _mesh_pair(m, cuda_device, chain_mesh(variant_ways=2, devices=[cuda_device] * 4), 8192)
    for x in (g, p):
        x.add_variants([m, m])
        x.burn(10)
        x.advance()
    path = str(tmp_path / "mesh.npz")
    save_checkpoint(path, g)
    b, _ = load_checkpoint(path, m, device=cuda_device, make_group=lambda model, **kw:
                           ShardedChainGroup(model, mesh=chain_mesh(
                               variant_ways=1, devices=[cuda_device] * 4), **kw))
    u, _ = load_checkpoint(path, m, device=cuda_device)
    assert b.cb == u.cb == g.cb and not isinstance(u, ShardedChainGroup)
    for x in (g, p, b, u):
        x.advance()
    for x in (g, b):
        _assert_shards_equal(x, p)
    assert torch.equal(u.state, p.state) and torch.equal(u.halves, p.halves)


@pytest.mark.parametrize("n_cards", [2, 4])
def test_sharded_over_two_cards(cuda_device, n_cards):
    """On a machine with ``n_cards`` cards: one shard on each, each
    shard's tensors on its own card, every card launching the kernel, and
    the group equal to the unsharded one (each card gets the kernel's
    shared-memory attribute at its own launches)."""
    if torch.cuda.device_count() < n_cards:
        pytest.skip(f"needs {n_cards} CUDA devices")
    m = _long_chain()  # lists above 48 KB: the attribute matters
    g, p = _mesh_pair(m, cuda_device, chain_mesh(n_devices=n_cards), 2048)
    before = dict(gibbs_cuda.gibbs_window.launches_by_device)
    g.add_variants([m, m])
    g.burn(3)
    g.advance()
    launched = {d: k - before.get(d, 0)
                for d, k in gibbs_cuda.gibbs_window.launches_by_device.items()}
    assert sorted(str(sh.device) for sh in g.shards) == [f"cuda:{i}" for i in range(n_cards)]
    for sh in g.shards:
        assert sh.state.device == sh.halves.device == sh.device
        assert all(t.device == sh.device for t in g.kstack[sh.vi].tensors[sh.device].values())
        assert launched[str(sh.device)] >= 2
    p.add_variants([m, m])
    p.burn(3)
    p.advance()
    _assert_shards_equal(g, p)


def test_checkpoint_from_cards_resumes_on_one(cuda_device, tmp_path):
    """A group sharded over every card (up to four) is saved, resumed on
    one card and on a 1xN mesh, advanced: both equal the group that was
    never saved."""
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two CUDA devices")
    m = torch_models.build(port_pgm, "grid4_evid")
    g, p = _mesh_pair(m, cuda_device, chain_mesh(n_devices=n), 1024 * n)
    for x in (g, p):
        x.add_variants([m, m])
        x.burn(10)
        x.advance()
    path = str(tmp_path / "cards.npz")
    save_checkpoint(path, g)
    u, _ = load_checkpoint(path, m, device=cuda_device)
    r, _ = load_checkpoint(path, m, device=cuda_device, make_group=lambda model, **kw:
                           ShardedChainGroup(model, mesh=chain_mesh(n_devices=n, variant_ways=1),
                                             **kw))
    assert not isinstance(u, ShardedChainGroup) and u.cb == r.cb == g.cb
    assert sorted(str(sh.device) for sh in r.shards) == [f"cuda:{i}" for i in range(n)]
    for x in (g, p, u, r):
        x.advance()
    for x in (g, r):
        _assert_shards_equal(x, p)
    assert torch.equal(u.state, p.state) and torch.equal(u.halves, p.halves)
    np.testing.assert_array_equal(u.totals, p.totals)


# ---- the torch-ops route on the card -------------------------------------------

@pytest.mark.parametrize("name", ["star10_c0", "promedus8", "rand8_card4"])
def test_ops_route_matches_kernel_on_card(cuda_device, name):
    """One model encoded dense, through the CUDA kernel, and all-gather,
    through ``window_ops`` on the card, same seed and state: both banks
    are summed in factor order, so at most 0.1 % of sites differ (the
    kernel's ``expf`` against ``torch.exp`` on a CDF boundary), counts
    agree where the states agree, and the ops route on the dense encoding
    equals the plain version exactly."""
    from grample_tpu_torch.ops.gibbs_bank import window_ops

    if name == "rand8_card4":
        m = torch_models.build(port_pgm, name)
        caps = port_encode.compute_caps(m, headroom_factors=0)
        variants = [m, m]
    else:
        encs, _, _ = _wide_encs(name)
        caps = encs[0].caps
        m, evidence = torch_models.promedus_like(port_pgm, seed=1)
        m.apply_evidence(evidence)
        variants = ([collapse_var(m, v)[0] for v in torch_models.widest_collapsible(port_pgm, m, 8)]
                    if name == "promedus8" else [torch_models.collapsed(port_pgm, name)[1]] * 2)
    dense = [port_encode.encode_model(v, caps) for v in variants]
    gather = [port_encode.encode_model(v, torch_models.all_gather(caps)) for v in variants]
    kd = sweep.sweep_tensors(port_encode.stack_variants(dense), cuda_device)
    kg = sweep.sweep_tensors(port_encode.stack_variants(gather), cuda_device, compact=False)
    assert torch.equal(kd["pal_oon"], kg["pal_oon"])
    n, c, nslot = len(variants), 2048, caps.num_slots
    rng = np.random.default_rng(4)
    cards = np.stack([e.cards for e in dense])[np.arange(n)[:, None], kd["pal_oon"].cpu().numpy()]
    state = torch.as_tensor(np.floor(rng.random((n, caps.num_rows, c)) * cards[:, :, None])
                            .astype(np.int32), device=cuda_device)
    sk, ck = gibbs_cuda.gibbs_window(kd, state.clone(), 11, 1, 0, True, 512)
    so, co = window_ops(kg, state.clone(), 11, 1, 0, True, 512)
    assert so.is_cuda and co.is_cuda
    assert (sk[:, :nslot] != so[:, :nslot]).float().mean().item() <= 1e-3
    agree = (sk[:, :nslot] == so[:, :nslot]).all(dim=0)
    assert torch.equal(ck[:, :, :, agree], co[:, :, :, agree])
    assert ck.sum().item() == co.sum().item()
    sp, cp = window_plain(*[kd[k] for k in sweep.KERNEL_KEYS], state.clone(), 11, 2, 1, True, 512)
    sd, cd = window_ops(kd, state.clone(), 11, 2, 1, True, 512)
    assert torch.equal(sd, sp) and torch.equal(cd, cp)


def _gather_encs(case):
    """Encodings of a ``torch_models.GATHER_CASES`` case, of the 916-var
    Promedus-shaped net at the single adaptive group's headroom caps
    (all-gather), or of a 4x4 grid at card 16 encoded all-gather."""
    if case == "promedus_head":
        m, evidence = torch_models.promedus_like(port_pgm, seed=1)
        m.apply_evidence(evidence)
        variants = [m, m]
        caps = port_encode.compute_caps(m, collapse_headroom=True, slot_hint=128,
                                        headroom_factors=2)
    elif case == "grid_card16":
        m = torch_models.grid(port_pgm, 4, seed=3, card=16)
        variants = [m, m]
        caps = torch_models.all_gather(port_encode.compute_caps(m, headroom_factors=0))
    else:
        variants, caps = torch_models.gather_variants(port_pgm, case)
    assert caps.gfac_cap > 0 and sweep.kernel_refusal(caps) is None
    return [port_encode.encode_model(v, caps) for v in variants]


@pytest.mark.parametrize("count,half_point", [(True, 0), (True, 1), (True, 3), (False, 1)])
@pytest.mark.parametrize("case", [*torch_models.GATHER_CASES, "promedus_head", "grid_card16"])
def test_gather_form_matches_window_ops_on_card(cuda_device, case, count, half_point):
    """The kernel's gather form, in every form, against ``window_ops`` on
    the card (``_kernel_vs_plain``), at 4096 chains a variant, counted at
    half points 0, 1 and 3 and uncounted."""
    _kernel_vs_plain(_gather_encs(case), cuda_device, 4096, count, half_point)


def test_gather_form_draws_as_the_dense_kernel(cuda_device):
    """One model's 8 collapse variants encoded dense and all-gather, both
    through the kernel from the same state and seed: the two banks hold
    the same floats, summed in factor order, so at most 0.1 % of sites
    differ (none expected) and count totals are equal."""
    m, evidence = torch_models.promedus_like(port_pgm, seed=1)
    m.apply_evidence(evidence)
    variants = [collapse_var(m, v)[0] for v in torch_models.widest_collapsible(port_pgm, m, 8)]
    caps = port_encode.caps_for_variants(variants, slot_hint=8)
    dense = [port_encode.encode_model(v, caps) for v in variants]
    kd, kg = (sweep.sweep_tensors(port_encode.stack_variants(encs), cuda_device) for encs in (
        dense, [port_encode.encode_model(v, torch_models.all_gather(caps)) for v in variants]))
    assert gibbs_cuda.uses_gather(kg) and not gibbs_cuda.uses_gather(kd)
    n, c, nslot = len(variants), 4096, caps.num_slots
    oon = kd["pal_oon"].cpu().numpy()
    cards = np.stack([e.cards for e in dense])[np.arange(n)[:, None], oon]
    fixed = np.stack([e.fixed for e in dense])[np.arange(n)[:, None], oon]
    rng = np.random.default_rng(6)
    init = np.floor(rng.random((n, caps.num_rows, c)) * cards[:, :, None])
    init = np.where(fixed[:, :, None] >= 0, fixed[:, :, None], init)
    state = torch.as_tensor(init.astype(np.int32), device=cuda_device)
    sd, cd = gibbs_cuda.gibbs_window(kd, state.clone(), 5, 2, 1, True, 512)
    sg, cg = gibbs_cuda.gibbs_window(kg, state.clone(), 5, 2, 1, True, 512)
    torch.cuda.synchronize()
    assert (sd[:, :nslot] != sg[:, :nslot]).float().mean().item() <= 1e-3
    assert cd.sum().item() == cg.sum().item()


def test_eligible_caps_on_card_never_take_the_ops_route(cuda_device, monkeypatch):
    """A group whose caps pass the kernel's gate launches the kernel and
    nothing else on a CUDA tensor, on dense and on gather caps (the
    kernel's gather form); a group on caps the gate refuses (card bound
    17) launches no kernel."""
    from grample_tpu_torch.ops import gibbs_bank

    m = torch_models.build(port_pgm, "grid4_evid")
    g = ChainGroup(m, 256, 8, cuda_device, seed=1)
    assert g.route == "kernel"
    g.add_variants([m, m])
    ops_before, kernel_before = gibbs_bank.window_ops.launches, gibbs_cuda.gibbs_window.launches
    monkeypatch.setattr(sweep, "window_plain",
                        lambda *a, **k: pytest.fail("the plain version ran on a CUDA tensor"))
    g.burn(2)
    g.advance()
    assert gibbs_bank.window_ops.launches == ops_before
    assert gibbs_cuda.gibbs_window.launches == kernel_before + 2
    caps = torch_models.all_gather(port_encode.compute_caps(m, headroom_factors=0))
    monkeypatch.setattr(sweep, "window_ops",
                        lambda *a, **k: pytest.fail("the ops route ran on kernel caps"))
    gk = ChainGroup(m, 256, 8, cuda_device, seed=1, caps=caps)
    assert gk.route == "kernel"
    gk.add_variants([m, m])
    gk.burn(2)
    gk.advance()
    assert gibbs_cuda.gibbs_window.launches == kernel_before + 4
    assert gibbs_cuda.gibbs_window.launches_by_form.get(
        "thread per chain, counted, gather bank", 0) \
        + gibbs_cuda.gibbs_window.launches_by_form.get("site-parallel, counted, gather bank", 0) > 0
    assert (gk.state != g.state).float().mean().item() <= 1e-3
    monkeypatch.undo()
    h = ChainGroup(m, 256, 8, cuda_device, seed=1, caps=dataclasses.replace(caps, max_card=17))
    assert h.route == "ops"
    h.add_variants([m, m])
    h.burn(2)
    h.advance()
    assert gibbs_cuda.gibbs_window.launches == kernel_before + 4
    assert gibbs_bank.window_ops.launches == ops_before + 2
    # the same seeds and hash cells on both routes: the chains agree but
    # for draws on a CDF boundary
    assert (h.state != g.state).float().mean().item() <= 1e-3
    assert h.totals.sum() == g.totals.sum()


def test_bench_throughput_leg_on_card(cuda_device, tmp_path, monkeypatch):
    """The bench's throughput leg on a small grid on the card: the kernel
    route, kernel launches, a rate, the card named."""
    from grample_tpu_torch import bench
    from grample_tpu_torch.ops.bound import card_line
    from grample_tpu_torch.uai.writer import write_model

    with open(tmp_path / "grid4.uai", "w") as fh:
        fh.write(write_model(torch_models.grid(port_pgm, 4, seed=3)))
    monkeypatch.setattr(bench, "RES", str(tmp_path))
    monkeypatch.setattr(bench, "DEVICE", "cuda")
    monkeypatch.setattr(bench, "CHAINS", 4096)
    before = gibbs_cuda.gibbs_window.launches
    out = bench.phase_throughput("grid4", 0.0)
    assert out["route"] == "kernel" and out["device_samples_per_sec"] > 0
    assert gibbs_cuda.gibbs_window.launches > before and sum(out["launches_by_form"].values()) > 0
    assert out["device"] == card_line() and out["est_ops_per_site"] == 40


def test_flush_spans_end_with_their_ticks_kernels(cuda_device, tmp_path):
    """Under ``torch.profiler`` with CUDA activity, an engine run at the
    benchmark grid cell's shape (2 x 131072 chains, 2000-sweep windows):
    on the profiler's absolute clock (the tracer's times plus
    ``RunResult.wall_offset_ns``: kineto's timestamps are unix time), each
    ``tick.flush`` span ends after the last Gibbs kernel of its tick, and
    within 2 ms of the tick's last device operation (the copy of its last
    window's counts).  The torch ops of a window that follow its kernel (the
    count map, the delta's sum) take a few ms of their own.  Prints the
    offsets."""
    from grample_tpu_torch.sampler.engine import Engine, EngineConfig
    from grample_tpu_torch.uai.writer import write_model

    path = str(tmp_path / "grid10.uai")
    with open(path, "w") as fh:
        fh.write(write_model(torch_models.grid(port_pgm, 10, seed=1)))
    cfg = EngineConfig(model_path=path, device="cuda", burnin=100 * 100,
                       converge_window=2000 * 100, chains=2, chains_per_variant=131072,
                       max_secs=8.0, seed=3, status_secs=2.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = Engine(cfg, log=lambda line: None).run()
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), "gibbs_window" in e.name())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    ticks = {}
    for e in res.events:
        if e.name in ("tick.launch", "tick.flush"):
            ticks.setdefault(e.tick, {})[e.name] = (e.start_ns + res.wall_offset_ns,
                                                    e.end_ns + res.wall_offset_ns)
    slack = 2_000_000  # the profiler's own conversion of device time drifts by about 1 ms
    gibbs, last_op = [], []
    for t in sorted(ticks):
        launch, flush = ticks[t]["tick.launch"], ticks[t]["tick.flush"]
        mine = [(b, g) for a, b, g in ops if launch[0] - slack <= a <= flush[1]]
        assert any(g for _, g in mine), (t, launch, flush)
        gibbs.append(flush[1] - max(b for b, g in mine if g))
        last_op.append(flush[1] - max(b for b, _ in mine))
    print(f"tick.flush end - last Gibbs kernel end, ns, by tick: {gibbs}; - last device "
          f"operation end: {last_op}; unix clock - tracer clock: {res.wall_offset_ns} ns")
    assert len(gibbs) >= 2 and all(d > 0 for d in gibbs), gibbs
    assert all(-slack // 2 <= d <= 2_000_000 for d in last_op), last_op
