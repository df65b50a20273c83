"""The port's torch-ops sweep (``ops.gibbs_bank``: dense bank and
flat-table gather bank; the plain version of the kernel's gather form and
the route of what the kernel refuses) against the reference's XLA sweep
(``grample_tpu/ops/gibbs_xla.py``), against the plain version of the
kernel, against exact marginals, under a mesh, and through the adaptive
engine on a Promedus-shaped net whose headroom caps go all-gather (the
kernel's gather form)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.pgm.encode as ref_encode
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
from grample_tpu.ops import gibbs_xla
from grample_tpu_torch.convert import encoding_from_reference
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.ops import gibbs_bank, gibbs_cuda, sweep
from grample_tpu_torch.ops.gibbs_torch import window_plain
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.sampler.collapse import collapse_var
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.uai.writer import write_evidence, write_model

from tests import torch_models
from tests.test_torch_layout import walk_logits
from tests.test_torch_parallel import _assert_equal, _drive_annealed, _drive_plain, _pair
from tests.torch_models import all_gather


def card17(caps):
    """``caps`` at card bound 17, which the kernel refuses: the torch-ops
    route's own tests keep to it."""
    return dataclasses.replace(caps, max_card=17)


def _model(pgm, name):
    """A plain net, a collapse variant (``torch_models.WIDE``) or the
    12-var wide factor, built with ``pgm``'s package."""
    if name == "wide12":
        return torch_models.wide_factor(pgm, 12, seed=2)
    if name in torch_models.WIDE:
        return torch_models.collapsed(pgm, name)[1]
    return torch_models.build(pgm, name)


def _caps(encode, m, mode):
    """Exact caps of ``m``: ``dense``; ``mixed`` (dense threshold 32, so
    wider incidences go to the gather bank); ``gather`` (all-gather)."""
    if mode == "mixed":
        return encode.compute_caps(m, headroom_factors=0, oa_dense_cap=32)
    caps = encode.caps_for_variants([m])
    return all_gather(caps) if mode == "gather" else caps


def _kernel_state(kst, state):
    """[N, C, V+1] old-order state -> kernel order [N, NVp, C]."""
    oon = kst["pal_oon"].long()
    n, c, _ = state.shape
    st = torch.gather(torch.as_tensor(state), 2, oon[:, None, :].expand(n, c, oon.shape[1]))
    return st.transpose(1, 2).contiguous()


def _random_state(enc, n, chains, seed):
    rng = np.random.default_rng(seed)
    draw = np.floor(rng.random((n, chains, enc.cards.size)) * enc.cards).astype(np.int32)
    return np.where(enc.fixed >= 0, enc.fixed, draw).astype(np.int32)


# ---- (a) the logits against the reference's --------------------------------

@pytest.mark.parametrize("name,mode", [
    ("rand8_card4", "dense"), ("star10_c0", "dense"),
    ("wide12", "mixed"),
    ("rand8_card4", "gather"), ("star8_c0", "gather"),
])
def test_color_logits_match_reference(name, mode):
    """Same encoding and state through ``gibbs_xla._color_logits`` (encode
    order, [G, K, C]) and the port's ``color_logits`` (kernel order,
    [N, G, C, K]): every live row agrees to rtol 1e-5."""
    m = _model(ref_pgm, name)
    enc = ref_encode.encode_model(m, _caps(ref_encode, m, mode))
    caps = enc.caps
    assert (caps.gfac_cap > 0) == (mode != "dense")
    assert (caps.adj_cap > 0) == (mode != "gather")
    if mode == "mixed":
        assert enc.gb_mask.sum() == 12 and caps.oa_cap == 1
    arrays = enc.arrays()
    kst = encoding_from_reference(arrays, "cpu", compact=mode == "dense")
    state = _random_state(enc, 1, 24, seed=4)
    ref_state = jnp.asarray(state[0].T[enc.old_of_new].astype(np.float32))  # [NVp, C]
    port_state = _kernel_state(kst, state)
    G = caps.group_cap
    checked = 0
    for ci in range(caps.color_cap):
        xs = tuple(jnp.asarray(arrays[k][ci]) for k in gibbs_xla._XS_KEYS)
        want = np.asarray(gibbs_xla._color_logits(ref_state, jnp.asarray(enc.tables), xs))
        got = gibbs_bank.color_logits(kst, port_state, ci)[0].numpy()  # [G, C, K]
        for g in range(G):
            var = int(kst["pal_oon"][0, ci * G + g])
            if var == caps.num_vars:
                continue  # padding row
            g_ref = int(enc.new_of_old[var]) - ci * G
            np.testing.assert_allclose(got[g], want[g_ref].T, rtol=1e-5, atol=1e-6)
            checked += 1
    assert checked == int(m.free_mask.sum())


@pytest.mark.parametrize("name,mode", [
    ("wide12", "mixed"), ("rand8_card4", "gather"), ("star8_c0", "gather"),
    ("grid4_evid", "gather"),
])
def test_walker_logits_match_reference(name, mode):
    """The kernel's walk of the compact lists of both banks
    (``test_torch_layout.walk_logits``) against ``gibbs_xla._color_logits``
    on the same encoding and state: every live row's in-card outcomes
    agree to rtol 1e-5 (the reference sums the gather bank by XLA's
    reduction, the walk in ``Fg`` order)."""
    m = _model(ref_pgm, name)
    enc = ref_encode.encode_model(m, _caps(ref_encode, m, mode))
    caps = enc.caps
    assert caps.gfac_cap > 0 and sweep.kernel_refusal(caps) is None
    arrays = enc.arrays()
    kst = encoding_from_reference(arrays, "cpu")
    state = _random_state(enc, 1, 24, seed=5)
    ref_state = jnp.asarray(state[0].T[enc.old_of_new].astype(np.float32))  # [NVp, C]
    port_state = _kernel_state(kst, state)
    G = caps.group_cap
    checked = 0
    for ci in range(caps.color_cap):
        xs = tuple(jnp.asarray(arrays[k][ci]) for k in gibbs_xla._XS_KEYS)
        want = np.asarray(gibbs_xla._color_logits(ref_state, jnp.asarray(enc.tables), xs))
        got = walk_logits(kst, port_state, 0, ci).numpy()  # [G, C, K]
        for g in range(G):
            var = int(kst["pal_oon"][0, ci * G + g])
            if var == caps.num_vars:
                continue  # padding row
            card = int(m.cards[var])
            g_ref = int(enc.new_of_old[var]) - ci * G
            np.testing.assert_allclose(got[g][:, :card], want[g_ref].T[:, :card],
                                       rtol=1e-5, atol=1e-6)
            checked += 1
    assert checked == int(m.free_mask.sum())


# ---- (b) bit for bit the plain version on dense encodings --------------------

@pytest.mark.parametrize("count", [True, False], ids=["counted", "uncounted"])
@pytest.mark.parametrize("name", ["grid3", "rand8_card4", "star10_c0"])
def test_window_ops_equals_window_plain(name, count):
    m = _model(port_pgm, name)
    enc = port_encode.encode_model(m, _caps(port_encode, m, "dense"))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc] * 3), "cpu")
    state = _kernel_state(kst, _random_state(enc, 3, 96, seed=1))
    want, want_counts = window_plain(*[kst[k] for k in sweep.KERNEL_KEYS], state.clone(),
                                     -77, 3, 1, count, 32)
    got, got_counts = gibbs_bank.window_ops(kst, state.clone(), -77, 3, 1, count, 32)
    assert torch.equal(got, want)
    assert (got_counts is None and want_counts is None) or torch.equal(got_counts, want_counts)
    if count:
        assert int(got_counts.sum()) == 3 * 3 * 96 * int(m.free_mask.sum())


def test_window_ops_in_chain_blocks(monkeypatch):
    """A window cut into blocks of chains (the byte bound on the largest
    intermediate) equals the window in one piece."""
    m = _model(port_pgm, "rand8_card4")
    enc = port_encode.encode_model(m, _caps(port_encode, m, "gather"))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc] * 2), "cpu", compact=False)
    state = _kernel_state(kst, _random_state(enc, 2, 80, seed=2))
    assert gibbs_bank.chain_block(kst, 80) == 80
    want, want_counts = gibbs_bank.window_ops(kst, state.clone(), 9, 2, 1, True, 16)
    per_chain = gibbs_bank.BLOCK_BYTES // gibbs_bank.chain_block(kst, 1 << 40)
    monkeypatch.setattr(gibbs_bank, "BLOCK_BYTES", per_chain * 24)
    assert gibbs_bank.chain_block(kst, 80) == 24  # blocks of 24, 24, 24, 8 chains
    got, got_counts = gibbs_bank.window_ops(kst, state.clone(), 9, 2, 1, True, 16)
    assert torch.equal(got, want) and torch.equal(got_counts, want_counts)


# ---- (c) one model, dense and all-gather -------------------------------------

@pytest.mark.parametrize("name", ["grid3", "rand8_card4", "star10_c0", "grid4_evid"])
def test_dense_and_gather_encodings_draw_alike(name):
    """The kernel order counts gather incidences into the degree, so both
    encodings of one model give every variable the same hash row; both
    banks hold the same float32 table entries and are summed in factor
    order, so the windows are equal: 0 sites differ."""
    m = _model(port_pgm, name)
    dense = port_encode.encode_model(m, _caps(port_encode, m, "dense"))
    gather = port_encode.encode_model(m, _caps(port_encode, m, "gather"))
    assert gather.caps.adj_cap == 0
    assert gather.gb_mask.sum() == dense.adj_mask[:-1][m.free_mask].sum()
    kd = sweep.sweep_tensors(port_encode.stack_variants([dense] * 2), "cpu")
    kg = sweep.sweep_tensors(port_encode.stack_variants([gather] * 2), "cpu", compact=False)
    assert not set(kg) & {"c_lists", "c_tables", "c_rows"}
    for key in ("pal_oon", "pal_noo", "pal_soo", "k_kmask"):
        assert torch.equal(kd[key], kg[key]), key
    state = _kernel_state(kd, _random_state(dense, 2, 64, seed=3))
    want, want_counts = window_plain(*[kd[k] for k in sweep.KERNEL_KEYS], state.clone(),
                                     5, 4, 2, True, 64)
    got, got_counts = gibbs_bank.window_ops(kg, state.clone(), 5, 4, 2, True, 64)
    assert int((got != want).sum()) == 0
    assert torch.equal(got_counts, want_counts)


def test_kernel_order_of_a_mixed_encoding():
    """In a mixed encoding the wide factor's 12 gather incidences count
    toward the degree like dense ones."""
    from grample_tpu_torch.ops.layout import kernel_perm

    m = _model(port_pgm, "wide12")
    enc = port_encode.encode_model(m, _caps(port_encode, m, "mixed"))
    with_bank = kernel_perm(enc.sw_local_tables, None, enc.gb_mask)
    assert np.array_equal(with_bank, kernel_perm(enc.sw_local_tables))  # one site a colour
    lt = np.zeros((1, 3, 2, 1, 2), np.float32)
    lt[0, 1, 0] = 1.0  # row 1: one real dense incidence
    gb = np.zeros((1, 3, 2), bool)
    gb[0, 2] = True  # row 2: two gather incidences
    assert kernel_perm(lt)[0].tolist() == [1, 0, 2]
    assert kernel_perm(lt, None, gb)[0].tolist() == [2, 1, 0]


# ---- (d) marginals ------------------------------------------------------------

def _reference_marginals(m, caps, chains, burn, sweeps, seed):
    """[V, K] estimate of ``gibbs_xla.advance_chains`` on one variant."""
    enc = ref_encode.encode_model(m, caps)
    stack = {k: jnp.asarray(v) for k, v in ref_encode.stack_variants([enc]).items()}
    key = jax.random.key(seed, impl="rbg")
    state = gibbs_xla.init_state(stack, key, chains, m.max_card)
    halves = jnp.zeros((1, 2, chains, m.num_vars + 1, m.max_card), jnp.float32)
    state, halves = gibbs_xla.advance_chains(
        stack, state, halves, jax.random.fold_in(key, 1), burn, burn, count=False)
    state, halves = gibbs_xla.advance_chains(
        stack, state, halves, jax.random.fold_in(key, 2), sweeps, sweeps // 2)
    counts = np.asarray(halves.sum(axis=(1, 2)))[0][:-1]
    return counts / counts.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("name,mode", [("wide12", "mixed"), ("rand8_card4", "gather")])
def test_ops_route_marginals(name, mode):
    """A group on the ops route (the gather bank at card bound 17, which
    the kernel refuses) against exact marginals and against the
    reference's XLA sweep on the same net and caps.  512 chains x 128
    counted sweeps, taken as n = 32768 independent samples a var (half,
    for the sweeps' autocorrelation): 5 sigma(H) = 5 / sqrt(8 n) = 0.0098
    against exact, sqrt(2) times that between two estimates."""
    m = _model(port_pgm, name)
    caps = card17(_caps(port_encode, m, mode))
    g = ChainGroup(m, 512, 128, device="cpu", caps=caps, seed=11)
    assert g.route == "ops" and "c_lists" not in (g.kstack.tensors[g.device] if g.kstack
                                                  else {})
    assert "max card 17" in sweep.kernel_refusal(caps)
    g.add_variant(m)
    assert set(sweep.COMPACT_KEYS).isdisjoint(g.kstack.tensors[g.device])
    g.burn(32)
    g.advance()
    got = g.merged_marginals()[:, :m.max_card]
    got = got / got.sum(axis=1, keepdims=True)
    free = m.free_mask
    bound = 5 / np.sqrt(8 * 32768)
    truth = exact_marginals(m)
    assert hellinger(got[free], truth[free], m.cards[free]).max() < bound
    rm = _model(ref_pgm, name)
    want = _reference_marginals(rm, _caps(ref_encode, rm, mode), 512, 32, 128, seed=11)
    assert hellinger(got[free], want[free], m.cards[free]).max() < bound * np.sqrt(2)
    assert got[~free].sum() == pytest.approx(float((~free).sum()))  # evidence: the seed only


# ---- (e) under a mesh ---------------------------------------------------------

def _drive_collapse_gather(g, m):
    g.add_variants([m, m])
    g.add_variant(collapse_var(m, 4)[0], burn_sweeps=2)
    g.burn(5)
    for _ in range(2):
        g.advance()
        g.rb_accumulate()


def _headroom_gather(m):
    return all_gather(port_encode.compute_caps(
        m, collapse_headroom=True, slot_hint=128, headroom_factors=2))


@pytest.mark.parametrize("drive", ["plain", "annealed", "collapse"])
def test_sharded_equals_unsharded_on_the_ops_route(drive):
    """A 2x2 virtual mesh against one group with the same ``cb``, both on
    all-gather caps at card bound 17 (the ops route): state, halves and
    totals bit for bit, through a tempered burn-in (the flat tables
    scaled per shard) and through a collapse variant written into a
    slot."""
    m = torch_models.build(port_pgm, "grid4_evid")
    g, p = _pair(m, "2x2", caps=card17(_headroom_gather(m)))
    assert g.route == p.route == "ops" and g.cb == 16
    run = {"plain": _drive_plain, "annealed": _drive_annealed,
           "collapse": _drive_collapse_gather}[drive]
    before = gibbs_bank.window_ops.launches
    for x in (g, p):
        run(x, m)
    assert gibbs_bank.window_ops.launches > before
    _assert_equal(g, p)
    for row in g.kstack:
        assert all(set(sweep.COMPACT_KEYS).isdisjoint(kst) for kst in row.tensors.values())


@pytest.mark.parametrize("drive", ["plain", "annealed", "collapse"])
def test_sharded_equals_unsharded_on_gather_caps(drive):
    """The same on all-gather caps the kernel takes: both groups on the
    kernel route (its plain version here, ``window_ops``), bit for bit,
    and every shard row's compact lists are those of its own slots."""
    m = torch_models.build(port_pgm, "grid4_evid")
    g, p = _pair(m, "2x2", caps=_headroom_gather(m))
    assert g.route == p.route == "kernel"
    run = {"plain": _drive_plain, "annealed": _drive_annealed,
           "collapse": _drive_collapse_gather}[drive]
    for x in (g, p):
        run(x, m)
    _assert_equal(g, p)
    nl = g.local_slots
    want = sweep.sweep_tensors(port_encode.stack_variants(
        p.encs + [p.encs[0]] * (p.slot_cap - len(p.encs))), "cpu")
    for vi, row in enumerate(g.kstack):
        for kst in row.tensors.values():
            assert gibbs_cuda.uses_gather(kst)
            for key in sweep.COMPACT_KEYS:
                got, w = kst[key], want[key][vi * nl:(vi + 1) * nl]
                width = max(got.shape[1], w.shape[1])
                assert torch.equal(torch.nn.functional.pad(got, (0, width - got.shape[1])),
                                   torch.nn.functional.pad(w, (0, width - w.shape[1]))), key


# ---- (f) the tempered burn-in scales the flat tables ---------------------------

def test_scale_tables_scales_the_flat_tables():
    m = _model(port_pgm, "rand8_card4")
    enc = port_encode.encode_model(m, _caps(port_encode, m, "gather"))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc]), "cpu", compact=False)
    cold = sweep.scale_tables(kst, 0.25)
    assert torch.equal(cold["tables"], kst["tables"] * 0.25)
    assert set(cold) == set(kst) and cold["gb_offset"] is kst["gb_offset"]
    state = _kernel_state(kst, _random_state(enc, 1, 256, seed=6))
    full, _ = gibbs_bank.window_ops(kst, state.clone(), 3, 4, 4, False, 64)
    tempered, _ = gibbs_bank.window_ops(cold, state.clone(), 3, 4, 4, False, 64)
    again, _ = gibbs_bank.window_ops(sweep.scale_tables(kst, 1.0), state.clone(),
                                     3, 4, 4, False, 64)
    assert torch.equal(again, full) and not torch.equal(tempered, full)


def test_group_burn_annealed_on_the_ops_route():
    """A group on gather caps burns in tempered: its chains differ from a
    plain burn's with the same seeds, and its tables are restored."""
    m = _model(port_pgm, "rand8_card4")
    caps = _caps(port_encode, m, "gather")
    groups = [ChainGroup(m, 64, 8, device="cpu", caps=caps, seed=2) for _ in range(2)]
    for g in groups:
        g.add_variant(m)
    tables = groups[0].kstack.tensors[groups[0].device]["tables"].clone()
    groups[0].burn_annealed(8, stages=4)
    for _ in range(4):
        groups[1].burn(2)
    assert groups[0]._step == groups[1]._step
    assert torch.equal(groups[0].kstack.tensors[groups[0].device]["tables"], tables)
    assert not torch.equal(groups[0].state, groups[1].state)


# ---- (g) the adaptive engine on a Promedus-shaped net --------------------------

#: the smallest Promedus-shaped size (in steps of 40 vars) whose headroom
#: caps for 128 slots leave the dense bank: 520 vars stay dense
PROMEDUS_VARS = 560


def _promedus(tmp_path):
    m, evidence = torch_models.promedus_like(port_pgm, seed=1, v=PROMEDUS_VARS)
    path = str(tmp_path / "promedus.uai")
    with open(path, "w") as fh:
        fh.write(write_model(m))
    with open(path + ".evid", "w") as fh:
        fh.write(write_evidence(evidence))
    m.apply_evidence(evidence)
    return path, m


def test_promedus_headroom_caps_go_all_gather():
    for v, mode in ((520, "rowgather"), (PROMEDUS_VARS, "gather"), (916, "gather")):
        m, evidence = torch_models.promedus_like(port_pgm, seed=1, v=v)
        m.apply_evidence(evidence)
        caps = port_encode.compute_caps(m, collapse_headroom=True, slot_hint=128,
                                        headroom_factors=2)
        assert caps.base_mode == mode
        assert sweep.kernel_refusal(caps) is None and sweep.route_for(caps) == "kernel"
        assert (caps.gfac_cap > 0) == (mode == "gather")
        assert sweep.kernel_refusal(port_encode.compute_caps(m, headroom_factors=0)) is None


@pytest.mark.parametrize("how", ["mesh", "split_off"])
def test_adaptive_engine_on_promedus_headroom_caps(tmp_path, how):
    """``-s adaptive`` under a 2x2 mesh and under ``split_group="off"``
    builds one group on all-gather headroom caps: it runs on the kernel's
    gather form (here its plain version), says so, adapts and
    collapses."""
    path, m = _promedus(tmp_path)
    v = m.num_vars
    kw = dict(mesh="2x2") if how == "mesh" else dict(split_group="off")
    cfg = EngineConfig(model_path=path, device="cpu", use_evidence=True, sampler="adaptive",
                       burnin=v * 4, converge_window=v * 6, chains=2, chains_per_variant=8,
                       chain_adds=2, reserve_slots=4,
                       max_iters=int(m.free_mask.sum()) * 8 * 6 * 2 * 3, max_secs=600.0, seed=7, status_secs=1e-6, anneal_stages=2, **kw)
    lines = []
    res = Engine(cfg, log=lines.append, devices=["cpu"] * 4 if how == "mesh" else None).run()
    route = [ln for ln in lines if ln.startswith("sweep route:")]
    assert route == ["sweep route: kernel, gather form (gfac_cap=10) on cpu, as its plain "
                     "version window_ops"]
    assert any("device mesh" in ln for ln in lines) == (how == "mesh")
    assert not any("split group" in ln for ln in lines)
    assert any(ln.startswith("ADAPT: ") for ln in lines)
    assert res.collapsed and res.variants > 2 and res.kernel
    assert np.isfinite(res.marginals).all()
    np.testing.assert_allclose(res.marginals.sum(axis=1), 1.0, rtol=1e-9)


def test_promedus_group_builds_and_advances_at_full_width():
    """The 916-var net's headroom group, plain and under a 2x2 mesh: both
    build, take the kernel route with compact gather lists and advance to
    the same state."""
    m, evidence = torch_models.promedus_like(port_pgm, seed=1)
    m.apply_evidence(evidence)
    g, p = _pair(m, "2x2", cpv=4, cw=2, collapse_headroom=True, max_variants=64)
    assert p.caps.gfac_cap == 10 and p.caps.adj_cap == 0 and p.caps.oa_cap == 1
    for x in (g, p):
        assert x.route == "kernel"
        x.add_variants([m, m])
        x.advance()
    kst = p.kstack.tensors[p.device]
    assert gibbs_cuda.uses_gather(kst) and set(sweep.COMPACT_KEYS) <= set(kst)
    assert torch.equal(g.state, p.state) and torch.equal(g.halves, p.halves)
    assert p.total_samples == 2 * 4 * 2 * int(m.free_mask.sum())


def test_engine_reports_the_kernel_route(tmp_path):
    """A run whose caps pass the kernel's gate reports ``kernel=True`` and
    logs no route line (on the CPU that route is the plain version)."""
    from tests.test_torch_engine import _write_net

    path, _ = _write_net(tmp_path, "grid3")
    lines = []
    cfg = EngineConfig(model_path=path, device="cpu", burnin=9 * 4, converge_window=9 * 4,
                       chains=2, chains_per_variant=8, max_iters=9 * 8 * 4, seed=3)
    res = Engine(cfg, log=lines.append).run()
    assert res.kernel and not any("sweep route" in ln for ln in lines)


def test_resumed_group_takes_the_same_route(tmp_path):
    """A run on all-gather headroom caps, checkpointed after its first
    collapse and resumed: the resumed group is on the kernel's gather
    form again, holds the snapshot's variants, and goes on."""
    path, m = _promedus(tmp_path)
    v, free = m.num_vars, int(m.free_mask.sum())
    ck = str(tmp_path / "ck.npz")
    cfg = EngineConfig(model_path=path, device="cpu", use_evidence=True, sampler="adaptive",
                       burnin=v * 4, converge_window=v * 6, chains=2, chains_per_variant=8,
                       chain_adds=1, reserve_slots=4, max_iters=free * 8 * 6 * 2 * 3,
                       max_secs=600.0, seed=7, status_secs=1e-6, anneal_stages=0,
                       split_group="off", checkpoint_path=ck, checkpoint_secs=0.0)
    first = Engine(cfg, log=lambda _m: None).run()
    assert first.collapsed and first.kernel
    lines = []
    cfg2 = dataclasses.replace(cfg, resume=True, max_iters=first.samples + free * 8 * 6 * 4)
    res = Engine(cfg2, log=lines.append).run()
    assert any(ln.startswith("RESUMED") for ln in lines)
    assert sum(ln.startswith("sweep route: kernel, gather form") for ln in lines) == 1
    assert res.kernel and res.samples > first.samples
    assert set(first.collapsed) <= set(res.collapsed)


def test_ops_route_checkpoint_resumes_on_the_kernel_route(tmp_path):
    """A group on gather caps that swept by the ops route (as groups on
    such caps did before the kernel walked the gather bank) saves a
    checkpoint; it resumes onto the kernel route, with compact lists, and
    draws what the group that was never saved draws: the kernel order
    and the hash do not depend on the route."""
    from grample_tpu_torch.sampler.checkpoint import load_checkpoint, save_checkpoint

    m = torch_models.build(port_pgm, "grid4_evid")
    caps = _headroom_gather(m)
    groups = []
    for route in ("ops", "kernel"):
        g = ChainGroup(m, 32, 6, device="cpu", caps=caps, seed=4)
        g.route = route
        g.add_variants([m, collapse_var(m, 4)[0]])
        g.burn(3)
        g.advance()
        groups.append(g)
    assert "c_lists" not in groups[0].kstack.tensors[groups[0].device]
    ck = str(tmp_path / "ops.npz")
    save_checkpoint(ck, groups[0])
    resumed, _ = load_checkpoint(ck, m, device="cpu",
                                 make_group=lambda mm, **kw: ChainGroup(mm, caps=caps, **kw))
    assert resumed.route == "kernel" and gibbs_cuda.uses_gather(
        resumed.kstack.tensors[resumed.device])
    for g in (resumed, groups[1]):
        g.advance()
    assert torch.equal(resumed.state, groups[1].state)
    assert torch.equal(resumed.halves, groups[1].halves)
    np.testing.assert_array_equal(resumed.totals, groups[1].totals)
