"""The sweep kernel's compact work lists (``ops.layout``) against the dense
kernel-order tensors they are derived from.

``walk_window`` is a slow walker of the compact lists that indexes them
exactly as the CUDA kernel does (cursors over sites, incidences and scope
entries of both banks; dense state rows; ragged tables; the cut flat
table) and shares only the draw's arithmetic with the plain versions.  It
must equal ``window_plain`` on dense encodings and ``window_ops`` on
encodings with a gather bank, bit for bit: that proves the kernel's
indexing on the CPU.
"""

import numpy as np
import pytest
import torch

import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
from grample_tpu_torch.ops import gibbs_cuda, layout, sweep
from grample_tpu_torch.ops.gibbs_bank import window_ops
from grample_tpu_torch.ops.gibbs_torch import (
    _hash, draw, sweep_counter, window_cell, window_plain)
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.sampler.collapse import collapse_var

from tests import torch_models

HEADROOM = ("grid4", "rand8", "star8_aux")


def _encs(name):
    """Encodings of case ``name``: a model of ``torch_models.MODELS`` at
    its plain caps stacked twice, a wide collapse variant, a
    collapse-headroom case, or a case with a gather bank
    (``torch_models.GATHER_CASES``)."""
    if name in torch_models.GATHER_CASES:
        variants, caps = torch_models.gather_variants(port_pgm, name)
    elif name in HEADROOM:
        variants, caps, _ = torch_models.headroom_variants(port_pgm, name)
    elif name in torch_models.WIDE:
        variants = [torch_models.collapsed(port_pgm, name)[1]] * 2
        caps = port_encode.caps_for_variants(variants, slot_hint=2)
    else:
        m = torch_models.build(port_pgm, name)
        variants, caps = [m, m], port_encode.compute_caps(m, headroom_factors=0)
    return [port_encode.encode_model(v, caps) for v in variants]


def _inputs(name, chains, seed=3):
    """Sweep tensors of case ``name`` and a valid kernel-order state."""
    encs = _encs(name)
    kst = sweep.sweep_tensors(port_encode.stack_variants(encs), "cpu")
    oon = kst["pal_oon"].numpy()
    rng = np.random.default_rng(seed)
    cards = np.stack([e.cards for e in encs])[np.arange(len(encs))[:, None], oon]
    fixed = np.stack([e.fixed for e in encs])[np.arange(len(encs))[:, None], oon]
    st = np.floor(rng.random((len(encs), oon.shape[1], chains)) * cards[:, :, None])
    st = np.where(fixed[:, :, None] >= 0, fixed[:, :, None], st)
    return kst, torch.as_tensor(st.astype(np.int32))


def _sections(blob):
    """(color_end, sites [L, 2], incs [I, 2], scope [Q]) of one blob."""
    h = blob.astype(np.int64) & 0xFFFFFFFF
    n_sites, n_incs, n_scope = (int(h[i]) for i in (layout.H_SITES, layout.H_WALK_INCS,
                                                    layout.H_WALK_SCOPE))
    off = [int(h[i]) for i in (layout.H_OFF_COLOR, layout.H_OFF_SITES,
                               layout.H_OFF_INCS, layout.H_OFF_SCOPE)]
    color_end = h[off[0]:off[1]]  # the padding of the section is cut by NC below
    sites = h[off[1]:off[1] + 2 * n_sites].reshape(-1, 2)
    incs = h[off[2]:off[2] + 2 * n_incs].reshape(-1, 2)
    return color_end, sites, incs, h[off[3]:off[3] + n_scope]


def _gather_sections(blob):
    """(gsites [L], gincs [Ig, 4], gscope [Qg, 2]) of one blob."""
    h = blob.astype(np.int64)
    n_sites, n_gincs, n_gscope = (int(h[i]) for i in (layout.H_SITES, layout.H_GINCS,
                                                      layout.H_GSCOPE))
    gs, gi, gq = (int(h[i]) for i in (layout.H_OFF_GSITES, layout.H_OFF_GINCS,
                                      layout.H_OFF_GSCOPE))
    gsites = h[gs:gs + n_sites] if gi > gs else h[gs:gs]  # empty without a gather bank
    return gsites, h[gi:gi + 4 * n_gincs].reshape(-1, 4), h[gq:gq + 2 * n_gscope].reshape(-1, 2)


class _Walker:
    """Variant ``ni``'s compact lists and a chain state [R, C] over its
    kept rows, walked site by site with the kernel's cursors."""

    def __init__(self, kst, ni, state_ni):
        blob = kst["c_lists"][ni].numpy()
        self.K = kst["k_kmask"].shape[3]
        self.color_end, self.sites, self.incs, self.scope = _sections(blob)
        self.gsites, self.gincs, self.gscope = _gather_sections(blob)
        self.rows = kst["c_rows"][ni].numpy()
        used, gtab0 = int(blob[layout.H_WALK_FLOATS]), int(blob[layout.H_GTAB0])
        self.flat = kst["c_tables"][ni, :used]
        self.tabs = self.flat[:gtab0].reshape(-1, self.K)
        self.n_sites = int(blob[layout.H_SITES])
        n_rows = int(blob[layout.H_ROWS])
        self.sm = state_ni[torch.as_tensor(self.rows[:n_rows].astype(np.int64))].clone()
        self.inc = self.q = self.ginc = self.gq = 0

    def logits(self, site):
        """[C, K] logits of live site ``site``: its dense incidences
        summed in order, then its gather incidences summed into a second
        accumulator (in-card outcomes only) and added; the cursors move
        past the site's entries."""
        C, K = self.sm.shape[1], self.K
        lg = torch.zeros((C, K), dtype=torch.float32)
        while self.inc < self.sites[site, 1]:
            trow = torch.full((C,), int(self.incs[self.inc, 0]), dtype=torch.int64)
            while self.q < self.incs[self.inc, 1]:
                e = int(self.scope[self.q])
                trow += self.sm[e & 0xFFFF].long() * (e >> 16)
                self.q += 1
            lg = lg + self.tabs[trow]
            self.inc += 1
        if self.gsites.size:
            km = int(self.sites[site, 0]) >> 16
            ga = torch.zeros((C, K), dtype=torch.float32)
            while self.ginc < self.gsites[site]:
                off, self_stride, end, _ = (int(x) for x in self.gincs[self.ginc])
                base = torch.zeros(C, dtype=torch.int32)
                while self.gq < end:
                    row, stride = (int(x) for x in self.gscope[self.gq])
                    base += self.sm[row] * stride  # int32, as the kernel
                    self.gq += 1
                for kk in range(K):
                    if (km >> kk) & 1:
                        ga[:, kk] = ga[:, kk] + self.flat[(off + base + kk * self_stride).long()]
                self.ginc += 1
            lg = lg + ga
        return lg


def walk_window(kst, state, seed, num_sweeps, half_point, count, cb):
    """One window from the compact lists, as the CUDA kernel walks them:
    a draw counts its outcome only where it is not 0, and each live
    site's outcome-0 count in a half is the half's sweeps less its other
    outcomes' counts, stored once after the sweeps."""
    n, nc, G, K = kst["k_kmask"].shape
    C = state.shape[2]
    counts = torch.zeros((n, 2, K, nc * G, C), dtype=torch.int32) if count else None
    chain = torch.arange(C, dtype=torch.int64)
    lanes = chain[None, :] % cb
    for ni in range(n):
        w = _Walker(kst, ni, state[ni])
        cell = window_cell(seed, ni, chain // cb)
        for si in range(num_sweeps):
            hsel = int(si >= half_point)
            w.inc = w.q = w.ginc = w.gq = 0
            site = 0
            for ci in range(nc):
                counter = sweep_counter(cell, si, nc, ci)[None, :]
                while site < w.color_end[ci]:
                    gi, km = int(w.sites[site, 0]) & 0xFFFF, int(w.sites[site, 0]) >> 16
                    lg = w.logits(site)
                    mk = torch.tensor([[float((km >> kk) & 1) for kk in range(K)]])
                    unif = _hash(torch.tensor([[gi]]), lanes, counter)
                    newv = draw(lg[None], mk, unif)[0]
                    w.sm[site] = newv
                    if count:
                        drawn = newv != 0
                        counts[ni, hsel, newv[drawn].long(), ci * G + gi, chain[drawn]] += 1
                    site += 1
        if count:
            n0 = min(max(half_point, 0), num_sweeps)
            for ci in range(nc):
                for site in range(int(w.color_end[ci - 1]) if ci else 0, int(w.color_end[ci])):
                    slot = ci * G + (int(w.sites[site, 0]) & 0xFFFF)
                    for h, sweeps in enumerate((n0, num_sweeps - n0)):
                        if sweeps:
                            c = counts[ni, h, :, slot]  # [K, C]
                            c[0] = sweeps - c[1:].sum(dim=0)
        state[ni][torch.as_tensor(w.rows[:w.n_sites].astype(np.int64))] = w.sm[:w.n_sites]
    return state, counts


def walk_logits(kst, state, ni, ci):
    """[G, C, K] logits of colour ``ci`` of variant ``ni`` at kernel-order
    state ``state`` [N, NVp, C] by the compact lists (in-card outcomes of
    live rows; 0 elsewhere)."""
    G, K = kst["k_kmask"].shape[2:]
    w = _Walker(kst, ni, state[ni])
    out = torch.zeros((G, state.shape[2], K), dtype=torch.float32)
    for site in range(int(w.color_end[ci])):
        lg = w.logits(site)
        if site >= (w.color_end[ci - 1] if ci else 0):
            out[int(w.sites[site, 0]) & 0xFFFF] = lg
    return out


CASES = sorted(torch_models.MODELS) + sorted(torch_models.WIDE) + list(HEADROOM)


@pytest.mark.parametrize("cb", [1, 8])
@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_walker_matches_plain(name, count, cb):
    """State on every row and counts on every slot, bit for bit, after a
    3-sweep window with the half point at 1."""
    kst, state = _inputs(name, chains=24)
    sw, cw = walk_window(kst, state.clone(), -77, 3, 1, count, cb)
    sp, cp = window_plain(*[kst[k] for k in sweep.KERNEL_KEYS], state.clone(),
                          -77, 3, 1, count, cb)
    assert torch.equal(sw, sp)
    if not count:
        assert cw is None and cp is None
        return
    assert torch.equal(cw, cp)
    live = kst["k_kmask"].bool().any(dim=3).reshape(len(sw), -1)  # [N, NSLOT]
    per_slot = cp.sum(dim=(1, 2))  # [N, NSLOT, C]
    assert torch.equal(per_slot, (3 * live.to(torch.int32))[:, :, None].expand_as(per_slot))


@pytest.mark.parametrize("cb", [1, 8])
@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("name", torch_models.GATHER_CASES)
def test_walker_matches_window_ops(name, count, cb):
    """On encodings with a gather bank the walker equals ``window_ops``
    (the gather form's plain version): state on every row and counts on
    every slot, bit for bit, after a 3-sweep window with the half point
    at 1."""
    kst, state = _inputs(name, chains=24)
    assert gibbs_cuda.uses_gather(kst)
    assert int(layout.compact_counts(kst["c_lists"].numpy())[:, 5].min()) > 0
    sw, cw = walk_window(kst, state.clone(), -77, 3, 1, count, cb)
    so, co = window_ops(kst, state.clone(), -77, 3, 1, count, cb)
    assert torch.equal(sw, so)
    if not count:
        assert cw is None and co is None
        return
    assert torch.equal(cw, co)
    live = kst["k_kmask"].bool().any(dim=3).reshape(len(sw), -1)  # [N, NSLOT]
    per_slot = co.sum(dim=(1, 2))  # [N, NSLOT, C]
    assert torch.equal(per_slot, (3 * live.to(torch.int32))[:, :, None].expand_as(per_slot))


@pytest.mark.parametrize("half_point", [0, 2, 3, 5])
@pytest.mark.parametrize("name", ["grid4_evid", "grid3_card3_evid", "rand8_card4",
                                  torch_models.GATHER_CASES[0]])
def test_walker_derives_rest_at_every_half_point(name, half_point):
    """Outcome 0's counts derived after the sweeps (the kernel's
    ``derive_rest``) equal the plain version's counted ones, bit for bit,
    with the half point at the window's start, inside it, at its end and
    past it (a half that counts no sweep keeps 0)."""
    kst, state = _inputs(name, chains=16)
    plain = (window_ops if gibbs_cuda.uses_gather(kst) else
             lambda kst, *a: window_plain(*[kst[k] for k in sweep.KERNEL_KEYS], *a))
    sw, cw = walk_window(kst, state.clone(), 13, 3, half_point, True, 8)
    sp, cp = plain(kst, state.clone(), 13, 3, half_point, True, 8)
    assert torch.equal(sw, sp) and torch.equal(cw, cp)
    live = kst["k_kmask"].bool().any(dim=3).reshape(len(sw), -1, 1).to(torch.int32)
    per_half = cw.sum(dim=2)  # [N, 2, NSLOT, C]
    for h, sweeps in enumerate((min(half_point, 3), 3 - min(half_point, 3))):
        assert torch.equal(per_half[:, h], (sweeps * live).expand_as(per_half[:, h]))


def _gather_live(kst, i):
    """Live (gather incidences [NC, G, Fg], gather scope entries
    [NC, G, Fg, S]) of variant ``i`` by the rule of ``ops.layout``."""
    site = kst["k_kmask"][i].bool().any(dim=2)
    inc = kst["gb_mask"][i].bool() & site[..., None]
    return inc, (kst["gb_scope_strides"][i] > 0) & inc[..., None]


@pytest.mark.parametrize("name", torch_models.GATHER_CASES)
def test_gather_lists_follow_the_rule(name):
    """The gather sections list every live gather incidence and scope
    entry in order, with its self stride, stride and kernel row, and
    each incidence's stretch of the cut flat table equals the flat
    table's from its offset, as far as its outcomes and strides reach."""
    kst, _ = _inputs(name, chains=1)
    got = layout.compact_counts(kst["c_lists"].numpy())
    row_cards = np.stack([e.cards for e in _encs(name)])[
        np.arange(got.shape[0])[:, None], kst["pal_oon"].numpy()]
    for i in range(got.shape[0]):
        inc, sc = _gather_live(kst, i)
        assert (got[i, 5], got[i, 6]) == (int(inc.sum()), int(sc.sum()))
        blob = kst["c_lists"][i].numpy()
        gsites, gincs, gscope = _gather_sections(blob)
        rows = kst["c_rows"][i].numpy()
        np.testing.assert_array_equal(rows[gscope[:, 0]], kst["gb_scope_vars"][i][sc].numpy())
        np.testing.assert_array_equal(gscope[:, 1], kst["gb_scope_strides"][i][sc].numpy())
        np.testing.assert_array_equal(gincs[:, 1], kst["gb_self_stride"][i][inc].numpy())
        np.testing.assert_array_equal(np.diff(gsites, prepend=0),
                                      inc[kst["k_kmask"][i].bool().any(dim=2)].sum(dim=1).numpy())
        flat, cut = kst["tables"][i].numpy(), kst["c_tables"][i].numpy()
        assert (gincs[:, 0] >= blob[layout.H_GTAB0]).all()
        card = kst["k_kmask"][i].sum(dim=2)[..., None].expand_as(inc)[inc].numpy()
        scope_rows, strides = kst["gb_scope_vars"][i][inc].numpy(), kst["gb_scope_strides"][i][inc].numpy()
        reach = (1 + ((row_cards[i][scope_rows] - 1) * strides).sum(axis=1)
                 + (card - 1) * gincs[:, 1])
        for j, off in enumerate(kst["gb_offset"][i][inc].numpy()):
            np.testing.assert_array_equal(cut[gincs[j, 0]:gincs[j, 0] + reach[j]],
                                          flat[off:off + reach[j]])


def test_gather_counts_of_the_smoke_shape():
    """The Promedus-shaped net at the single adaptive group's headroom
    caps (all-gather: the 4h encoding of the smoke run): its live gather
    work, and the cut flat table against the whole."""
    m, evidence = torch_models.promedus_like(port_pgm, seed=1)
    m.apply_evidence(evidence)
    caps = port_encode.compute_caps(m, collapse_headroom=True, slot_hint=128, headroom_factors=2)
    assert caps.base_mode == "gather" and sweep.kernel_refusal(caps) is None
    kst = layout.kernel_stack(port_encode.stack_variants([port_encode.encode_model(m, caps)]))
    got = layout.compact_counts(kst["c_lists"])[0]
    assert tuple(got[[0, 2, 3, 5, 6]]) == (870, 0, 0, 1742, 2353)
    assert got[4] < caps.table_cap


@pytest.mark.parametrize("name", ["grid4_gather", "wide12_mixed"])
def test_gather_lists_in_slot_writes_and_scaling(name):
    """A group on gather caps writes new variants' compact lists slot-wise
    equal to a restack of all its encodings, and scaling its tables
    (dense, compact and flat) equals compacting the scaled tables."""
    variants, caps = torch_models.gather_variants(port_pgm, name)
    g = ChainGroup(variants[0], chains_per_variant=8, converge_window=4, device="cpu", seed=1,
                   caps=caps)
    assert g.route == "kernel"
    g.reserve(4)
    g.add_variants(variants[:2])
    g.add_variants(variants[2:] or variants[:1])
    kst = g.kstack.tensors[g.device]
    assert gibbs_cuda.uses_gather(kst) and set(layout.COMPACT_KEYS) <= set(kst)
    want = sweep.sweep_tensors(port_encode.stack_variants(g.encs), "cpu")
    assert set(want) == set(g.kstack.tensors[g.device])
    n = len(g.encs)
    for key, w in want.items():
        got = g.kstack.tensors[g.device][key][:n]
        if key in layout.COMPACT_KEYS:
            assert got.shape[1] >= w.shape[1] and not got[:, w.shape[1]:].any()
            got = got[:, :w.shape[1]]
        assert torch.equal(got, w), key
    scaled = sweep.scale_tables(want, 0.25)
    dense = {k: scaled[k].numpy() for k in (*sweep.KERNEL_KEYS, "pal_oon", *layout.GATHER_KEYS,
                                            "gb_scope_vars", "tables")}
    again = layout.compact_stack(dense, np.stack([e.cards for e in g.encs]))
    for key in layout.COMPACT_KEYS:
        np.testing.assert_array_equal(scaled[key].numpy(), again[TEMPERED.get(key, key)])
    assert not torch.equal(scaled["c_tables"], want["u_tables"])
    g.burn_annealed(4, stages=2)
    assert g.advance(4) == 4 * 8 * sum(int(v.free_mask.sum()) for v in g.variants)


def test_caps_growth_into_the_gather_bank_rebuilds_the_lists():
    """A group on dense caps that a variant grows into the gather bank (a
    12-var factor beyond the dense threshold of 32 rows) stays on the
    kernel route and restacks with compact gather lists equal to those
    of its encodings."""
    m = torch_models.wide_factor(port_pgm, 12, seed=2)
    unaries = port_pgm.DiscreteModel(type="MARKOV", cards=[2] * 12, factors=m.factors[1:])
    caps = port_encode.compute_caps(unaries, headroom_factors=0, oa_dense_cap=32)
    g = ChainGroup(unaries, chains_per_variant=8, converge_window=4, device="cpu", seed=1,
                   caps=caps)
    g.add_variants([unaries])
    assert g.route == "kernel" and not gibbs_cuda.uses_gather(g.kstack.tensors[g.device])
    g.add_variants([m])
    assert g.caps.gfac_cap > 0 and g.route == "kernel"
    assert gibbs_cuda.uses_gather(g.kstack.tensors[g.device])
    want = sweep.sweep_tensors(port_encode.stack_variants(g.encs), "cpu")
    for key in layout.COMPACT_KEYS:
        got = g.kstack.tensors[g.device][key][:, :want[key].shape[1]]
        assert torch.equal(got, want[key]), key
    assert layout.compact_counts(g.kstack.tensors[g.device]["c_lists"].numpy())[1, 5] == 12
    g.burn(2)
    assert g.advance(2) == 2 * 8 * 2 * 12


def _dense_live(kst, i):
    """Live (rows, incidences, scope entries) of variant ``i`` by the rule
    of ``ops.layout``, counted on the dense tensors."""
    site = kst["k_kmask"][i].any(dim=2)  # [NC, G]
    inc = (kst["k_tables"][i].abs().amax(dim=(3, 4)) > 0) & site[..., None]
    sc = (kst["k_strides"][i] > 0) & inc[..., None]
    return int(site.sum()), int(inc.sum()), int(sc.sum())


@pytest.mark.parametrize("name", CASES)
def test_live_counts_follow_the_rule(name):
    kst, _ = _inputs(name, chains=1)
    got = layout.compact_counts(kst["c_lists"].numpy())
    for i in range(got.shape[0]):
        assert tuple(got[i, [0, 2, 3]]) == _dense_live(kst, i)
    dead_rows = kst["k_kmask"].shape[1] * kst["k_kmask"].shape[2] - got[:, 0]
    if name in HEADROOM:
        assert (dead_rows > 0).all() and (got[:, 2] < kst["k_tables"][0, ..., 0, 0].numel()).all()


@pytest.mark.parametrize("net,want", [
    ("grid10", (97, 449, 352)),
    ("promedus", (870, 1742, 2353)),
])
def test_live_counts_of_the_smoke_shapes(net, want):
    """The live work of the smoke run's 10x10 grid and Promedus-shaped net
    at their plain caps, per variant."""
    if net == "grid10":
        models, caps = torch_models.grid10_variants(port_pgm)
        m = models[0]
    else:
        m, evidence = torch_models.promedus_like(port_pgm, seed=1)
        m.apply_evidence(evidence)
        caps = port_encode.compute_caps(m, headroom_factors=0)
    kst = layout.kernel_stack(port_encode.stack_variants([port_encode.encode_model(m, caps)]))
    got = layout.compact_counts(kst["c_lists"])[0]
    assert tuple(got[[0, 2, 3]]) == want
    assert got[4] * 4 < kst["k_tables"].nbytes


def _merged_form(dense, row_cards, K):
    """(table [R, K], rows, strides) of a site's merged table from its
    live dense incidences ``dense`` [(table [OA, K], scope rows,
    strides)]: its blanket's distinct rows, first seen in order, C-order
    strides over their cards, and each blanket configuration's sum of the
    incidences' rows, in float32 from 0.0, one incidence at a time."""
    blanket = list(dict.fromkeys(r for _, rs, _ in dense for r in rs.tolist()))
    cards = [int(row_cards[r]) for r in blanket]
    strides = [int(np.prod(cards[j + 1:], dtype=np.int64)) for j in range(len(cards))]
    table = np.zeros((int(np.prod(cards, dtype=np.int64)), K), dtype=np.float32)
    for r in range(table.shape[0]):
        val = {b: (r // st) % c for b, st, c in zip(blanket, strides, cards)}
        acc = np.zeros(K, dtype=np.float32)
        for tab, rs, st in dense:
            acc = acc + tab[sum(val[x] * y for x, y in zip(rs.tolist(), st.tolist()))]
        table[r] = acc
    return table, np.array(blanket, dtype=np.int64), np.array(strides, dtype=np.int64)


def _site_walks(kst, i, cards):
    """Per live site of variant ``i`` (its cards ``cards`` [V+1] by old
    var id), in list order: its
    walked incidences [(table rows, scope rows, strides)] read from the
    compact lists, and what the dense tensors give it: its live dense
    incidences [(table [OA, K], scope rows, strides)] and, where the merge
    rule admits the site (``MERGE_MAX_ROWS``), its ``_merged_form``."""
    blob = kst["c_lists"][i].numpy()
    _, sites, incs, scope = _sections(blob)
    K = kst["k_kmask"].shape[3]
    rows = kst["c_rows"][i].numpy()
    tabs = kst["c_tables"][i].numpy()[:int(blob[layout.H_GTAB0])].reshape(-1, K)
    first = np.append(incs[:, 0], tabs.shape[0])
    row_cards = np.asarray(cards)[kst["pal_oon"][i].numpy()]
    live = kst["k_kmask"][i].bool().any(dim=2).numpy()
    real = (kst["k_tables"][i].abs().amax(dim=(3, 4)) > 0).numpy()
    out, inc, q = [], 0, 0
    for site, (ci, g) in enumerate(zip(*np.nonzero(live))):
        walked = []
        for j in range(inc, int(sites[site, 1])):
            e = scope[q:int(incs[j, 1])]
            q = int(incs[j, 1])
            walked.append((tabs[first[j]:first[j + 1]], rows[e & 0xFFFF], e >> 16))
        inc = int(sites[site, 1])
        dense = []
        for f in np.flatnonzero(real[ci, g]):
            st = kst["k_strides"][i][ci, g, f].numpy().astype(np.int64)
            dense.append((kst["k_tables"][i][ci, g, f].numpy(),
                          kst["k_scope"][i][ci, g, f].numpy()[st > 0], st[st > 0]))
        blanket = {r for _, rs, _ in dense for r in rs.tolist()}
        admit = dense and np.prod([row_cards[r] for r in blanket]) <= layout.MERGE_MAX_ROWS
        out.append((walked, dense, _merged_form(dense, row_cards, K) if admit else None))
    return out


@pytest.mark.parametrize("name", CASES)
def test_row_renumbering_round_trips(name):
    """``c_rows`` lists the live sites' slots first, in list order, then
    the tail rows read; it has no repeats, every scope word points inside
    it at the kernel row the dense tensors name (a merged site's: its
    blanket's rows, at their mixed-radix strides), and kernel -> dense ->
    kernel is the identity on those rows."""
    kst, _ = _inputs(name, chains=1)
    n, nc, G, _ = kst["k_kmask"].shape
    for i in range(n):
        blob = kst["c_lists"][i].numpy()
        color_end, sites, incs, scope = _sections(blob)
        n_sites, n_rows = int(blob[layout.H_SITES]), int(blob[layout.H_ROWS])
        rows = kst["c_rows"][i].numpy()[:n_rows]
        assert np.unique(rows).size == n_rows
        ci = np.searchsorted(color_end[:nc], np.arange(n_sites), side="right")
        np.testing.assert_array_equal(rows[:n_sites], ci * G + (sites[:, 0] & 0xFFFF))
        assert (rows[n_sites:] >= nc * G).all()
        dense_of = np.full(kst["pal_oon"].shape[1], -1)
        dense_of[rows] = np.arange(n_rows)
        np.testing.assert_array_equal(rows[dense_of[rows]], rows)
        assert (scope & 0xFFFF < n_rows).all()
        for walked, dense, merged in _site_walks(kst, i, _encs(name)[i].cards):
            want = [merged] if merged is not None else dense
            assert len(walked) == len(want)
            for (_, rs, st), (_, want_rs, want_st) in zip(walked, want):
                np.testing.assert_array_equal(rs, want_rs)
                np.testing.assert_array_equal(st, want_st)


@pytest.mark.parametrize("name", CASES)
def test_ragged_tables_keep_every_reachable_row(name):
    """Each walked incidence of an unmerged site keeps the first rows of
    its dense table, as many as its strides can reach, and the rows it
    drops are all zero; a merged site's one table is its blanket's
    left-to-right sums (``_merged_form``), bit for bit; the sites on
    merged tables are those the rule admits."""
    kst, _ = _inputs(name, chains=1)
    for i in range(kst["c_lists"].shape[0]):
        tabs = kst["c_tables"][i].numpy()
        used = int(kst["c_lists"][i, layout.H_WALK_FLOATS])
        n_merged = 0
        for walked, dense, merged in _site_walks(kst, i, _encs(name)[i].cards):
            if merged is not None:
                n_merged += 1
                assert len(walked) == 1 and walked[0][0].shape == merged[0].shape
                assert walked[0][0].tobytes() == merged[0].tobytes()
                continue
            assert len(walked) == len(dense)
            for (tab, _, _), (full, _, _) in zip(walked, dense):
                np.testing.assert_array_equal(tab, full[:tab.shape[0]])
                assert not full[tab.shape[0]:].any()
        assert n_merged == int(kst["c_lists"][i, layout.H_MERGED])
        assert not tabs[used:].any()


#: the compact lists a scaled stack walks: the unmerged ones
TEMPERED = {"c_lists": "u_lists", "c_tables": "u_tables"}


def _scaled_against_compacted(name, beta):
    """``scale_tables`` at ``beta`` on case ``name``'s sweep tensors
    against compacting its scaled dense tables: the scaled stack walks
    the unmerged lists on scaled tables."""
    kst, _ = _inputs(name, chains=1)
    scaled = sweep.scale_tables(kst, beta)
    dense = {k: scaled[k].numpy() for k in ("k_scope", "k_strides", "k_tables", "k_kmask",
                                            "pal_oon")}
    encs = _encs(name)
    again = layout.compact_stack(dense, np.stack([e.cards for e in encs]))
    for key in layout.COMPACT_KEYS:
        np.testing.assert_array_equal(scaled[key].numpy(), again[TEMPERED.get(key, key)])
    return kst, scaled


@pytest.mark.parametrize("name", ["grid4_evid", "star8_c0", "star8_aux"])
def test_beta_scaled_compact_tables(name):
    """Scaling the compact tables equals compacting the scaled dense
    tables (the tempered burn-in scales both), with no site merged."""
    kst, scaled = _scaled_against_compacted(name, 0.25)
    assert not torch.equal(scaled["c_tables"], kst["u_tables"])


@pytest.mark.parametrize("name", ["grid4_evid", "star8_c0", "star8_aux"])
def test_tempered_windows_walk_the_unmerged_lists(name):
    """At a beta that is no power of two a merged row's scaled sum rounds
    apart from the sum of its scaled rows, so the scaled stack walks the
    unmerged lists: a window on it is the plain version's on the scaled
    dense tables, bit for bit."""
    kst, scaled = _scaled_against_compacted(name, 0.3)
    assert int(layout.walk_counts(kst["c_lists"].numpy())[:, 3].sum()) > 0
    assert not layout.walk_counts(scaled["c_lists"].numpy())[:, 3].any()
    _, state = _inputs(name, chains=16)
    sw, cw = walk_window(scaled, state.clone(), 11, 3, 1, True, 8)
    sp, cp = window_plain(*[scaled[k] for k in sweep.KERNEL_KEYS], state.clone(), 11, 3, 1,
                          True, 8)
    assert torch.equal(sw, sp) and torch.equal(cw, cp)


def test_slot_write_equals_restack():
    """Collapse variants written slot-wise into a stacked group (their
    lists and tables outgrow the plain slots' capacity) leave the group's
    tensors equal to a stack of all its encodings."""
    m = torch_models.build(port_pgm, "star10")
    g = ChainGroup(m, chains_per_variant=8, converge_window=4, device="cpu", seed=1,
                   collapse_headroom=True)
    g.reserve(4)
    g.add_variants([m, m])
    before = {k: g.kstack.tensors[g.device][k].shape[1] for k in layout.COMPACT_KEYS}
    g.add_variants([collapse_var(m, 0)[0]])
    g.add_variants([collapse_var(m, 3)[0]])
    assert g.kstack.tensors[g.device]["c_tables"].shape[1] > before["c_tables"]
    want = sweep.sweep_tensors(port_encode.stack_variants(g.encs), "cpu")
    assert set(want) == set(g.kstack.tensors[g.device])
    for key, w in want.items():
        got = g.kstack.tensors[g.device][key]
        if key in layout.COMPACT_KEYS:
            assert got.shape[1] >= w.shape[1] and not got[:, w.shape[1]:].any()
            got = got[:, :w.shape[1]]
        assert torch.equal(got, w), key
    # and the group still advances through them
    g.burn_annealed(4, stages=2)
    assert g.advance(4) == 4 * 8 * sum(int(v.free_mask.sum()) for v in g.variants)


def test_compact_capacities_are_padded():
    kst, _ = _inputs("rand8", chains=1)
    counts = layout.compact_counts(kst["c_lists"].numpy())
    assert kst["c_lists"].shape[1] % 4 == 0 and kst["c_tables"].shape[1] % 4 == 0
    assert kst["c_lists"].shape[1] == layout.compact_capacity(
        "c_lists", kst["c_lists"][:, layout.H_WORDS].max())
    assert kst["c_rows"].shape[1] == layout.compact_capacity("c_rows", counts[:, 1].max())
    assert kst["c_tables"].shape[1] == layout.compact_capacity(
        "c_tables", layout.walk_counts(kst["c_lists"].numpy())[:, 2].max())
    assert not (counts[0] == counts[2]).all()  # a plain slot and a collapse variant


def _shapes(n, rows, k, lists, tables):
    """Sweep tensors of the given shapes (``plan_launch`` reads no data)."""
    return {"c_lists": torch.zeros((n, lists), dtype=torch.int32),
            "c_tables": torch.zeros((n, tables)), "c_rows": torch.zeros((n, rows), dtype=torch.int32),
            "k_kmask": torch.zeros((n, 2, 4, k), dtype=torch.uint8)}


@pytest.mark.parametrize("case,want", [
    # the 10x10 grid, 2 x 131072 chains: 256, 512 and 1024 threads all keep
    # 64 warps an SM resident; the widest wins
    ("grid", (False, 1024, True, True)),
    # 8 aux variants x 256 chains: a thread per chain would leave most SMs
    # idle, so site-parallel; 8 chains a block put blocks on every SM
    ("aux", (True, 256, True, True)),
    # 12 aux variants: 8 chains a block would leave a third of them waiting
    ("aux12", (True, 512, True, True)),
    # full-card launches on a Promedus-shaped net: one 1024-thread block per
    # SM, lists and tables staged once
    ("promedus", (False, 1024, True, True)),
    # 2 x 8192 chains are 4 warps an SM as threads: site-parallel, 32 chains
    # a block keep the most warps resident
    ("main_5b", (True, 1024, True, True)),
    # 8 x 8192 chains fill the card as threads
    ("main_8", (False, 256, True, True)),
    # lists too long for shared memory stay in device memory, tables with
    # them; the state alone lets narrower blocks keep more warps resident
    ("long_lists", (False, 128, False, False)),
    ("big_tables", (False, 1024, True, False)),
    # a packed state too large for wide blocks narrows them
    ("many_rows", (False, 64, False, False)),
])
def test_plan_launch_rules(case, want):
    kst, c = {
        "grid": (_shapes(2, 128, 2, 2048, 2048), 131072),
        "aux": (_shapes(8, 928, 2, 8192, 10240), 256),
        "aux12": (_shapes(12, 928, 2, 8192, 10240), 256),
        "promedus": (_shapes(8, 928, 2, 8192, 14336), 16384),
        "main_5b": (_shapes(2, 928, 2, 8192, 10240), 8192),
        "main_8": (_shapes(8, 928, 2, 8192, 10240), 8192),
        "long_lists": (_shapes(2, 1024, 2, 70000, 4096), 131072),
        "big_tables": (_shapes(2, 512, 2, 4096, 50000), 131072),
        "many_rows": (_shapes(2, 24000, 2, 400000, 4096), 131072),
    }[case]
    for count in (True, False):
        plan = gibbs_cuda.plan_launch(kst, c, count, sm_count=132)
        assert (plan.sites, plan.threads, plan.stage_lists, plan.stage_tables) == want
        assert plan.count == count and plan.smem <= gibbs_cuda.MAX_SMEM_BYTES
        rows = kst["c_rows"].shape[1]
        assert plan.state_bytes == (plan.threads // 32 * rows if plan.sites else
                                    gibbs_cuda.state_bytes(rows, 2, plan.threads))
    # either form can be asked for by name
    assert gibbs_cuda.plan_launch(kst, c, True, 132, sites=not want[0]).sites != want[0]


@pytest.mark.parametrize("k,sites,want", [
    (2, False, 1024), (16, False, 512), (8, False, 1024), (16, True, 512),
])
def test_plan_launch_gather_form(k, sites, want):
    """An encoding with a gather bank launches the gather form, whose
    blocks stay within its launch bound: 512 threads at card bound 16,
    where two 16-logit accumulators share a thread's registers."""
    kst = _shapes(2, 928, k, 8192, 8192)
    kst["gb_offset"] = torch.zeros((2, 2, 4, 3), dtype=torch.int32)
    plan = gibbs_cuda.plan_launch(kst, 131072 if not sites else 256, True, 132, sites)
    assert plan.gather and plan.sites == sites and plan.threads <= want
    assert gibbs_cuda.max_threads(k, True) == want and gibbs_cuda.max_threads(k, False) == 1024
    assert gibbs_cuda.form_name(plan).endswith(", gather bank")
    kst["gb_offset"] = kst["gb_offset"][..., :0]
    assert not gibbs_cuda.plan_launch(kst, 131072, True, 132).gather


def test_plan_launch_refuses_what_does_not_fit():
    for chains in (65536, 64):  # thread per chain, site-parallel
        with pytest.raises(ValueError, match="exceed a block's shared memory"):
            gibbs_cuda.plan_launch(_shapes(1, 65536, 16, 256, 1024), chains, True, 132)
    assert [gibbs_cuda.state_bits(k) for k in (2, 3, 4, 5, 16)] == [1, 2, 2, 4, 4]
    assert gibbs_cuda.state_words(916, 2) == 29 and gibbs_cuda.state_words(100, 3) == 7


# ---- merged tables -----------------------------------------------------------

def _unmerged(monkeypatch, build):
    """``build()`` with no site on a merged table: the rule's row bound
    patched to 0 for the call."""
    with monkeypatch.context() as mp:
        mp.setattr(layout, "MERGE_MAX_ROWS", 0)
        return build()


@pytest.mark.parametrize("name,bound", [("star10", 64), ("grid4_evid", 8), ("star6_card3_evid", 9)])
def test_merge_rule_keeps_wide_blankets(monkeypatch, name, bound):
    """A site whose merged table would have more than ``MERGE_MAX_ROWS``
    rows keeps its own incidences (the star's centre: 512 rows; the
    grid's inner sites at a bound of 8: 16 rows; the card-3 star's
    centre at 9: 243 rows), every other site with a live dense incidence
    walks one merged table, and the window is the plain version's bit for
    bit either way."""
    monkeypatch.setattr(layout, "MERGE_MAX_ROWS", bound)
    kst, state = _inputs(name, chains=16)
    kept = merged = 0
    for i in range(kst["c_lists"].shape[0]):
        for walked, dense, form in _site_walks(kst, i, _encs(name)[i].cards):
            if form is None:
                kept += bool(dense)
                assert len(walked) == len(dense)
            else:
                merged += 1
                assert len(walked) == 1 and walked[0][0].shape[0] <= bound
        assert int(kst["c_lists"][i, layout.H_MERGED]) > 0
    assert kept > 0 and merged > 0
    sw, cw = walk_window(kst, state.clone(), 5, 2, 1, True, 8)
    sp, cp = window_plain(*[kst[k] for k in sweep.KERNEL_KEYS], state.clone(), 5, 2, 1, True, 8)
    assert torch.equal(sw, sp) and torch.equal(cw, cp)


def _promedus_stack(variants=2):
    m, evidence = torch_models.promedus_like(port_pgm, seed=1)
    m.apply_evidence(evidence)
    caps = port_encode.compute_caps(m, headroom_factors=0)
    return port_encode.stack_variants([port_encode.encode_model(m, caps)] * variants)


def _plans(kst):
    """Form, threads and staging of ``plan_launch`` over launch sizes and
    forms."""
    kt = {k: torch.as_tensor(kst[k]) for k in (*layout.COMPACT_KEYS, "k_kmask")}
    return [(p.sites, p.threads, p.stage_lists, p.stage_tables)
            for c in (256, 2048, 8192, 16384, 32768, 65536, 131072)
            for sites in (None, False, True)
            for p in [gibbs_cuda.plan_launch(kt, c, True, 132, sites)]]


def test_merge_keeps_the_launch_plan(monkeypatch):
    """On the Promedus-shaped net, merging every candidate would move
    launches to other block widths (its merged tables double the staged
    bytes); the lists merge candidates in order of incidences saved per
    byte only as far as every launch keeps the form, threads and staging
    it has unmerged."""
    stack = _promedus_stack()
    dense = layout.kernel_stack(stack, compact=False)
    unmerged = _unmerged(monkeypatch, lambda: layout.kernel_stack(stack))
    kst = layout.kernel_stack(stack)
    cards = np.asarray(stack["cards"])
    every = [layout.compact_variant(dense["k_scope"][i], dense["k_strides"][i],
                                    dense["k_tables"][i], dense["k_kmask"][i],
                                    cards[i][dense["pal_oon"][i]].astype(np.int64))
             for i in range(2)]
    greedy = {key: np.stack([np.pad(p[key], (0, layout.compact_capacity(
        key, max(q[key].size for q in every)) - p[key].size)) for p in every])
        for key in layout.COMPACT_KEYS}
    greedy["k_kmask"] = dense["k_kmask"]
    n_greedy = layout.walk_counts(greedy["c_lists"])[0, 3]
    n_merged = layout.walk_counts(kst["c_lists"])[0, 3]
    assert layout.walk_counts(unmerged["c_lists"])[0, 3] == 0 < n_merged < n_greedy
    assert _plans(greedy) != _plans(unmerged)
    assert _plans(kst) == _plans(unmerged)


@pytest.mark.parametrize("net,want", [
    ("grid10", (97, 352, 97)),
    ("promedus", (1190, 2333, 746)),
])
def test_walk_counts_of_the_smoke_shapes(net, want):
    """What the kernel walks on the smoke run's shapes (the live work is
    ``test_live_counts_of_the_smoke_shapes``'s): every grid site on a
    merged table of 16 rows, one incidence a site; on the Promedus-shaped
    net, 746 of its 870 sites, as far as its launches keep their plan."""
    if net == "grid10":
        models, caps = torch_models.grid10_variants(port_pgm)
        stack = port_encode.stack_variants([port_encode.encode_model(models[0], caps)])
    else:
        stack = _promedus_stack(1)
    kst = layout.kernel_stack(stack)
    walked = layout.walk_counts(kst["c_lists"])[0]
    assert tuple(walked[[0, 1, 3]]) == want
    assert layout.merged_sites(kst)[0] == want[2]


def _pairwise(terms):
    """numpy's sum of ``terms`` [T, K] over T, column by column: pairwise
    (unrolled by 8) on contiguous float32."""
    return np.array([np.ascontiguousarray(terms[:, k]).sum() for k in range(terms.shape[1])],
                    dtype=np.float32)


def test_fold_adds_left_to_right():
    """A merged row is the left-to-right float32 sum of its terms, which
    is what the kernel's walk adds, and not numpy's pairwise sum, on a
    case where the two differ; so is a merged table of a site with twelve
    unary factors, and the window walks it as the plain version sums."""
    terms = np.array([[1.0, -1.0]] + [[2.0 ** -24, 3.0]] * 11, dtype=np.float32)
    seq = np.zeros(2, dtype=np.float32)
    for t in terms:
        seq = seq + t
    assert seq.tobytes() != _pairwise(terms).tobytes()
    out = np.zeros((3, 2), dtype=np.float32)
    layout.fold_rows(terms, np.full(12, 1), np.arange(12), np.arange(12), out)
    assert out[1].tobytes() == seq.tobytes() and not out[[0, 2]].any()

    logs = [1.0] + [2.0 ** -24] * 11
    m = port_pgm.DiscreteModel(type="MARKOV", cards=[2, 2], factors=[
        port_pgm.Factor("pair", [0, 1], np.array([1.0, 2.0, 3.0, 0.5])),
        *[port_pgm.Factor(f"u{j}", [0], np.exp(np.array([v, -3 * v]))) for j, v in
          enumerate(logs)]])
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc]), "cpu")
    (walked, dense, form), = [w for w in _site_walks(kst, 0, enc.cards) if len(w[1]) == 13]
    assert len(walked) == 1 and walked[0][0].tobytes() == form[0].tobytes()
    looked = np.stack([[tab[0] if rs.size == 0 else tab[r] for tab, rs, _ in dense]
                       for r in range(2)])  # [blanket rows, incidences, K]
    assert form[0].tobytes() != np.stack([_pairwise(x) for x in looked]).tobytes()
    state = torch.zeros((1, kst["pal_oon"].shape[1], 8), dtype=torch.int32)
    sw, cw = walk_window(kst, state.clone(), 9, 4, 2, True, 8)
    sp, cp = window_plain(*[kst[k] for k in sweep.KERNEL_KEYS], state.clone(), 9, 4, 2, True, 8)
    assert torch.equal(sw, sp) and torch.equal(cw, cp)
