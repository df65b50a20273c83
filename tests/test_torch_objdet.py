"""The ObjectDetection-shaped net of the benchmark's ``objdet60``
configuration (``benchmark/builders/objdet_like.py``: cards 11-16,
pairwise tables of up to 256 entries) on the CPU: the builder keeps the
published shape, the exact reference holds at mixed cards, the port's
normal path matches it, the cell's launch plan reads its tables from
device memory, and the sweep kernel's launch counters count what they
say.  The kernel itself runs on the card only (``tests/test_torch_cuda.py``).

    python -m pytest tests/test_torch_objdet.py -q
"""

from collections import Counter
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from benchmark import exact, nets, registry
from grample_tpu_torch.ops import gibbs_cuda, sweep
from grample_tpu_torch.pgm import discrete, encode
from grample_tpu_torch.pgm.exact import exact_marginals as port_exact_marginals
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.uai import load_model
from tests import torch_models

SPEC = registry.config("objdet60")["net"]
#: the cell's chains a variant (``benchmark/traffic/simple-c2-v131072.json``)
CELL_CHAINS = 131072


def objdet(seed, v=60, drop=24, evidence=None):
    """The ``objdet_like`` net at the configuration's structure seed, or cut to
    ``v`` vars with ``drop`` edges dropped."""
    if v == 60 and evidence is None:
        return nets.build(SPEC, seed)
    return nets.builder("objdet_like")(seed, structure_seed=SPEC["structure_seed"], v=v,
                                       drop=drop, evidence=evidence)


def port_model(net, tmp_path, name="net"):
    """The net as the port reads it: UAI files, evidence applied."""
    return load_model(nets.write_uai(net, str(tmp_path), name), use_evidence=True)


def neighbours(net):
    adj = {u: set() for u in range(len(net["cards"]))}
    for scope, _ in net["factors"]:
        for u in scope:
            adj[u].update(w for w in scope if w != u)
    return adj


def min_fill_width(net):
    """The width of the greedy min-fill order of ``benchmark.exact`` over
    the net's whole interaction graph (no evidence clamped)."""
    pots = [NS(scope=scope) for scope, _ in net["factors"]]
    adj = neighbours(net)
    width = 0
    for u in exact.min_fill_order(range(len(net["cards"])), pots):
        nb = adj.pop(u)
        width = max(width, len(nb))
        for a in nb:
            adj[a].discard(u)
            adj[a].update(b for b in nb if b != a)
    return width


def enumerated_marginals(net):
    """Exact marginals by enumerating every assignment (numpy, float64)."""
    cards = net["cards"]
    grids = np.indices(cards).reshape(len(cards), -1).T
    logw = np.zeros(len(grids))
    for scope, table in net["factors"]:
        arr = np.log(np.asarray(table)).reshape([cards[u] for u in scope])
        logw += arr[tuple(grids[:, u] for u in scope)]
    for u, x in net["evidence"].items():
        logw[grids[:, u] != x] = -np.inf
    w = np.exp(logw - logw.max())
    out = np.zeros((len(cards), max(cards)))
    for u, c in enumerate(cards):
        out[u, :c] = np.bincount(grids[:, u], weights=w, minlength=c)
    return out / out.sum(axis=1, keepdims=True)


# ---- the builder -------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_builder_keeps_the_published_shape(seed):
    """ObjectDetection_11-13's statistics (SURVEY.md §6): 60 vars of cards
    11-16, ten at each; 210 factors of scope <= 2, a unary per var; a
    largest Markov blanket of 11-13; at most 43200 table entries, tables of
    at most 256; and a greedy min-fill width of at most 4 (a partial
    3-tree), with the configuration's evidence."""
    net = objdet(seed)
    assert Counter(net["cards"]) == {k: 10 for k in range(11, 17)}
    scopes = [s for s, _ in net["factors"]]
    assert len(scopes) == 210 and max(map(len, scopes)) == 2
    assert sorted(s[0] for s in scopes if len(s) == 1) == list(range(60))
    assert 11 <= max(len(nb) for nb in neighbours(net).values()) <= 13
    sizes = [t.size for _, t in net["factors"]]
    assert sum(sizes) <= 43200 and max(sizes) == 256
    assert all(t.size == np.prod([net["cards"][u] for u in s]) and (t > 0).all()
               for s, t in net["factors"])
    assert min_fill_width(net) <= 4
    assert net["evidence"] == {0: 3, 29: 7, 59: 12}
    assert all(x < net["cards"][u] for u, x in net["evidence"].items())


def test_seed_draws_the_tables_alone():
    """The structure and the evidence are the configuration's; ``--seed``
    draws only the tables, the same seed the same UAI bytes."""
    a, b, c = objdet(5), objdet(6), objdet(5)
    assert [s for s, _ in a["factors"]] == [s for s, _ in b["factors"]]
    assert a["cards"] == b["cards"] and a["evidence"] == b["evidence"]
    assert all(not np.array_equal(x, y) for (_, x), (_, y) in zip(a["factors"], b["factors"]))
    assert nets.uai_text(a) == nets.uai_text(c)


# ---- the exact reference at mixed cards ------------------------------------------

@pytest.mark.parametrize("case", ["enumeration_5vars", "port_exact_12vars"])
def test_reference_at_mixed_cards(case, tmp_path):
    """``benchmark.exact`` (the bucket tree) against enumeration on a 5-var
    net of cards 11-15 built by the same rules, and against the port's
    ``pgm.exact`` (enumeration of the free vars) on a 12-var one at cards
    11-16 with seven vars observed."""
    if case == "enumeration_5vars":
        net = objdet(17, v=5, drop=1, evidence={3: 4})
        want = enumerated_marginals(net)
    else:
        net = objdet(19, v=12, drop=3,
                     evidence={3: 13, 4: 2, 5: 15, 8: 10, 9: 0, 10: 5, 11: 9})
        m = port_model(net, tmp_path)
        assert int(np.prod(m.cards[m.free_mask])) < 1 << 22
        want = port_exact_marginals(m)
    assert sorted(set(net["cards"])) == sorted(set(range(11, 11 + min(6, len(net["cards"])))))
    np.testing.assert_allclose(exact.exact_marginals(net), want, atol=1e-12)


# ---- the port's normal path ------------------------------------------------------

def test_simple_engine_matches_exact(tmp_path):
    """``Engine`` with ``-s simple`` on the CPU (the plain version standing
    in for the sweep kernel) on a 12-var objdet-shaped net at cards 11-16:
    every outcome of every free var within 5 sigma of ``benchmark.exact``."""
    net = objdet(23, v=12, drop=3, evidence={6: 4})
    path = nets.write_uai(net, str(tmp_path), "objdet12")
    chains, cpv, sweeps = 2, 128, 400
    cfg = EngineConfig(model_path=path, device="cpu", use_evidence=True, sampler="simple",
                       burnin=12 * 100, converge_window=12 * 100, chains=chains,
                       chains_per_variant=cpv, max_iters=11 * chains * cpv * sweeps,
                       max_secs=120.0, seed=29, status_secs=0.5)
    res = Engine(cfg, log=lambda line: None).run()
    truth = exact.exact_marginals(net)
    free = exact.free_mask(net)
    assert res.samples >= 11 * chains * cpv * sweeps
    # a chain forgets its state within a few sweeps here (8 n H^2 reads
    # 1-3 at this size): n_eff >= chains x sweeps / 8 a var
    n_eff = res.samples / free.sum() / 8
    sigma = np.sqrt(truth * (1 - truth) / n_eff)
    err = np.abs(np.asarray(res.marginals)[:, :truth.shape[1]] - truth)
    assert (err[free] <= 5 * sigma[free] + 1e-12).all(), err.max()
    assert "sites.tables_global" not in res.counters and "sites.spilled" not in res.counters


# ---- the launch plan and the launch counters -----------------------------------------

def cell_tensors(tmp_path, n=2):
    """The cell's sweep tensors on the host: ``n`` variants of the 60-var
    net at its plain caps, as the engine's ``-s simple -c 2`` group has."""
    m = port_model(objdet(2**31 + 3), tmp_path)
    enc = encode.encode_model(m, encode.compute_caps(m, headroom_factors=0))
    return m, sweep.sweep_tensors(encode.stack_variants([enc] * n), "cpu")


@pytest.mark.parametrize("count", [True, False])
def test_cell_plan_reads_tables_from_device_memory(tmp_path, count):
    """At the cell's sizes the compact tables (each site's own copy of its
    unmerged incidences' 16-row tables) outgrow a block's shared memory
    beside the packed state: the full-card launch runs a thread per chain
    with the lists staged and the tables read from device memory, and so
    does a sub-card launch of either form.  Counted by registers, every
    width keeps 32 warps an SM resident, and the rule takes the one with
    the most resident blocks: 32 threads (measured the fastest on an H100,
    1024 +16.5 %) and, site-parallel, 4 chains a block (the fastest, 8
    chains, 1.2 % ahead)."""
    m, kst = cell_tensors(tmp_path)
    assert kst["k_kmask"].shape[3] == gibbs_cuda.MAX_CARD == 16
    assert not gibbs_cuda.uses_gather(kst)
    assert kst["c_tables"].shape[1] * 4 > gibbs_cuda.MAX_SMEM_BYTES
    plan = gibbs_cuda.plan_launch(kst, CELL_CHAINS, count, 132)
    assert (plan.sites, plan.threads, plan.stage_lists, plan.stage_tables) == (
        False, 32, True, False)
    assert plan.state_bytes == gibbs_cuda.state_bytes(kst["c_rows"].shape[1], 16, 32)
    shapes = gibbs_cuda._shapes(plan.list_bytes, plan.table_bytes, kst["c_rows"].shape[1], 16,
                                False, False)
    assert {t: r * t // 32 for t, _, _, r in shapes} == {t: 32 for t in gibbs_cuda.THREAD_CHOICES}
    sub = [gibbs_cuda.plan_launch(kst, 4096, count, 132, sites) for sites in (False, True)]
    assert not any(p.stage_tables for p in sub) and sub[1].threads == 128


def card16_grid_tensors(case):
    """Two variants of a 3x3 or 10x10 grid at card 16, or of a 4x4 grid at
    card 16 encoded all-gather (the gather form)."""
    side = {"grid3": 3, "grid4_gather": 4, "grid10": 10}[case]
    m = torch_models.grid(discrete, side, seed=5, card=16)
    caps = encode.compute_caps(m, headroom_factors=0)
    if case == "grid4_gather":
        caps = torch_models.all_gather(caps)
    enc = encode.encode_model(m, caps)
    return sweep.sweep_tensors(encode.stack_variants([enc, enc]), "cpu")


#: the block width the rule gives the full-card launch (2 x 131072 chains)
#: and the site-parallel one (2 x 8192) of card-16 grids, beside the fastest
#: measured on an H100 (counted 2000-sweep windows, 500 for the 10x10 grid
#: and the gather form; the gather form runs 512 at most)
CARD16_WIDTHS = {
    "grid10": (64, 128),  # fastest 512 (64: +1.3 %, 1024: +2.7 %)
    "grid3": (1024, 1024),  # tables staged: fastest 512 (1024: +0.5 %)
    "grid4_gather": (512, 512),  # tables staged: fastest 512 in both forms
}


@pytest.mark.parametrize("case", sorted(CARD16_WIDTHS))
def test_card16_width_follows_where_the_tables_are(case):
    """Above card 8 the rule counts registers, so every width keeps as many
    warps resident; where the tables stay in device memory it takes the
    width with the most resident blocks (as for the cell's net), where they
    are staged the widest as before."""
    kst = card16_grid_tensors(case)
    full, sub = (gibbs_cuda.plan_launch(kst, c, True, 132, sites)
                 for c, sites in ((CELL_CHAINS, None), (8192, True)))
    assert not full.sites and sub.sites and full.stage_tables == sub.stage_tables
    assert (full.threads, sub.threads) == CARD16_WIDTHS[case]
    assert full.stage_tables == (case in ("grid3", "grid4_gather"))


@pytest.mark.parametrize("spilled", [False, True])
def test_launch_counters_count_the_claimed_updates(tmp_path, monkeypatch, spilled):
    """A counted window whose launch reads the tables from device memory
    counts all its claimed site updates under ``sites.tables_global``, and
    under ``sites.spilled`` all of them where the kernel instance spills and
    none where it does not (the counter is there with 0).  The launch is
    made to look like one on the card; on the CPU neither counter is
    counted (the plain version runs)."""
    m, _ = cell_tensors(tmp_path)
    g = ChainGroup(m, 64, 4, "cpu", seed=3)
    g.reserve(2)
    g.add_variants([m, m])
    g.advance()
    assert not {"sites.tables_global", "sites.spilled"} & set(g.tracer.counters)
    card = torch.device("cuda", 0)
    # the group's one launch, on the card: its stack runs the kernel there
    monkeypatch.setattr(g.kstack, "kernel", True)
    monkeypatch.setitem(g.kstack.tensors, card, g.kstack.tensors[g.device])
    monkeypatch.setattr(g, "device", card)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: NS(multi_processor_count=132))
    seen = []
    monkeypatch.setattr(gibbs_cuda, "spills",
                        lambda k, plan, dev: seen.append((k, plan, dev)) or spilled)
    before = g.tracer.counters["sites.main"]
    taken = g.advance() + g.advance(6)
    assert taken == g.tracer.counters["sites.main"] - before == (4 + 6) * 64 * 2 * 57
    assert g.tracer.counters["sites.tables_global"] == taken
    assert g.tracer.counters["sites.spilled"] == (taken if spilled else 0)
    assert [(k, dev) for k, _, dev in seen] == [(16, card)] * 2
    assert not seen[0][1].stage_tables and seen[0][1].count


#: the launch shapes (``gibbs_cuda.launch_shapes``) of the binary cells'
#: groups, as the rule gave them before it counted registers above card 8:
#: per chain count 32 * 2^j (j < 20), the rule's form, thread per chain and
#: site-parallel, each as form (t/s), threads, lists (L) and tables (T) staged
BINARY_SHAPES = {
    "grid10x10": ("s128LT t1024LT s128LT s128LT t1024LT s128LT s128LT t1024LT s128LT s128LT "
                  "t1024LT s128LT s128LT t1024LT s128LT s128LT t32LT s128LT s256LT t32LT s256LT "
                  "s512LT t32LT s512LT s1024LT t32LT s1024LT s1024LT t64LT s1024LT s1024LT t128LT "
                  "s1024LT t256LT t256LT s1024LT t512LT t512LT s1024LT t1024LT t1024LT s1024LT "
                  "t1024LT t1024LT s1024LT t1024LT t1024LT s1024LT t1024LT t1024LT s1024LT "
                  "t1024LT t1024LT s1024LT t1024LT t1024LT s1024LT t1024LT t1024LT s1024LT"),
    "promedus916": ("s128LT t1024LT s128LT s128LT t1024LT s128LT s128LT t1024LT s128LT s128LT "
                    "t1024LT s128LT s128LT t1024LT s128LT s128LT t32LT s128LT s256LT t32LT s256LT "
                    "s512LT t32LT s512LT s1024LT t32LT s1024LT s1024LT t64LT s1024LT s1024LT "
                    "t128LT s1024LT t256LT t256LT s1024LT t1024LT t1024LT s1024LT t1024LT t1024LT "
                    "s1024LT t1024LT t1024LT s1024LT t1024LT t1024LT s1024LT t1024LT t1024LT "
                    "s1024LT t1024LT t1024LT s1024LT t1024LT t1024LT s1024LT t1024LT t1024LT "
                    "s1024LT"),
}


def shape_code(plan):
    return "-" if plan is None else (("s" if plan[0] else "t") + str(plan[1])
                                     + ("L" if plan[2] else "") + ("T" if plan[3] else ""))


@pytest.mark.parametrize("caps", ["plain", "headroom"])
@pytest.mark.parametrize("config", sorted(BINARY_SHAPES))
def test_binary_cells_launch_as_before(config, caps, tmp_path):
    """Registers are counted above card 8 only: every launch shape of the
    binary cells' groups (their plain caps and the adaptive group's
    collapse-headroom caps, at every chain count) is the one the rule gave
    before."""
    m = port_model(nets.build(registry.config(config)["net"], 7), tmp_path)
    caps = (encode.compute_caps(m, headroom_factors=0) if caps == "plain" else
            encode.compute_caps(m, collapse_headroom=True, slot_hint=128, headroom_factors=2))
    enc = encode.encode_model(m, caps)
    kst = sweep.sweep_tensors(encode.stack_variants([enc, enc]), "cpu")
    assert kst["k_kmask"].shape[3] == 2
    shapes = gibbs_cuda.launch_shapes(kst["c_lists"].shape[1] * 4, kst["c_tables"].shape[1] * 4,
                                      kst["c_rows"].shape[1], 2, gibbs_cuda.uses_gather(kst))
    assert " ".join(map(shape_code, shapes)) == BINARY_SHAPES[config]
