"""Synthetic nets built identically for the JAX package and its port.

Each builder takes the ``discrete`` module of one package
(``grample_tpu.pgm.discrete`` or ``grample_tpu_torch.pgm.discrete``) and
draws its tables from numpy with a fixed seed, so both packages see the
same model.  ``collapsed`` builds a collapse variant with the same
package's ``sampler.collapse``; ``promedus_like`` is the Promedus-shaped
Bayes net and ``grid10_variants`` the 10x10 grid that ``chip_smoke.py``
also runs.
"""

import dataclasses
import importlib

import numpy as np


def grid(pgm, side=3, seed=7, card=2):
    """Grid Markov net: a unary factor per var, a pairwise per edge
    (``tests/test_pallas.py::_grid``)."""
    rng = np.random.default_rng(seed)
    v = side * side
    factors = [pgm.Factor(f"u{i}", [i], rng.random(card) + 0.2) for i in range(v)]
    for r in range(side):
        for c in range(side):
            i = r * side + c
            if c + 1 < side:
                factors.append(pgm.Factor(f"h{i}", [i, i + 1], rng.random(card * card) + 0.2))
            if r + 1 < side:
                factors.append(pgm.Factor(f"v{i}", [i, i + side], rng.random(card * card) + 0.2))
    return pgm.DiscreteModel(type="MARKOV", cards=[card] * v, factors=factors)


def grid10_variants(pgm, card=2):
    """The smoke run's 10x10 grid (100 vars, 280 factors; binary unless
    ``card`` says otherwise): 2 variants (tables from seeds 1 and 2, the
    same 3 evidence vars) and their plain caps, built with ``pgm``'s own
    package."""
    encode = importlib.import_module(pgm.__name__.rsplit(".", 2)[0] + ".pgm.encode")
    models = [grid(pgm, 10, s, card) for s in (1, 2)]
    for m in models:
        m.apply_evidence({0: 1, 55: 0, 99: 1})
    return models, encode.compute_caps(models[0], headroom_factors=0)


def rand_model(pgm, seed, v=6, max_card=3, n_factors=7, max_scope=3):
    """Random mixed-card net (``tests/test_gibbs.py::rand_model``)."""
    rng = np.random.default_rng(seed)
    cards = rng.integers(2, max_card + 1, size=v)
    factors = []
    touched = set()
    for i in range(n_factors):
        size = int(rng.integers(1, max_scope + 1))
        scope = rng.choice(v, size=size, replace=False)
        touched.update(int(s) for s in scope)
        factors.append(pgm.Factor(f"func-{i}", scope, rng.random(int(np.prod(cards[scope])))))
    nf = n_factors
    for u in range(v):
        if u not in touched:
            factors.append(pgm.Factor(f"func-{nf}", np.array([u]), rng.random(int(cards[u]))))
            nf += 1
    return pgm.DiscreteModel(type="MARKOV", cards=cards, factors=factors)


def chain_model(pgm, seed, v=4):
    """Binary chain net (``tests/test_chains.py::small_model``)."""
    rng = np.random.default_rng(seed)
    factors = [pgm.Factor(f"u{i}", [i], rng.random(2) + 0.2) for i in range(v)]
    factors += [pgm.Factor(f"p{i}", [i, i + 1], rng.random(4) + 0.2) for i in range(v - 1)]
    return pgm.DiscreteModel(type="MARKOV", cards=[2] * v, factors=factors)


def star(pgm, leaves, seed, lo, unary=False, card=2):
    """Star net: centre 0 coupled pairwise to every leaf, so the centre's
    blanket is the whole net and collapsing it leaves one factor over all
    leaves (local tables of card**(leaves-1) rows)."""
    rng = np.random.default_rng(seed)
    v = leaves + 1
    factors = [pgm.Factor(f"u{i}", [i], rng.random(card) + lo) for i in range(v)] if unary else []
    factors += [pgm.Factor(f"{'e' if unary else 's'}{i}", [0, i], rng.random(card * card) + lo)
                for i in range(1, v)]
    return pgm.DiscreteModel(type="MARKOV", cards=[card] * v, factors=factors)


def full(pgm, v, seed):
    """Fully connected binary net: a unary per var and a pairwise factor
    per pair, so every var's blanket is the whole net."""
    rng = np.random.default_rng(seed)
    factors = [pgm.Factor(f"u{i}", [i], rng.random(2) + 0.3) for i in range(v)]
    factors += [pgm.Factor(f"p{i}_{j}", [i, j], rng.random(4) + 0.3)
                for i in range(v) for j in range(i + 1, v)]
    return pgm.DiscreteModel(type="MARKOV", cards=[2] * v, factors=factors)


def wide_factor(pgm, v, seed):
    """One factor over ``v`` binary vars (the dv-rel family's widest CPTs
    have scope 10: local tables of 2**(v-1) rows) plus a unary per var."""
    rng = np.random.default_rng(seed)
    factors = [pgm.Factor("wide", np.arange(v), rng.random(2 ** v) + 0.2)]
    factors += [pgm.Factor(f"u{i}", [i], rng.random(2) + 0.3) for i in range(v)]
    return pgm.DiscreteModel(type="MARKOV", cards=[2] * v, factors=factors)


def flip_symmetric(pgm, side=3, seed=5):
    """Binary grid with uniform unaries and pairwise tables ``[a, b, b, a]``:
    flipping every var leaves the joint unchanged, so every marginal, and
    every collapsed var's static collapse marginal, is exactly 0.5 (it
    stands in for the reference suite's ``deterministic.uai``)."""
    rng = np.random.default_rng(seed)
    v = side * side
    factors = [pgm.Factor(f"u{i}", [i], np.ones(2)) for i in range(v)]
    for r in range(side):
        for c in range(side):
            i = r * side + c
            for j in ([i + 1] if c + 1 < side else []) + ([i + side] if r + 1 < side else []):
                a, b = rng.random(2) + 0.2
                factors.append(pgm.Factor(f"p{i}_{j}", [i, j], np.array([a, b, b, a])))
    return pgm.DiscreteModel(type="MARKOV", cards=[2] * v, factors=factors)


def promedus_like(pgm, seed, v=916, window=40, evidence_frac=0.05):
    """Promedus-shaped Bayes net (the UAI Promedus_11-19 family: 374-916
    binary vars, one CPT per var with at most 2 parents, max scope 3,
    blankets up to about 13): var i's CPT is over 0-2 parents drawn
    among the ``window`` previous vars, then i.  Returns (model, evidence
    {var: value}) with ``evidence_frac`` of the vars observed; the
    evidence is not applied."""
    rng = np.random.default_rng(seed)
    factors = []
    for i in range(v):
        lo = max(0, i - window)
        npar = min(i - lo, int(rng.integers(0, 3)))
        parents = sorted(rng.choice(np.arange(lo, i), size=npar, replace=False).tolist())
        cpt = rng.random((2 ** npar, 2)) + 0.05
        cpt /= cpt.sum(axis=1, keepdims=True)
        factors.append(pgm.Factor(f"cpt{i}", parents + [i], cpt.reshape(-1)))
    m = pgm.DiscreteModel(type="BAYES", cards=[2] * v, factors=factors)
    obs = rng.choice(v, size=int(round(evidence_frac * v)), replace=False)
    return m, {int(u): int(rng.integers(0, 2)) for u in sorted(obs)}


#: (name, builder(pgm) -> model, evidence) cases shared by the port tests
MODELS = {
    "grid3": (lambda pgm: grid(pgm, 3), {}),
    "grid4_evid": (lambda pgm: grid(pgm, 4, seed=3), {5: 1, 10: 0}),
    "grid3_card3_evid": (lambda pgm: grid(pgm, 3, seed=11, card=3), {4: 2}),
    "rand6": (lambda pgm: rand_model(pgm, 12345), {}),
    "rand8_card4": (lambda pgm: rand_model(pgm, 99, v=8, max_card=4, n_factors=10), {1: 3}),
    # tests/test_pallas.py:206-214
    "star8": (lambda pgm: star(pgm, 7, seed=3, lo=0.3, unary=True), {}),
    # __graft_entry__.py:178-185
    "star10": (lambda pgm: star(pgm, 9, seed=11, lo=0.2), {}),
    "star6_card3_evid": (lambda pgm: star(pgm, 5, seed=5, lo=0.2, unary=True, card=3), {5: 1}),
    "full8_evid": (lambda pgm: full(pgm, 8, seed=13), {7: 1}),
    "flip3": (lambda pgm: flip_symmetric(pgm, 3), {}),
}

#: collapse variants with wide local tables: name -> (MODELS entry,
#: collapsed var); the widest incidence of each, in local rows
WIDE = {
    "star8_c0": ("star8", 0),  # 64 rows
    "star10_c0": ("star10", 0),  # 256 rows
    "star6_card3_c0": ("star6_card3_evid", 0),  # 81 rows, card 3
    "full8_c2": ("full8_evid", 2),  # 64 rows, with evidence
}


def build(pgm, name):
    """Model ``name`` of :data:`MODELS` with its evidence applied."""
    make, evidence = MODELS[name]
    m = make(pgm)
    if evidence:
        m.apply_evidence({k: v for k, v in evidence.items() if v < m.cards[k]})
    return m


def _collapse(pgm):
    """The ``sampler.collapse`` module of ``pgm``'s package."""
    return importlib.import_module(pgm.__name__.rsplit(".", 2)[0] + ".sampler.collapse")


def collapsed(pgm, name):
    """The collapse variant :data:`WIDE` ``name``, built with ``pgm``'s own
    package; returns (base model, variant, exact collapse marginal)."""
    base_name, var = WIDE[name]
    m = build(pgm, base_name)
    variant, exact = _collapse(pgm).collapse_var(m, var)
    return m, variant, exact


def widest_collapsible(pgm, m, n, oa_cap=256):
    """The ``n`` collapsible vars of ``m`` (dense guard ``oa_cap``) with
    the largest blankets, ties by index: a deterministic variant set with
    the widest local tables the collapsed sampler admits."""
    collapse = _collapse(pgm)
    blankets = m.blankets()
    ok = [v for v in range(m.num_vars)
          if collapse.is_collapsible(m, v, blankets[v], oa_cap=oa_cap)]
    return sorted(ok, key=lambda v: (-len(blankets[v]), v))[:n]


def headroom_variants(pgm, case):
    """A collapse-headroom encoding's variants and caps, built with
    ``pgm``'s own package: (variants, caps, base model).

    ``grid4``/``rand8``: the single adaptive group's caps (collapse
    headroom for 128 slots, two spare factor slots per var, two extra
    colour groups, 16 extra tail rows), 2 plain slots + 2 collapse
    variants.  ``star8_aux``: the split group's ``aux_caps``, 2 collapse
    variants of the 8-var star (local tables of 64 rows)."""
    package = pgm.__name__.rsplit(".", 2)[0]
    collapse = _collapse(pgm)
    encode = importlib.import_module(package + ".pgm.encode")
    name, picks = {"grid4": ("grid4_evid", [0, 6]), "rand8": ("rand8_card4", [2, 4]),
                   "star8_aux": ("star8", [0, 3])}[case]
    m = build(pgm, name)
    collapsed = [collapse.collapse_var(m, v)[0] for v in picks]
    if case == "star8_aux":
        split = importlib.import_module(package + ".sampler.split")
        return collapsed, split.aux_caps(m), m
    caps = encode.compute_caps(m, collapse_headroom=True, slot_hint=128, headroom_factors=2)
    return [m, m] + collapsed, caps, m


def all_gather(caps):
    """``caps`` with every incidence in the flat-table gather bank (as
    ``tests/test_gibbs.py:219-224`` builds the mode)."""
    return dataclasses.replace(caps, base_mode="gather", adj_cap=0, oa_cap=1,
                               gfac_cap=caps.adj_cap + caps.gfac_cap)


#: encodings with a gather bank: the all-gather forms of the headroom
#: cases, the smallest Promedus-shaped net whose headroom caps go
#: all-gather, and the mixed encoding of the 12-var wide factor
GATHER_CASES = ("grid4_gather", "rand8_gather", "star8_aux_gather", "promedus560",
                "wide12_mixed")


def gather_variants(pgm, case):
    """(variants, caps) of a ``GATHER_CASES`` case, built with ``pgm``'s
    own package."""
    package = pgm.__name__.rsplit(".", 2)[0]
    encode = importlib.import_module(package + ".pgm.encode")
    if case.endswith("_gather"):
        variants, caps, _ = headroom_variants(pgm, case[:-len("_gather")])
        return variants, all_gather(caps)
    if case == "promedus560":
        m, evidence = promedus_like(pgm, seed=1, v=560)
        m.apply_evidence(evidence)
        return [m, m], encode.compute_caps(m, collapse_headroom=True, slot_hint=128,
                                           headroom_factors=2)
    m = wide_factor(pgm, 12, seed=2)
    return [m, m], encode.compute_caps(m, headroom_factors=0)
