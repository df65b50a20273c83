"""Synthetic nets built identically for the JAX package and its port.

Each builder takes the ``discrete`` module of one package
(``grample_tpu.pgm.discrete`` or ``grample_tpu_torch.pgm.discrete``) and
draws its tables from numpy with a fixed seed, so both packages see the
same model.
"""

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


#: (name, builder(pgm) -> model, evidence) cases shared by the port tests
MODELS = {
    "grid3": (lambda pgm: grid(pgm, 3), {}),
    "grid4_evid": (lambda pgm: grid(pgm, 4, seed=3), {5: 1, 10: 0}),
    "grid3_card3_evid": (lambda pgm: grid(pgm, 3, seed=11, card=3), {4: 2}),
    "rand6": (lambda pgm: rand_model(pgm, 12345), {}),
    "rand8_card4": (lambda pgm: rand_model(pgm, 99, v=8, max_card=4, n_factors=10), {1: 3}),
}


def build(pgm, name):
    """Model ``name`` of :data:`MODELS` with its evidence applied."""
    make, evidence = MODELS[name]
    m = make(pgm)
    if evidence:
        m.apply_evidence({k: v for k, v in evidence.items() if v < m.cards[k]})
    return m
