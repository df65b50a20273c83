"""ObjectDetection-shaped Markov net (the UAI ObjectDetection_11-13
family: 60 vars of cards 11-16, a unary factor per var and pairwise
factors, Markov blankets of 11-13).

The real nets are not in the repository, so the builder keeps their
published shape and draws the rest:

* cards: var ``i`` has card ``card_min + i % card_span`` (by default ten
  vars at each card from 11 to 16);
* structure, fixed by ``structure_seed``: a 3-tree, then some of its
  edges dropped.  From the triangle {0, 1, 2}, each later var is joined to
  the three vars of a 3-clique drawn uniformly from those built so far,
  among the cliques whose vars all have fewer than ``max_degree``
  neighbours; then ``drop`` edges are removed one at a time, each drawn
  uniformly among those whose two ends keep a neighbour.  The result is a
  partial 3-tree: its treewidth is at most 3, so the exact reference
  (``benchmark.exact``) stays cheap;
* factors: one unary per var, then one pairwise per edge left, in the
  order the edges were built, scope (lower var, higher var);
* tables: every entry ``exp(N(0, 1))``, drawn from ``seed`` in factor
  order.

Structure seed 1 gives the 60-var net a largest Markov blanket of 13.
"""

from __future__ import annotations

import numpy as np

from benchmark.nets import seed_rng


def structure(structure_seed: int, v: int = 60, max_degree: int = 13, drop: int = 24) -> list:
    """The edges (lower var, higher var) of the net at ``structure_seed``,
    in the order they were built."""
    rng = seed_rng(structure_seed)
    adj = [set() for _ in range(v)]
    edges = []

    def join(a, b):
        adj[a].add(b)
        adj[b].add(a)
        edges.append((a, b))

    join(0, 1)
    join(0, 2)
    join(1, 2)
    cliques = [(0, 1, 2)]
    for i in range(3, v):
        open_ = [q for q in cliques if all(len(adj[u]) < max_degree for u in q)]
        if not open_:
            raise ValueError(f"no 3-clique with every var under {max_degree} neighbours "
                             f"to join var {i} to")
        a, b, c = open_[int(rng.integers(len(open_)))]
        for u in (a, b, c):
            join(u, i)
        cliques += [(a, b, i), (a, c, i), (b, c, i)]
    for _ in range(drop):
        keep = [e for e in edges if len(adj[e[0]]) > 1 and len(adj[e[1]]) > 1]
        if not keep:
            raise ValueError("no edge left whose two ends keep a neighbour")
        a, b = keep[int(rng.integers(len(keep)))]
        edges.remove((a, b))
        adj[a].discard(b)
        adj[b].discard(a)
    return edges


def build(seed: int, structure_seed: int = 1, v: int = 60, card_min: int = 11,
          card_span: int = 6, max_degree: int = 13, drop: int = 24, evidence=None) -> dict:
    """The net: structure and evidence fixed by the arguments, tables drawn
    from ``seed`` (see the module doc)."""
    cards = [card_min + i % card_span for i in range(v)]
    edges = structure(structure_seed, v, max_degree, drop)
    rng = seed_rng(seed)
    factors = [((i,), np.exp(rng.standard_normal(cards[i]))) for i in range(v)]
    factors += [((a, b), np.exp(rng.standard_normal(cards[a] * cards[b]))) for a, b in edges]
    ev = {int(k): int(x) for k, x in (evidence or {}).items()}
    return {"type": "MARKOV", "cards": cards, "factors": factors, "evidence": ev}
