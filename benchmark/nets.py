"""The benchmark's nets: generators, drawn from a seed, and a UAI writer.

A net is a plain dict, independent of the program under test:

    {"type": "MARKOV" | "BAYES", "cards": [int, ...],
     "factors": [(scope tuple, float64 table, row-major, last var fastest)],
     "evidence": {var: value}}

Frozen copies of the repository's synthetic builders (``grid`` and
``promedus_like`` of the port's test models), so that a change to the
tests cannot move the yardstick: ``grid`` draws as its original does;
``promedus_like`` replays its original's draws for the structure and the
evidence, and draws the CPT values from ``--seed`` on their own.  A
configuration's ``net`` entry names a builder and its parameters: one of
:data:`BUILDERS`, else the ``build(seed, **params)`` of
``benchmark/builders/<builder>.py``, so a net family comes in as a new
file.  The structure and the evidence of a net are fixed by the
configuration, and ``--seed`` draws only the table values.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark import registry


def seed_rng(seed: int) -> np.random.Generator:
    """numpy's generator for any whole ``seed`` (negative ones wrap)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def grid(seed: int, side: int = 10, card: int = 2, evidence=None, offset: float = 0.2) -> dict:
    """Grid Markov net: a unary factor per var and a pairwise factor per
    edge, tables ``rng.random + offset`` in the order the repository's
    ``grid`` builder draws them."""
    rng = seed_rng(seed)
    v = side * side

    def table(n):
        return rng.random(n) + offset

    factors = [((i,), table(card)) for i in range(v)]
    for r in range(side):
        for c in range(side):
            i = r * side + c
            if c + 1 < side:
                factors.append(((i, i + 1), table(card * card)))
            if r + 1 < side:
                factors.append(((i, i + side), table(card * card)))
    ev = {int(k): int(x) for k, x in (evidence or {}).items()}
    return {"type": "MARKOV", "cards": [card] * v, "factors": factors, "evidence": ev}


def promedus_structure(structure_seed: int, v: int = 916, window: int = 40,
                       evidence_frac: float = 0.05):
    """(parents of each var, evidence) of the repository's ``promedus_like``
    at ``structure_seed``: its draws replayed in its order, the CPT values
    drawn and dropped."""
    rng = seed_rng(structure_seed)
    parents = []
    for i in range(v):
        lo = max(0, i - window)
        npar = min(i - lo, int(rng.integers(0, 3)))
        parents.append(sorted(rng.choice(np.arange(lo, i), size=npar, replace=False).tolist()))
        rng.random((2 ** npar, 2))
    obs = rng.choice(v, size=int(round(evidence_frac * v)), replace=False)
    return parents, {int(u): int(rng.integers(0, 2)) for u in sorted(obs)}


def promedus_like(seed: int, structure_seed: int = 1, v: int = 916, window: int = 40,
                  evidence_frac: float = 0.05, floor: float = 0.05) -> dict:
    """Promedus-shaped Bayes net (the UAI Promedus_11-19 family): var i's
    CPT over its 0-2 parents among the ``window`` previous vars, then i.
    Parents and evidence are those of ``structure_seed``; the CPT rows are
    ``rng.random + floor``, normalised, drawn from ``seed``."""
    parents, evidence = promedus_structure(structure_seed, v, window, evidence_frac)
    rng = seed_rng(seed)
    factors = []
    for i, par in enumerate(parents):
        cpt = rng.random((2 ** len(par), 2)) + floor
        cpt /= cpt.sum(axis=1, keepdims=True)
        factors.append((tuple(par) + (i,), cpt.reshape(-1)))
    return {"type": "BAYES", "cards": [2] * v, "factors": factors, "evidence": evidence}


#: builder name -> function(seed, **params)
BUILDERS = {"grid": grid, "promedus_like": promedus_like}


def builder(name: str, root: str = registry.ROOT):
    """Builder ``name``: of :data:`BUILDERS`, else the ``build`` function of
    ``<root>/benchmark/builders/<name>.py``."""
    if name in BUILDERS:
        return BUILDERS[name]
    path = os.path.join(root, "benchmark", "builders", name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no net builder {name!r}: not in nets.BUILDERS, and no {path}")
    return registry.load("builders", name, "build", root)


def build(spec: dict, seed: int, root: str = registry.ROOT) -> dict:
    """The net of a configuration's ``net`` entry, tables drawn from ``seed``."""
    params = {k: x for k, x in spec.items() if k != "builder"}
    return builder(spec["builder"], root)(seed, **params)


def uai_text(net: dict) -> str:
    """The net as a UAI model file."""
    lines = [net["type"], str(len(net["cards"])), " ".join(str(int(c)) for c in net["cards"]),
             str(len(net["factors"]))]
    lines += [f"{len(scope)} " + " ".join(str(int(u)) for u in scope)
              for scope, _ in net["factors"]]
    for _, table in net["factors"]:
        lines += ["", str(table.size), " ".join(format(float(x), ".17g") for x in table)]
    return "\n".join(lines) + "\n"


def evidence_text(net: dict) -> str:
    """The net's evidence as a one-sample UAI evidence file."""
    items = sorted(net["evidence"].items())
    return f"1\n{len(items)} " + " ".join(f"{k} {x}" for k, x in items) + "\n"


def write_uai(net: dict, directory: str, name: str) -> str:
    """Write ``<directory>/<name>.uai`` and its ``.evid``; the model's path."""
    path = os.path.join(directory, name + ".uai")
    with open(path, "w") as fh:
        fh.write(uai_text(net))
    with open(path + ".evid", "w") as fh:
        fh.write(evidence_text(net))
    return path
