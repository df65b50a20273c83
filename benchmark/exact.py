"""The plain reference: exact marginals of a net by a two-pass bucket tree.

Independent of the program under test: it reads the benchmark's own net
dict (``benchmark.nets``), clamps the evidence into the tables, picks a
greedy min-fill elimination order over the free vars, passes messages up
the bucket tree while eliminating, then down again, and reads each free
var's marginal from its bucket's belief.  Tables are torch tensors of one
``dtype`` on one ``device``: float64 on the host is the reference; the
same arithmetic in a lower precision is the control of the ``correct``
check (``benchmark.control``).  Every message is normalised to sum 1, so
nothing underflows; a marginal is normalised at the end.
"""

from __future__ import annotations

import string

import numpy as np
import torch

_LETTERS = string.ascii_letters


class Pot:
    """A potential: a tensor with one axis per var of ``scope``."""

    __slots__ = ("scope", "t")

    def __init__(self, scope, t):
        self.scope = tuple(scope)
        self.t = t


def _einsum(pots, out_scope):
    """The product of ``pots`` summed down to ``out_scope``."""
    names = {}
    for p in pots:
        for u in p.scope:
            names.setdefault(u, _LETTERS[len(names)])
    for u in out_scope:
        names.setdefault(u, _LETTERS[len(names)])
    expr = ",".join("".join(names[u] for u in p.scope) for p in pots)
    expr += "->" + "".join(names[u] for u in out_scope)
    return Pot(out_scope, torch.einsum(expr, *[p.t for p in pots]))


def _normalised(p: Pot) -> Pot:
    return Pot(p.scope, p.t / p.t.sum())


def clamped_pots(net: dict, dtype, device) -> list:
    """The net's factors with every evidence var sliced at its value, as
    potentials over free vars only (constants dropped)."""
    cards, ev = net["cards"], net["evidence"]
    pots = []
    for scope, table in net["factors"]:
        arr = np.asarray(table, dtype=np.float64).reshape([cards[u] for u in scope])
        index = tuple(ev[u] if u in ev else slice(None) for u in scope)
        arr = arr[index]
        free = tuple(u for u in scope if u not in ev)
        if free:
            pots.append(Pot(free, torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                                                  device=device)))
    return pots


def min_fill_order(free, pots) -> list:
    """A greedy min-fill elimination order of the ``free`` vars over the
    interaction graph of ``pots`` (ties by min degree, then index)."""
    adj = {u: set() for u in free}
    for p in pots:
        for u in p.scope:
            adj[u].update(w for w in p.scope if w != u)
    cache = {}

    def fill(u):
        if u not in cache:
            nb = list(adj[u])
            cache[u] = (sum(1 for i, a in enumerate(nb) for b in nb[i + 1:] if b not in adj[a]),
                        len(nb), u)
        return cache[u]

    order = []
    left = set(free)
    while left:
        v = min((fill(u) for u in left))[2]
        nb = adj.pop(v)
        left.discard(v)
        touched = set(nb)
        for a in nb:
            adj[a].discard(v)
            adj[a].update(b for b in nb if b != a)
            touched.update(adj[a])
        for u in touched:
            cache.pop(u, None)
        order.append(v)
    return order


def exact_marginals(net: dict, dtype=torch.float64, device="cpu") -> np.ndarray:
    """[V, max card] float64 marginals of ``net`` under its evidence: a
    free var's exact marginal, an evidence var's point mass, zeros beyond
    a var's card.  The arithmetic runs in ``dtype`` on ``device``."""
    cards = net["cards"]
    ev = net["evidence"]
    free = [u for u in range(len(cards)) if u not in ev]
    pots = clamped_pots(net, dtype, device)
    order = min_fill_order(free, pots)
    rank = {u: i for i, u in enumerate(order)}
    # buckets: each potential goes to the bucket of its first-eliminated var
    # (a ones potential over each var keeps every bucket non-empty)
    own = {u: [Pot((u,), torch.ones(cards[u], dtype=dtype, device=device))] for u in order}
    for p in pots:
        own[min(p.scope, key=rank.__getitem__)].append(p)
    up = {}  # child var -> (parent var or None, message)
    inbox = {u: [] for u in order}  # var -> child vars whose messages it holds
    for v in order:
        parts = own[v] + [up[c][1] for c in inbox[v]]
        scope = sorted({u for p in parts for u in p.scope}, key=rank.__getitem__)
        msg = _normalised(_einsum(parts, [u for u in scope if u != v]))
        parent = min(msg.scope, key=rank.__getitem__) if msg.scope else None
        up[v] = (parent, msg)
        if parent is not None:
            inbox[parent].append(v)
    down = {}  # var -> message from its parent
    out = np.zeros((len(cards), max(cards)), dtype=np.float64)
    for v in reversed(order):
        parts = own[v] + ([down[v]] if v in down else [])
        kids = inbox[v]
        for c in kids:
            others = parts + [up[k][1] for k in kids if k != c]
            down[c] = _normalised(_einsum(others, up[c][1].scope))
        belief = _einsum(parts + [up[k][1] for k in kids], [v])
        m = belief.t.to(torch.float64).cpu().numpy()
        out[v, :cards[v]] = m / m.sum()
    for u, x in ev.items():
        out[u, x] = 1.0
    return out


def free_mask(net: dict) -> np.ndarray:
    """[V] bool: the vars without evidence."""
    mask = np.ones(len(net["cards"]), dtype=bool)
    mask[list(net["evidence"])] = False
    return mask


def hellinger(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Row-wise Hellinger distance of two [V, K] arrays of distributions."""
    return np.sqrt(np.maximum(0.0, 0.5 * ((np.sqrt(p) - np.sqrt(q)) ** 2).sum(axis=1)))
