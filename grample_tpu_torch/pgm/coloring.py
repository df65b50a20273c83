"""Moral-graph coloring for chromatic parallel Gibbs.

The reference does sequential random-scan Gibbs (one site at a time,
``sampler/gibbs-simple.go:148-160``) — inherently serial.  This
design replaces it with *chromatic* Gibbs: color the moral graph (two
variables conflict iff they share a factor) and update every variable of
one color simultaneously.  Same-color variables are conditionally
independent given the rest, so a full pass over the colors is a valid
systematic-scan Gibbs sweep targeting the same stationary distribution.

Greedy largest-degree-first coloring; color classes are then split into
balanced groups of at most ``group_cap`` so the padded per-color update
tensors stay rectangular without gross padding waste.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def moral_adjacency(num_vars: int, scopes: Sequence[np.ndarray]) -> List[set]:
    """Adjacency sets of the moral graph derived from factor scopes.

    Same edge derivation as the reference's dot export
    (``cmd/dot.go:35-48``): every pair of variables co-occurring in a
    factor scope is adjacent.  Self-loops are excluded.
    """
    adj: List[set] = [set() for _ in range(num_vars)]
    for scope in scopes:
        us = [int(u) for u in scope]
        for a in us:
            for b in us:
                if a != b:
                    adj[a].add(b)
    return adj


def color_graph(num_vars: int, scopes: Sequence[np.ndarray]) -> np.ndarray:
    """Greedy graph coloring, highest degree first.  Returns color[V]."""
    adj = moral_adjacency(num_vars, scopes)
    order = sorted(range(num_vars), key=lambda v: -len(adj[v]))
    colors = np.full(num_vars, -1, dtype=np.int64)
    for v in order:
        used = {int(colors[u]) for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def verify_coloring(colors: np.ndarray, scopes: Sequence[np.ndarray]) -> None:
    """Assert no factor scope contains two same-colored distinct vars.

    The chromatic-correctness check — the analogue of running tests
    under the Go race detector (SURVEY.md §5): a coloring violation is
    exactly a write-write race between parallel site updates.
    """
    for i, scope in enumerate(scopes):
        us = np.unique(np.asarray(scope, dtype=np.int64))
        cs = colors[us]
        if len(np.unique(cs)) != len(us):
            raise AssertionError(f"coloring violation in factor {i}: scope {us} colors {cs}")


def color_groups(
    colors: np.ndarray, update_ok: np.ndarray, group_cap: int = 0
) -> List[np.ndarray]:
    """Split color classes into update groups.

    Only variables with ``update_ok`` (free: not fixed, not collapsed)
    need scheduling — excluded vars never resample, so dropping them
    shrinks the padded group tensors.  Classes larger than ``group_cap``
    are split (any subset of an independent set is independent).
    """
    groups: List[np.ndarray] = []
    ncolors = int(colors.max()) + 1 if colors.size else 0
    for c in range(ncolors):
        members = np.nonzero((colors == c) & update_ok)[0]
        if members.size == 0:
            continue
        if group_cap and members.size > group_cap:
            for s in range(0, members.size, group_cap):
                groups.append(members[s : s + group_cap])
        else:
            groups.append(members)
    return groups
