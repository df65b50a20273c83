"""The yardstick of a sweep: operations and bytes counted from the net, and
the card's peaks.

A site update of free var ``i`` (card ``k``) needs, by the definition of
a chromatic Gibbs draw from a factor graph:

* ``site_operations(k)``: the draw itself (the logits' max, exponentials,
  totals, a counter-hash uniform, the running CDF, the count);
* ``k`` table adds for each factor that holds ``i``;
* one multiply-add for each other free var in such a factor's scope (its
  state times its stride, to index the table).

Evidence vars are clamped into the tables and cost nothing.  Bytes: a
window of ``cw`` sweeps reads each chain's state once and writes it once
(4 bytes a var) and writes each counted var's counts once (4 bytes an
outcome); spread over the window's site updates that is
``(8 + 4 * k) / cw`` bytes a site.  Collapse variants of an adaptive run
are counted as the plain net: the yardstick reads the net, not the
program's encoding, so a change of layout cannot move it.
"""

from __future__ import annotations

#: the counter hash's arithmetic: the seed word (a product, two xors), two
#: mixing rounds (three shift-xor pairs and two products each), and the
#: 24-bit uniform (a shift, a conversion, a product)
HASH_OPS = 3 + 2 * 8 + 3

#: peaks by card name, as ``torch.cuda.get_device_name`` gives it: lanes
#: (thread operations a clock) per SM, and the device memory's rate (NVIDIA's
#: H100 SXM data sheet); the SM count comes from the card's properties and
#: the clock from ``nvidia-smi``'s ``clocks.max.sm`` in the same run
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"lanes_per_sm": 128, "bytes_per_s": 3.35e12},
}


def site_operations(k: int) -> int:
    """Arithmetic operations of one counted site draw at card ``k``."""
    return (k  # logits outside the card masked
            + (k - 1) + k + k  # the max, its subtraction, exp
            + (k - 1)  # the total
            + 1 + k + k  # the floor: a product, added to each, masked again
            + (k - 1)  # the total again
            + HASH_OPS + 1  # the uniform, scaled by the total
            + (k - 2) + (k - 1) + (k - 1)  # running CDF, compares, outcome
            + 1)  # the count


def net_operations(net: dict) -> tuple:
    """(operations of one sweep over the net's free vars, free vars,
    outcomes summed over the free vars)."""
    cards, ev = net["cards"], net["evidence"]
    ops, free, outcomes = 0, 0, 0
    incident = {u: [] for u in range(len(cards))}
    for scope, _ in net["factors"]:
        for u in scope:
            incident[u].append(scope)
    for u, k in enumerate(cards):
        if u in ev:
            continue
        free += 1
        outcomes += k
        ops += site_operations(k)
        for scope in incident[u]:
            ops += k + sum(1 for w in scope if w != u and w not in ev)
    return ops, free, outcomes


def least_seconds(net: dict, sites: float, cw_sweeps: int, peak_ops: float,
                  peak_bytes: float) -> tuple:
    """(least seconds for ``sites`` counted site updates of ``net`` in
    windows of ``cw_sweeps``, "operations" or "bytes": which bound it)."""
    ops, free, outcomes = net_operations(net)
    by_ops = sites * ops / free / peak_ops
    by_bytes = sites * (8 + 4 * outcomes / free) / cw_sweeps / peak_bytes
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
