"""The least time the card could take for a sweep window, and the card.

``site_operations`` counts the arithmetic one site's draw needs by the
window's definition, ``window_bound`` turns a window's live work into a
bound in milliseconds, and ``card_line`` names the card the way
``nvidia-smi`` does.  ``chip_smoke.py`` prints bounds beside its kernel
times; ``grample_tpu_torch.bench`` reports ``est_ops_per_site`` and
``est_tops`` from the same count.
"""

from __future__ import annotations

import subprocess

import numpy as np

#: the card's peaks for a bound: device memory rate (H100 SXM data
#: sheet) and thread operations per clock (132 SMs x 4 schedulers x 32
#: lanes); the clock is the card's ``clocks.max.sm``
PEAK_BYTES_PER_S = 3.35e12
LANES = 132 * 128
#: arithmetic operations of the counter hash: the seed word (a product,
#: two xors), two mixing rounds (three shift-xor pairs and two products
#: each), and the 24-bit uniform (a shift, a conversion, a product)
HASH_OPS = 3 + 2 * 8 + 3


def site_operations(k: int, count: bool, gather: bool = False) -> int:
    """Arithmetic operations of one site's draw at card bound ``k``, as
    the window's definition (``window_plain``; ``window_ops`` with a
    gather bank) needs them, whatever a build emits for them."""
    return (k  # logits outside the card masked
            + (k - 1) + k + k  # the max, its subtraction, exp
            + (k - 1)  # the total
            + 1 + k + k  # the floor: a product, added to each, masked again
            + (k - 1)  # the total again
            + HASH_OPS + 1  # the uniform, scaled by the total
            + (k - 2) + (k - 1) + (k - 1)  # running CDF, compares, outcome
            + (1 if count else 0)  # the count
            + (k if gather else 0))  # the gather sum added to the dense sum


def window_bound(kst, chains, sweeps, count, clock_hz):
    """(bound_ms, bound_by) of one window on ``kst``: the larger of the
    bytes it must move over the card's memory rate (state rows read once,
    site rows written once, live counts written once, lists and tables of
    both banks read once) and the arithmetic its live work needs
    (``site_operations`` per live site, ``k`` table adds per live dense or
    gather incidence, one multiply-add per live scope entry of either
    bank) at one operation per lane and clock, whichever route computes
    it."""
    from grample_tpu_torch.ops import gibbs_cuda
    from grample_tpu_torch.ops.layout import H_WORDS, compact_counts

    live = compact_counts(kst["c_lists"].cpu().numpy()).astype(np.int64)
    sites, rows, incs, scope, tfloats, gincs, gscope = live.sum(axis=0)
    k = kst["k_kmask"].shape[3]
    words = int(kst["c_lists"][:, H_WORDS].sum().item())
    nbytes = 4 * (chains * (rows + sites + (2 * k * sites if count else 0))
                  + words + tfloats)
    gather = gibbs_cuda.uses_gather(kst)
    ops = sweeps * chains * (sites * site_operations(k, count, gather)
                             + (incs + gincs) * k + scope + gscope)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / (LANES * clock_hz) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]
