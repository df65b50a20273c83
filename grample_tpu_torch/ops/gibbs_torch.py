"""Plain PyTorch version of the whole-window sweep kernel.

Computes what one call of the reference kernel
(``grample_tpu/ops/gibbs_pallas.py::_pallas_window``, body ``:297-422``)
computes, in torch ops, on kernel-ordered state.  The CPU tests hold it
against the reference kernel in interpret mode, and ``chip_smoke.py``
holds the CUDA kernel (``csrc/gibbs_window.cu``) against it on the card.

One window, for each variant n and each sweep si < num_sweeps, for each
color ci, for every chain at once:

  base[g, f]  = sum_s state[k_scope[ci, g, f, s]] * k_strides[ci, g, f, s]
  logit[g, k] = sum_f k_tables[ci, g, f, base[g, f], k]   (f in order)
  masked by k_kmask, max-shifted exp, + 1e-6 * total floor, then one
  hashed uniform per site drawn by inverse CDF; the color block of the
  state is overwritten and, if counting, counts[n, si >= half_point,
  newv, row, chain] += 1.

The hash (``hash_uniform``) is the reference's ``_hash_uniform``
bit for bit: CPU torch has no general uint32 arithmetic, so it runs in
int64 and masks to 32 bits after every multiply and add (int64
wrap-around keeps the low 32 bits of a product exact).
"""

from __future__ import annotations

import torch

FLOOR = 1e-6
NEG = -1e30
_M32 = 0xFFFFFFFF
_INV24 = float(2.0 ** -24)


def hash_uniform(counter, g: int, cb: int, device=None) -> torch.Tensor:
    """Counter-based uniform [g, cb] in [0, 1): two murmur3-finalizer
    rounds over ``row * 0x9E3779B9 ^ lane * 0x85EBCA6B ^ counter``.

    ``counter`` is an int (mod 2^32) or an int64 tensor that broadcasts
    against [g, cb] (the window passes one counter per chain)."""
    rid = torch.arange(g, dtype=torch.int64, device=device)[:, None]
    lane = torch.arange(cb, dtype=torch.int64, device=device)[None, :]
    return _hash(rid, lane, counter)


def _hash(rid, lane, counter):
    x = ((rid * 0x9E3779B9) & _M32) ^ ((lane * 0x85EBCA6B) & _M32)
    x = x ^ (counter & _M32)
    for _ in range(2):
        x = x ^ (x >> 16)
        x = (x * 0x85EBCA6B) & _M32
        x = x ^ (x >> 13)
        x = (x * 0xC2B2AE35) & _M32
        x = x ^ (x >> 16)
    # 24-bit mantissa-exact, as the reference converts through int32
    return (x >> 8).to(torch.int32).to(torch.float32) * _INV24


def window_cell(seed: int, variant: int, block):
    """Per-(variant, chain block) hash base, mod 2^32: the reference
    computes it in int32 with wrap-around (``gibbs_pallas.py:306-310``)."""
    return (int(seed) + 65537 * variant + 257 * block) & _M32


def sweep_counter(cell, sweep: int, nc: int, color: int):
    """Hash counter of one (sweep, color) (``gibbs_pallas.py:396-398``)."""
    return (cell + 2654435761 * ((sweep * nc + color) & _M32)) & _M32


def color_logits(k_scope, k_strides, k_tables, st, ni: int, ci: int):
    """Unmasked log-conditionals [G, C, K] of color ``ci`` of variant
    ``ni`` given kernel-order state ``st`` [NVp, C]: local-table rows
    looked up by each incidence's mixed-radix base, summed in encode
    order."""
    _, _, G, F, S = k_scope.shape
    oa, K = k_tables.shape[4], k_tables.shape[5]
    C = st.shape[1]
    sc = k_scope[ni, ci].reshape(G * F, S).long()
    sd = k_strides[ni, ci].reshape(G * F, S)
    base = torch.zeros((G * F, C), dtype=torch.int64, device=st.device)
    for s in range(S):
        base += st.index_select(0, sc[:, s]).long() * sd[:, s, None]
    rows = torch.arange(G * F, dtype=torch.int64, device=st.device)[:, None] * oa
    tab = k_tables[ni, ci].reshape(G * F * oa, K)
    looked = tab.index_select(0, (rows + base).reshape(-1)).reshape(G, F, C, K)
    lg = looked[:, 0]
    for f in range(1, F):
        lg = lg + looked[:, f]
    return lg


def draw(lg, mk, unif):
    """Inverse-CDF draw [G, C] int32 from logits ``lg`` [G, C, K], in-card
    mask ``mk`` [G, K] (float 0/1) and uniforms ``unif`` [G, C]."""
    K = lg.shape[2]
    logits = [torch.where(mk[:, k, None] > 0, lg[..., k], NEG) for k in range(K)]
    mx = logits[0]
    for k in range(1, K):
        mx = torch.maximum(mx, logits[k])
    ps = [torch.exp(lk - mx) for lk in logits]
    tot = ps[0]
    for k in range(1, K):
        tot = tot + ps[k]
    tot2 = None
    for k in range(K):
        # irreducibility floor (reference gibbs_pallas.py:393-394)
        ps[k] = (ps[k] + tot * FLOOR) * mk[:, k, None]
        tot2 = ps[k] if tot2 is None else tot2 + ps[k]
    u = unif * tot2
    run = torch.zeros_like(u)
    newv = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for k in range(K - 1):
        run = run + ps[k]
        newv += (u > run).to(torch.int32)
    return newv


def window_plain(k_scope, k_strides, k_tables, k_kmask, state, seed: int,
                 num_sweeps: int, half_point: int, count: bool, cb: int):
    """One advance window for all variants; returns ``(state, counts)``.

    k_*: kernel-order constants ``[N, ...]`` (``ops.layout``); state
    ``[N, NVp, C]`` int32, kernel row order (updated in place and
    returned); counts ``[N, 2, K, NSLOT, C]`` int32, zero-initialised
    here, or None when ``count`` is False.  Only live rows (any
    ``k_kmask`` bit) are counted: a padding row's counts stay 0, its
    state is still overwritten with the draw of an all-masked row, 0.
    ``cb`` is the hash's lane width: chain c hashes as lane ``c % cb`` of
    block ``c // cb``.
    """
    n, nc, G = k_scope.shape[:3]
    K = k_tables.shape[5]
    C = state.shape[2]
    dev = state.device
    counts = (torch.zeros((n, 2, K, nc * G, C), dtype=torch.int32, device=dev)
              if count else None)
    chain = torch.arange(C, dtype=torch.int64, device=dev)
    lanes = chain[None, :] % cb
    rid = torch.arange(G, dtype=torch.int64, device=dev)[:, None]
    mask_f = k_kmask.to(torch.float32)  # [N, NC, G, K]
    live = k_kmask.any(dim=3).to(torch.int32)  # [N, NC, G]
    for ni in range(n):
        st = state[ni]  # [NVp, C] view, written in place
        cell = window_cell(seed, ni, chain // cb)  # [C]
        for si in range(int(num_sweeps)):
            hsel = int(si >= half_point)
            for ci in range(nc):
                lg = color_logits(k_scope, k_strides, k_tables, st, ni, ci)
                unif = _hash(rid, lanes, sweep_counter(cell, si, nc, ci)[None, :])
                newv = draw(lg, mask_f[ni, ci], unif)
                st[ci * G:(ci + 1) * G] = newv
                if count:
                    cnt = counts[ni, hsel, :, ci * G:(ci + 1) * G]  # [K, G, C]
                    cnt.scatter_add_(0, newv.long()[None],
                                     live[ni, ci, None, :, None].expand(1, G, C))
    return state, counts
