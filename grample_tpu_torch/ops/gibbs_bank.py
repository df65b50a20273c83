"""The sweep for both banks, as batched torch ops on the state's device.

Counterpart of ``grample_tpu/ops/gibbs_xla.py`` (``_color_logits``,
``_sample_color``, ``_advance_one``, ``advance_chains``, ``:71-258``): the
reference's sweep for every encoding that its kernel's gate refuses.  It
has two uses.  It is the plain version of the CUDA kernel's gather form
(``ops.gibbs_cuda``), which walks encodings with flat-table gather
incidences (``gb_*``, above all the all-gather mode of collapse-headroom
caps on wide nets): the kernel route runs it for CPU tensors, and the
smoke run holds the kernel against it on the card.  And it is the
torch-ops route for what the port's gate (``ops.sweep.kernel_refusal``)
sends here: cards above 16, and nets with more state rows than the
kernel's packed words or shared memory hold.  It runs where its tensors
live, on the card as on the CPU.

``window_ops`` has the signature and the result of
``ops.gibbs_cuda.gibbs_window`` and ``ops.gibbs_torch.window_plain``.  Per
(sweep, colour), for every variant and every chain of a block at once:

  dense bank   base[n, g, f] = sum_s state[k_scope] * k_strides, then row
               ``base`` of the incidence's local table, summed in ``f`` order
  gather bank  idx[n, g, f, k] = gb_offset + sum_s state[gb_scope_vars] *
               gb_scope_strides + k * gb_self_stride, clamped into the flat
               table and masked after the read, summed in ``Fg`` order and
               added to the dense sum (``gibbs_xla.py:129-141``)
  draw         the kernel's hash cell and inverse-CDF draw
               (``ops.gibbs_torch``), so a dense encoding gives
               ``window_plain``'s result bit for bit

The Python loops are sweeps x colours (and the ``F`` + ``Fg`` ordered
adds); nothing loops over variants or chains.  The reference draws from
``jax.random``; this route keeps the kernel's counter hash instead, so a
group whose caps grow out of the kernel's gate keeps one stream of draws
and a shard of a mesh draws what the unsharded group draws.

The largest intermediate is the gathered scope rows ``[N, G, Fg, S, c]``
int32 (for a Promedus-shaped headroom encoding, G 344, Fg 10, S 9: 124 KB
a chain and variant, so 18 variants x 8192 chains would take 18 GB).
Chains are independent, so a window runs in blocks of chains sized to
keep that tensor under ``BLOCK_BYTES``.
"""

from __future__ import annotations

import torch

from grample_tpu_torch.ops.gibbs_torch import _hash, draw, sweep_counter, window_cell

#: bound on the largest intermediate of one block of chains
BLOCK_BYTES = 1 << 30


def chain_block(kst: dict, chains: int) -> int:
    """Chains one block of ``window_ops`` advances at once."""
    n, _, g, f, s = kst["k_scope"].shape
    fg = kst["gb_offset"].shape[3]
    k = kst["k_kmask"].shape[3]
    per_chain = 4 * n * g * max(f * s, fg * s, f * k, fg * k, 2 * k)
    return max(1, min(int(chains), BLOCK_BYTES // per_chain))


class _Consts:
    """Per-window index constants of a stack ``kst`` whose state has
    ``nvp`` rows a variant, all colours."""

    def __init__(self, kst: dict, nvp: int):
        sc = kst["k_scope"]
        n, nc, g, f, s = sc.shape
        oa, k = kst["k_tables"].shape[4:]
        fg = kst["gb_offset"].shape[3]
        t = kst["tables"].shape[1]
        dev = sc.device
        self.shape = (n, nc, g, f, s, oa, k, fg)
        var0 = torch.arange(n, dtype=torch.int32, device=dev)
        # flat state row ``n * NVp + row`` of every scope entry of the
        # dense and the gather bank: [N, NC, G*F*S], [N, NC, G*Fg*S]
        first = (var0 * nvp).reshape(n, 1, 1)
        self.d_rows = sc.reshape(n, nc, -1) + first
        self.g_rows = kst["gb_scope_vars"].reshape(n, nc, -1) + first
        self.d_str = kst["k_strides"][..., None]  # [N, NC, G, F, S, 1]
        # first row of every incidence's local table in the flat view;
        # int64 only where a stack is too long for int32
        self.d_row0 = (torch.arange(n * nc * g * f, device=dev,
                                    dtype=_index_dtype(n * nc * g * f * oa))
                       .reshape(n, nc, g, f, 1) * oa)
        self.d_tab = kst["k_tables"].reshape(n * nc * g * f * oa, k)
        self.g_str = kst["gb_scope_strides"][..., None]  # [N, NC, G, Fg, S, 1]
        self.g_off = kst["gb_offset"][..., None, None]  # [N, NC, G, Fg, 1, 1]
        kk = torch.arange(k, dtype=torch.int32, device=dev)
        self.g_self = kst["gb_self_stride"][..., None, None] * kk  # [.., Fg, 1, K]
        self.g_mask = kst["gb_mask"].to(torch.float32)[..., None, None]
        # a variant's window into the stacked flat tables
        self.t = t
        self.g_tab0 = var0.to(_index_dtype(n * t)).reshape(n, 1, 1, 1, 1) * t
        self.g_tab = kst["tables"].reshape(n * t)
        self.mask_f = kst["k_kmask"].to(torch.float32)  # [N, NC, G, K]
        self.live = kst["k_kmask"].any(dim=3).to(torch.int32)  # [N, NC, G]


def _index_dtype(length: int):
    return torch.int32 if length < 2 ** 31 else torch.int64


def _ordered_sum(x):
    """Sum [N, G, F, c, K] over ``F`` in index order (one add per slot:
    the float order of the kernel and the plain version)."""
    out = x[:, :, 0]
    for f in range(1, x.shape[2]):
        out = out + x[:, :, f]
    return out


def _logits(cs: _Consts, flat_state, ci: int):
    """[N, G, c, K] unmasked log-conditionals of colour ``ci`` from the
    flat state ``[N * NVp, c]`` int32."""
    n, _, g, f, s, _, k, fg = cs.shape
    c = flat_state.shape[1]
    lg = None
    if f > 0:
        rows = flat_state.index_select(0, cs.d_rows[:, ci].reshape(-1))
        base = (rows.view(n, g, f, s, c) * cs.d_str[:, ci]).sum(dim=3, dtype=torch.int32)
        looked = cs.d_tab.index_select(0, (base + cs.d_row0[:, ci]).reshape(-1))
        lg = _ordered_sum(looked.view(n, g, f, c, k))
    if fg > 0:
        rows = flat_state.index_select(0, cs.g_rows[:, ci].reshape(-1))
        base = (rows.view(n, g, fg, s, c) * cs.g_str[:, ci]).sum(dim=3, dtype=torch.int32)
        # padded slots may point past the table: clamp, read, then mask
        idx = (base[..., None] + cs.g_off[:, ci] + cs.g_self[:, ci]).clamp_(0, cs.t - 1)
        ent = cs.g_tab.index_select(0, (idx + cs.g_tab0).reshape(-1))
        gsum = _ordered_sum(ent.view(n, g, fg, c, k) * cs.g_mask[:, ci])
        lg = gsum if lg is None else lg + gsum
    if lg is None:
        lg = torch.zeros((n, g, c, k), dtype=torch.float32, device=flat_state.device)
    return lg


def color_logits(kst: dict, state_p, ci: int):
    """Unmasked log-conditionals [N, G, C, K] of colour ``ci`` given
    kernel-order state ``state_p`` [N, NVp, C] int32, both banks
    (reference ``gibbs_xla.py::_color_logits``, there [G, K, C] of one
    variant in encode order)."""
    n, nvp, c = state_p.shape
    return _logits(_Consts(kst, nvp), state_p.reshape(n * nvp, c), ci)


def window_ops(kst: dict, state, seed: int, num_sweeps: int, half_point: int,
               count: bool, cb: int):
    """One advance window for all variants on ``state``'s device; returns
    ``(state, counts)`` as ``window_plain`` does: state ``[N, NVp, C]``
    int32 in kernel row order, updated in place; counts
    ``[N, 2, K, NSLOT, C]`` int32 or None.  Only live rows are counted; a
    padding row is overwritten with 0.  Chain ``c`` hashes as lane
    ``c % cb`` of block ``c // cb``."""
    if not state.is_contiguous() or state.dtype != torch.int32:
        raise ValueError("state must be a contiguous int32 tensor")
    nvp, chains = state.shape[1:]
    cs = _Consts(kst, nvp)
    n, nc, g = cs.shape[:3]
    k = cs.shape[6]
    dev = state.device
    counts = (torch.zeros((n, 2, k, nc * g, chains), dtype=torch.int32, device=dev)
              if count else None)
    rid = torch.arange(g, dtype=torch.int64, device=dev)[None, :, None]
    var = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    step = chain_block(kst, chains)
    for c0 in range(0, chains, step):
        chain = torch.arange(c0, min(c0 + step, chains), dtype=torch.int64, device=dev)
        c = chain.numel()
        whole = c == chains
        st = state if whole else state[:, :, c0:c0 + c].contiguous()
        cnt = counts if whole or not count else torch.zeros(
            (n, 2, k, nc * g, c), dtype=torch.int32, device=dev)
        flat = st.view(n * nvp, c)
        lanes = (chain % cb)[None, None, :]
        cell = window_cell(seed, var, (chain // cb)[None, :])  # [N, c]
        for si in range(int(num_sweeps)):
            hsel = int(si >= half_point)
            for ci in range(nc):
                lg = _logits(cs, flat, ci)
                unif = _hash(rid, lanes, sweep_counter(cell, si, nc, ci)[:, None, :])
                newv = draw(lg.view(n * g, c, k), cs.mask_f[:, ci].reshape(n * g, k),
                            unif.view(n * g, c)).view(n, g, c)
                st[:, ci * g:(ci + 1) * g] = newv
                if count:
                    cnt[:, hsel, :, ci * g:(ci + 1) * g].scatter_add_(
                        1, newv[:, None].long(),
                        cs.live[:, ci, None, :, None].expand(n, 1, g, c))
        if not whole:
            state[:, :, c0:c0 + c] = st
            if count:
                counts[..., c0:c0 + c] = cnt
    window_ops.launches += 1
    name = "torch ops, " + ("counted" if count else "uncounted")
    window_ops.launches_by_form[name] = window_ops.launches_by_form.get(name, 0) + 1
    return state, counts


#: windows this route ran, and the same by form, as
#: ``gibbs_cuda.gibbs_window`` counts the kernel's launches
window_ops.launches = 0
window_ops.launches_by_form = {}
