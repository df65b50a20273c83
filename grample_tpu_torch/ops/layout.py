"""The sweep kernel's row order and count-slot maps.

Counterpart of the layout half of ``grample_tpu.ops.gibbs_pallas.
pallas_stack`` (``:103-160``).  The reference kernel re-sorts each color
group by descending real-incidence degree (a stable sort, so ties keep
encode order) and hashes each site's uniform from its row WITHIN the
color in that order.  The port keeps the same kernel order, so the same
seed draws the same uniform for the same variable.  It does not pack
incidences into banks: that packing serves the TPU's matrix unit.

``kernel_stack`` maps a stacked encoding (``stack_variants`` output,
leading axis N) to:

  k_scope   [N, NC, G, F, S] int32 — neighbour rows, kernel order
  k_strides [N, NC, G, F, S] int32 — local mixed-radix strides
  k_tables  [N, NC, G, F, OA, K] f32 — local log tables
  k_kmask   [N, NC, G, K] uint8 — in-card mask (all 0 on padding rows)
  gb_offset, gb_self_stride, gb_mask [N, NC, G, Fg]; gb_scope_vars,
  gb_scope_strides [N, NC, G, Fg, S]; tables [N, T] f32 — the flat-table
            gather bank (``pgm.encode``) in kernel order, its scope rows
            mapped like ``k_scope``; zero-width (Fg = 0) when the caps
            hold no gather factors.  Only ``ops.gibbs_bank`` reads them.
  pal_oon   [N, NVp] int32 — kernel row -> old var id
  pal_noo   [N, V+1] int32 — old var id -> kernel row
  pal_soo   [N, V+1] int32 — old var id -> kernel count slot (NSLOT: none)

Rows at and beyond ``NC * G`` (sentinel, evidence tail) keep their encode
order and are never written by a sweep.

The dense rectangles above are padded to the caps of the whole group:
on a Promedus-shaped collapse encoding fewer than one slot row in four is
a site, one incidence slot in twelve carries a table, and one scope slot
in eighty has a stride; at its all-gather headroom caps one gather slot
in twelve is live and one gather scope slot in eighty.  A GPU pays for
every padded slot it visits, so ``kernel_stack`` also derives **compact
work lists** (``compact_variant``) that hold the live work only, of both
banks; the CUDA kernel walks these and nothing else.  The dense tensors
stay as the plain versions' input.

  c_lists  [N, LW] int32 — one self-describing blob per variant: a header
           of ``HDR`` words (see ``H_*``), then, each section starting on
           a 4-word boundary,
             color_end [NC]      end index (into sites) of each colour
             sites     [L, 2]    (gi | kmask bits << 16, end index into incs)
             incs      [I, 2]    (first table row, end index into scope)
             scope     [Q]       dense state row | stride << 16
             gsites    [L]       end index (into gincs) of each site
             gincs     [Ig, 4]   (offset into c_tables, self stride, end
                                 index into gscope, 0)
             gscope    [Qg, 2]   (dense state row, stride)
           live sites colour-major in kernel order; a site's live
           incidences of each bank in ``f`` (``Fg``) order; an
           incidence's live scope entries in ``s`` order.  ``gi`` is the
           site's row within its colour in kernel order (its hash row);
           its count slot is ``ci * G + gi``.  The gather sections are
           empty when the encoding has no gather bank (``Fg`` = 0).
  c_tables [N, TW] f32 — the live dense incidences' tables back to back,
           each cut to the rows its strides can reach, ``K`` floats a
           row; then (from float ``H_GTAB0``) the stretches of the flat
           table that live gather incidences can read, back to back
  c_rows   [N, RW] int32 — dense state row -> kernel row: the ``L`` live
           sites first, in list order, then the tail rows that some live
           scope entry of either bank reads.  The kernel keeps these rows
           of a chain's state on chip and no others.

A row is live when its ``k_kmask`` has any bit; a dense incidence when its
site is live and its table is not identically zero (adding an all-zero
row changes no sum: ``x + 0.0f == x``); a gather incidence when its site
is live and its ``gb_mask`` is set; a scope entry of either bank when its
incidence is live and its stride is positive.  A gather stride is a full
int32 word (the reference's full-table strides reach 2^23,
``gibbs_xla.py:133``); a gather incidence reads the flat table at
``offset + sum(state * stride) + k * self_stride`` for the outcomes ``k``
of its site's card, which is what its stretch of the flat table covers.
``LW``, ``TW`` and ``RW`` are the largest need among the stacked
variants, rounded up (``compact_capacity``), so a group's tensors keep one
shape while variants come and go.
"""

from __future__ import annotations

import numpy as np

#: words of a ``c_lists`` header, and what each holds
HDR = 16
(H_SITES, H_ROWS, H_INCS, H_SCOPE, H_TABLE_FLOATS, H_OFF_COLOR, H_OFF_SITES,
 H_OFF_INCS, H_OFF_SCOPE, H_WORDS, H_GINCS, H_GSCOPE, H_OFF_GSITES, H_OFF_GINCS,
 H_OFF_GSCOPE, H_GTAB0) = range(16)

COMPACT_KEYS = ("c_lists", "c_tables", "c_rows")

#: capacities are rounded up to these many elements (lists and tables in
#: 16-byte units for the kernel's asynchronous copies, with some slack so
#: that a slightly larger variant still fits the group's tensors)
_ROUND = {"c_lists": 256, "c_tables": 1024, "c_rows": 32}

#: a scope word packs the dense row into 16 bits and the stride above it
MAX_DENSE_ROWS = 1 << 16
MAX_STRIDE = 1 << 15


def real_incidences(local_tables: np.ndarray) -> np.ndarray:
    """[NC, G, F] bool: the incidences whose local table is not
    identically zero.  An all-zero table adds nothing to any conditional."""
    return np.abs(local_tables).max(axis=(3, 4)) > 0


def kernel_perm(local_tables: np.ndarray, real=None, gb_mask=None) -> np.ndarray:
    """[NC, G] per-color stable descending-degree order of one variant
    (reference ``gibbs_pallas.py:137-140``).  The degree counts the real
    dense incidences (``real_incidences``, computed here unless given)
    and the gather-bank incidences ``gb_mask`` [NC, G, Fg], so one model
    gets one order, and hence one hash row per variable, whichever bank
    its incidences were encoded into.  (A gather incidence counts even
    when its table is identically zero, a dense one does not.)"""
    if real is None:
        real = real_incidences(local_tables)
    degree = real.sum(axis=2)
    if gb_mask is not None:
        degree = degree + np.asarray(gb_mask, dtype=bool).sum(axis=2)
    return np.argsort(-degree, axis=1, kind="stable")


#: the gather bank's per-incidence arrays, re-ordered like the dense ones
GATHER_KEYS = ("gb_offset", "gb_self_stride", "gb_scope_strides", "gb_mask")


def kernel_stack(stack: dict, compact: bool = True) -> dict:
    """Kernel-order sweep constants for a stacked encoding.  ``compact``
    False leaves out the kernel's work lists (``COMPACT_KEYS``) of both
    banks: an encoding that the kernel does not take
    (``ops.sweep.kernel_refusal``) may not fit their packed words."""
    n, nc, G = stack["sw_scope_vars"].shape[:3]
    nvp = stack["old_of_new"].shape[1]
    nslot = nc * G
    out = {k: [] for k in ("k_scope", "k_strides", "k_tables", "k_kmask",
                           "gb_scope_vars", *GATHER_KEYS,
                           "pal_oon", "pal_noo", "pal_soo")}
    reals = []
    ci_idx = np.arange(nc)[:, None]  # pairs with perm [NC, G]
    for i in range(n):
        real = real_incidences(stack["sw_local_tables"][i])
        perm = kernel_perm(stack["sw_local_tables"][i], real, stack["gb_mask"][i])
        reals.append(real[ci_idx, perm])
        shared_of_pal = np.arange(nvp, dtype=np.int32)
        shared_of_pal[:nslot] = (ci_idx * G + perm).reshape(-1)
        pal_of_shared = np.empty_like(shared_of_pal)
        pal_of_shared[shared_of_pal] = np.arange(nvp, dtype=np.int32)
        out["k_scope"].append(
            pal_of_shared[stack["sw_scope_vars"][i][ci_idx, perm]])
        out["k_strides"].append(stack["sw_other_strides"][i][ci_idx, perm])
        out["k_tables"].append(stack["sw_local_tables"][i][ci_idx, perm])
        out["k_kmask"].append(stack["sw_kmask"][i][ci_idx, perm])
        out["gb_scope_vars"].append(
            pal_of_shared[stack["gb_scope_vars"][i][ci_idx, perm]])
        for key in GATHER_KEYS:
            out[key].append(stack[key][i][ci_idx, perm])
        out["pal_oon"].append(stack["old_of_new"][i][shared_of_pal])
        out["pal_noo"].append(pal_of_shared[stack["new_of_old"][i]])
        soo = stack["slot_of_old"][i]  # grouped slots coincide with rows < nslot
        out["pal_soo"].append(
            np.where(soo < nslot, pal_of_shared[np.minimum(soo, nvp - 1)],
                     nslot))
    dtypes = {"k_tables": np.float32, "k_kmask": np.uint8, "gb_mask": np.uint8}
    dense = {k: np.stack(v).astype(dtypes.get(k, np.int32), copy=False)
             for k, v in out.items()}
    dense["tables"] = np.asarray(stack["tables"], dtype=np.float32)
    if not compact:
        return dense
    return {**dense, **compact_stack(dense, stack["cards"], reals)}


def compact_variant(k_scope, k_strides, k_tables, k_kmask, row_cards, real=None,
                    gather=None) -> dict:
    """Compact work lists of one variant from its dense kernel-order
    arrays (no leading axis), the card of every kernel row ``row_cards``
    [NVp], where the caller has them the real incidences of ``k_tables``,
    and its gather bank ``gather`` (the ``GATHER_KEYS``, ``gb_scope_vars``
    in kernel rows, and its flat ``tables`` [T]; None or ``Fg`` = 0 for
    none); unpadded.  See the module doc for the format."""
    nc, G, F, S = k_scope.shape
    oa, K = k_tables.shape[3:]
    if G > MAX_DENSE_ROWS or K > 16:
        raise ValueError(f"group of {G} rows at card {K} does not fit a site word")
    live_site = k_kmask.astype(bool).any(axis=2)  # [NC, G]
    if real is None:
        real = real_incidences(k_tables)
    live_inc = real & live_site[..., None]
    ci, gi = np.nonzero(live_site)  # colour-major, kernel order
    inc_of_site = live_inc[live_site]  # [L, F]
    scope = k_scope[live_site][inc_of_site]  # [I, S] kernel rows
    strides = k_strides[live_site][inc_of_site]
    live_sc = strides > 0
    if strides.size and strides.max() >= MAX_STRIDE:
        raise ValueError(f"stride {strides.max()} does not fit a scope word")
    bank = _gather_bank(gather, live_site, k_kmask, row_cards)

    site_rows = (ci * G + gi).astype(np.int64)
    read = np.unique(np.concatenate([scope[live_sc], bank["scope"]]))
    rows = np.concatenate([site_rows, read[~np.isin(read, site_rows)]])
    if rows.size > MAX_DENSE_ROWS:
        raise ValueError(f"{rows.size} live state rows do not fit a scope word")
    dense_of = np.full(row_cards.shape[0], -1, dtype=np.int64)
    dense_of[rows] = np.arange(rows.size)

    # rows an incidence's strides can reach: 1 + the largest base
    reach = 1 + ((row_cards[scope] - 1) * strides * live_sc).sum(axis=1)
    reach = np.minimum(reach, oa)
    first_row = np.cumsum(reach) - reach
    tables = k_tables[live_site][inc_of_site]  # [I, OA, K]
    tables = tables[np.arange(oa)[None, :] < reach[:, None]].reshape(-1)
    if tables.size + bank["tables"].size >= 2 ** 31:
        raise ValueError(f"{tables.size + bank['tables'].size} compact table floats "
                         "exceed int32 offsets")

    kbits = (k_kmask[live_site].astype(np.int64) << np.arange(K)).sum(axis=1)
    sections = [
        np.cumsum(live_site.sum(axis=1)),  # color_end
        np.stack([gi | (kbits << 16), np.cumsum(inc_of_site.sum(axis=1))],
                 axis=1).reshape(-1),  # sites
        np.stack([first_row, np.cumsum(live_sc.sum(axis=1))], axis=1).reshape(-1),  # incs
        dense_of[scope[live_sc]] | (strides[live_sc].astype(np.int64) << 16),  # scope
        bank["site_end"],  # gsites
        np.stack([bank["offset"] + tables.size, bank["self_stride"], bank["scope_end"],
                  np.zeros_like(bank["offset"])], axis=1).reshape(-1),  # gincs
        np.stack([dense_of[bank["scope"]], bank["strides"]], axis=1).reshape(-1),  # gscope
    ]
    head = np.zeros(HDR, dtype=np.int64)
    head[[H_SITES, H_ROWS, H_INCS, H_SCOPE, H_TABLE_FLOATS, H_GINCS, H_GSCOPE, H_GTAB0]] = (
        ci.size, rows.size, scope.shape[0], int(live_sc.sum()),
        tables.size + bank["tables"].size, bank["offset"].size, bank["scope"].size,
        tables.size)
    words = [head]
    off = HDR
    for h, sec in zip((H_OFF_COLOR, H_OFF_SITES, H_OFF_INCS, H_OFF_SCOPE, H_OFF_GSITES,
                       H_OFF_GINCS, H_OFF_GSCOPE), sections):
        head[h] = off
        sec = np.concatenate([sec, np.zeros(-sec.size % 4, dtype=np.int64)])
        words.append(sec)
        off += sec.size
    head[H_WORDS] = off
    return {"c_lists": np.concatenate(words).astype(np.int32),
            "c_tables": np.concatenate([tables, bank["tables"]]).astype(np.float32),
            "c_rows": rows.astype(np.int32)}


def _gather_bank(gather, live_site, k_kmask, row_cards) -> dict:
    """The live gather work of one variant (``compact_variant``'s
    ``gather``) as flat arrays: each live site's end index into the live
    incidences (``site_end``, empty when the encoding has no gather
    bank); each live incidence's offset into the cut flat table
    ``tables``, self stride and end index into the live scope entries;
    each live scope entry's kernel row and stride."""
    none = np.zeros(0, dtype=np.int64)
    if gather is None or gather["gb_offset"].shape[-1] == 0:
        return {"site_end": none, "offset": none, "self_stride": none, "scope_end": none,
                "scope": none, "strides": none, "tables": np.zeros(0, dtype=np.float32)}
    inc_of_site = gather["gb_mask"].astype(bool)[live_site]  # [L, Fg]
    scope = gather["gb_scope_vars"][live_site][inc_of_site].astype(np.int64)  # [Ig, S]
    strides = gather["gb_scope_strides"][live_site][inc_of_site].astype(np.int64)
    live_sc = strides > 0
    offset = gather["gb_offset"][live_site][inc_of_site].astype(np.int64)
    self_stride = gather["gb_self_stride"][live_site][inc_of_site].astype(np.int64)
    # the kernel reads the outcomes of the site's card (its kmask bits)
    card = (k_kmask[live_site].astype(np.int64) * np.arange(1, k_kmask.shape[-1] + 1)).max(axis=1)
    card = np.repeat(card, inc_of_site.sum(axis=1))
    reach = 1 + ((row_cards[scope] - 1) * strides * live_sc).sum(axis=1) + (card - 1) * self_stride
    tables, offset = _cut_flat(np.asarray(gather["tables"]), offset, reach)
    return {"site_end": np.cumsum(inc_of_site.sum(axis=1)), "offset": offset,
            "self_stride": self_stride, "scope_end": np.cumsum(live_sc.sum(axis=1)),
            "scope": scope[live_sc], "strides": strides[live_sc], "tables": tables}


def _cut_flat(flat: np.ndarray, start: np.ndarray, reach: np.ndarray) -> tuple:
    """The entries of the flat table ``flat`` that the stretches
    ``[start, start + reach)`` cover, back to back, and where each start
    lands among them.  A stretch lies whole in the cut, so an index
    ``start + d`` within it lands ``d`` past its start."""
    edge = np.zeros(flat.size + 1, dtype=np.int64)
    np.add.at(edge, start, 1)
    np.add.at(edge, start + reach, -1)
    covered = np.cumsum(edge[:-1]) > 0
    return flat[covered], (np.cumsum(covered) - 1)[start]


def compact_capacity(key: str, need: int) -> int:
    """The padded length of compact tensor ``key`` for a need of ``need``."""
    m = _ROUND[key]
    return max(m, -(-int(need) // m) * m)


def compact_stack(dense: dict, cards: np.ndarray, reals=None) -> dict:
    """Compact work lists of every variant of ``kernel_stack``'s dense
    output (``cards`` [N, V+1] by old var id; ``reals``: each variant's
    real incidences in kernel order, where the caller has them; the
    gather bank where ``dense`` holds it), zero-padded to one capacity
    per tensor and stacked."""
    banks = [None] * dense["k_scope"].shape[0]
    if "gb_offset" in dense:
        banks = [{key: dense[key][i] for key in (*GATHER_KEYS, "gb_scope_vars", "tables")}
                 for i in range(len(banks))]
    per = [compact_variant(dense["k_scope"][i], dense["k_strides"][i],
                           dense["k_tables"][i], dense["k_kmask"][i],
                           np.asarray(cards[i])[dense["pal_oon"][i]].astype(np.int64),
                           None if reals is None else reals[i], banks[i])
           for i in range(dense["k_scope"].shape[0])]
    out = {}
    for key in COMPACT_KEYS:
        cap = compact_capacity(key, max(p[key].size for p in per))
        out[key] = np.stack([np.pad(p[key], (0, cap - p[key].size)) for p in per])
    return out


def compact_counts(c_lists) -> np.ndarray:
    """[N, 7] live sites, state rows, dense incidences, dense scope
    entries, table floats (both banks), gather incidences and gather scope
    entries of each variant, read from the headers of ``c_lists``."""
    return np.asarray(c_lists)[:, [H_SITES, H_ROWS, H_INCS, H_SCOPE, H_TABLE_FLOATS,
                                   H_GINCS, H_GSCOPE]]
