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

**Merged tables.**  A site's dense incidences only ever build one sum,
which depends on nothing but the state of its Markov blanket, and the
tables are fixed for the life of an encoding.  So a live site may walk
one *merged* incidence instead of its own: its scope is the site's
blanket, the distinct rows of its live scope entries in first-seen order
(evidence and tail rows like any other), with C-order mixed-radix strides
over their cards; its table holds, for every blanket configuration, the
float32 sum of the site's incidences' rows, from 0.0 and one add per
incidence in ``f`` order (``fold_rows``: never a pairwise sum), which is
what the kernel's walk of the unmerged incidences adds up, bit for bit.
The kernel needs no other code for it: a merged site is a site with one
incidence.  A site is a candidate when it has a live dense incidence and
its merged table has at most ``MERGE_MAX_ROWS`` rows; the gather bank is
never merged.  The candidates merged are those ``_merge_within_plan``
picks, so that the merged lists and tables launch as the unmerged ones
would (``gibbs_cuda.launch_shapes``).  The header keeps counting the
net's own live work (``H_INCS``, ``H_SCOPE``, ``H_TABLE_FLOATS``: see
``compact_counts``); what the kernel walks is in ``H_WALK_INCS``,
``H_WALK_SCOPE`` and ``H_WALK_FLOATS`` (what ``c_tables`` holds and the
kernel stages), and the number of merged sites in ``H_MERGED``.

  u_lists, u_tables — the same variant's lists and tables with no site
           merged.  The tempered burn-in walks them on scaled tables
           (``ops.sweep.scale_tables``): a merged row scaled is the
           scaled sum, which rounds apart from the sum of the scaled rows
           that the plain version adds.  Same launch shapes as the merged
           lists (``_merge_within_plan``), the same ``c_rows``.
"""

from __future__ import annotations

import numpy as np

#: words of a ``c_lists`` header, and what each holds
HDR = 20
(H_SITES, H_ROWS, H_INCS, H_SCOPE, H_TABLE_FLOATS, H_OFF_COLOR, H_OFF_SITES,
 H_OFF_INCS, H_OFF_SCOPE, H_WORDS, H_GINCS, H_GSCOPE, H_OFF_GSITES, H_OFF_GINCS,
 H_OFF_GSCOPE, H_GTAB0, H_WALK_INCS, H_WALK_SCOPE, H_WALK_FLOATS, H_MERGED) = range(20)

COMPACT_KEYS = ("c_lists", "c_tables", "c_rows", "u_lists", "u_tables")

#: a live site whose merged table (one row per configuration of its
#: Markov blanket) would have at most this many rows may walk it
MERGE_MAX_ROWS = 64

#: capacities are rounded up to these many elements (lists and tables in
#: 16-byte units for the kernel's asynchronous copies, with some slack so
#: that a slightly larger variant still fits the group's tensors)
_ROUND = {"c_lists": 256, "c_tables": 1024, "c_rows": 32, "u_lists": 256, "u_tables": 1024}

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
                    gather=None, merge=None) -> dict:
    """Compact work lists of one variant from its dense kernel-order
    arrays (no leading axis), the card of every kernel row ``row_cards``
    [NVp], where the caller has them the real incidences of ``k_tables``,
    and its gather bank ``gather`` (the ``GATHER_KEYS``, ``gb_scope_vars``
    in kernel rows, and its flat ``tables`` [T]; None or ``Fg`` = 0 for
    none); unpadded.  ``merge`` [L] marks the live sites that walk a
    merged table (None: every site the rule admits, ``MERGE_MAX_ROWS``,
    with no launch budget).  See the module doc for the format."""
    w = _live_work(k_scope, k_strides, k_tables, k_kmask, row_cards, real, gather)
    return _both(w, w["candidate"] if merge is None else np.asarray(merge, dtype=bool),
                 k_tables)


def _both(w, merge, k_tables) -> dict:
    """The lists with the sites ``merge`` on merged tables, and the
    unmerged ones (``u_lists``, ``u_tables``)."""
    out = _lists(w, merge, k_tables)
    unmerged = _lists(w, np.zeros_like(merge), k_tables) if merge.any() else out
    return {**out, "u_lists": unmerged["c_lists"], "u_tables": unmerged["c_tables"]}


def _live_work(k_scope, k_strides, k_tables, k_kmask, row_cards, real, gather) -> dict:
    """The live work of one variant before any merge: its live sites,
    their dense incidences and scope entries, the rows each incidence's
    strides reach, the state rows the lists keep, the gather bank, and
    each live site's Markov blanket (``_blankets``)."""
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
    scope = k_scope[live_site][inc_of_site].astype(np.int64)  # [I, S] kernel rows
    strides = k_strides[live_site][inc_of_site].astype(np.int64)
    live_sc = strides > 0
    if strides.size and strides.max() >= MAX_STRIDE:
        raise ValueError(f"stride {strides.max()} does not fit a scope word")
    bank = _gather_bank(gather, live_site, k_kmask, row_cards)

    site_rows = (ci * G + gi).astype(np.int64)
    read = np.unique(np.concatenate([scope[live_sc], bank["scope"]]))
    rows = np.concatenate([site_rows, read[~np.isin(read, site_rows)]])
    if rows.size > MAX_DENSE_ROWS:
        raise ValueError(f"{rows.size} live state rows do not fit a scope word")
    # rows an incidence's strides can reach: 1 + the largest base
    reach = 1 + ((row_cards[scope] - 1) * strides * live_sc).sum(axis=1)
    n_inc = inc_of_site.sum(axis=1)
    w = {"nc": nc, "K": K, "live_site": live_site, "ci": ci, "gi": gi, "n_inc": n_inc,
         "inc_site": np.repeat(np.arange(ci.size), n_inc), "scope": scope,
         "strides": strides, "live_sc": live_sc, "reach": np.minimum(reach, oa),
         "dense_row": np.flatnonzero(live_inc) * oa,  # row 0 of each in k_tables [-1, K]
         "tables": k_tables[live_site][inc_of_site], "rows": rows, "bank": bank,
         "kbits": (k_kmask[live_site].astype(np.int64) << np.arange(K)).sum(axis=1)}
    w.update(_blankets(w, row_cards, reach <= oa))
    return w


def _blankets(w, row_cards, whole) -> dict:
    """Each live site's Markov blanket: the distinct rows of its live
    scope entries, first seen in ``f`` then ``s`` order (``b_*`` arrays,
    site-major, with their cards and the C-order mixed-radix strides of
    the site's merged table), where each live scope entry lands among
    them (``e_pos``), and the merge rule's candidates with what merging
    each changes: incidences (``d_incs``), scope entries (``d_scope``)
    and table floats (``d_floats``).  ``whole`` [I]: the incidences whose
    strides stay inside their table."""
    L, K = w["ci"].size, w["K"]
    inc_idx, s_idx = np.nonzero(w["live_sc"])  # live entries, in walk order
    e_site = w["inc_site"][inc_idx]
    key = e_site * row_cards.size + w["scope"][inc_idx, s_idx]
    _, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)  # distinct (site, row) pairs in first-seen order
    b_pos = np.empty_like(order)
    b_pos[order] = np.arange(order.size)
    b_first = first[order]
    b_site, b_row = e_site[b_first], w["scope"][inc_idx[b_first], s_idx[b_first]]
    b_card = row_cards[b_row].astype(np.int64)
    # the merge rule, then each candidate's table rows and C-order strides
    nb = np.bincount(b_site, minlength=L)
    ok = np.ones(L, dtype=bool)
    np.logical_and.at(ok, w["inc_site"], whole)
    limit = np.log(MERGE_MAX_ROWS) + 1e-9 if MERGE_MAX_ROWS > 0 else -np.inf
    candidate = (w["n_inc"] > 0) & ok & (
        np.bincount(b_site, np.log(b_card.astype(np.float64)), minlength=L) <= limit)
    start = np.cumsum(nb) - nb
    at = np.arange(b_site.size) - start[b_site]
    on = candidate[b_site]
    b_stride = np.where(on, 1, 0).astype(np.int64)
    for d in range(1, int(nb[candidate].max(initial=0))):
        j = np.flatnonzero(on & (at + d < nb[b_site]))
        b_stride[j] *= b_card[j + d]
    rows = np.where(candidate, 1, 0).astype(np.int64)
    lead = candidate & (nb > 0)
    rows[lead] = b_stride[start[lead]] * b_card[start[lead]]
    return {"b_site": b_site, "b_row": b_row, "b_card": b_card, "b_stride": b_stride,
            "e_pos": b_pos[inverse], "m_rows": rows, "candidate": candidate,
            "d_incs": 1 - w["n_inc"],
            "d_scope": nb - np.bincount(e_site, minlength=L),
            "d_floats": K * (rows - np.bincount(w["inc_site"], w["reach"], minlength=L)
                             .astype(np.int64))}


def _lists(w, merge, k_tables) -> dict:
    """``compact_variant``'s output from the live work ``w`` with the
    live sites ``merge`` [L] (candidates only) on merged tables."""
    if (merge & ~w["candidate"]).any():
        raise ValueError("only the merge rule's candidates can walk a merged table")
    L, K, nc = w["ci"].size, w["K"], w["nc"]
    bank, rows = w["bank"], w["rows"]
    dense_of = np.full(int(rows.max(initial=0)) + 1, -1, dtype=np.int64)
    dense_of[rows] = np.arange(rows.size)

    # the walked incidences: each unmerged site's own, one per merged site
    keep = ~merge[w["inc_site"]]
    msites = np.flatnonzero(merge)
    w_site = np.concatenate([w["inc_site"][keep], msites])
    order = np.argsort(w_site, kind="stable")
    at = np.empty_like(order)
    at[order] = np.arange(order.size)  # walk position of each
    at_kept, at_merged = at[:int(keep.sum())], at[int(keep.sum()):]
    w_reach = np.concatenate([w["reach"][keep], w["m_rows"][msites]])[order]
    first_row = np.cumsum(w_reach) - w_reach

    # their scope entries: an unmerged incidence's own, a merged site's blanket
    inc_idx, s_idx = np.nonzero(w["live_sc"])
    kept_at = np.full(keep.size, -1, dtype=np.int64)
    kept_at[keep] = at_kept
    ek = keep[inc_idx]
    merged_at = np.full(L, -1, dtype=np.int64)
    merged_at[msites] = at_merged
    bm = merge[w["b_site"]]
    q_key = np.concatenate([kept_at[inc_idx[ek]], merged_at[w["b_site"][bm]]])
    so = np.argsort(q_key, kind="stable")
    q_row = np.concatenate([w["scope"][inc_idx[ek], s_idx[ek]], w["b_row"][bm]])[so]
    q_stride = np.concatenate([w["strides"][inc_idx[ek], s_idx[ek]], w["b_stride"][bm]])[so]

    # their tables: an unmerged incidence's rows as they are, a merged
    # site's rows folded from its incidences' rows (``fold_rows``)
    tables = np.zeros((int(w_reach.sum()), K), dtype=np.float32)
    kept = np.flatnonzero(keep)
    r_k = w["reach"][kept]
    off = np.arange(r_k.sum()) - np.repeat(np.cumsum(r_k) - r_k, r_k)
    tables[np.repeat(first_row[at_kept], r_k) + off] = w["tables"][np.repeat(kept, r_k), off]
    fold_rows(k_tables.reshape(-1, K), *_fold_terms(w, msites, first_row[at_merged]), tables)
    tables = tables.reshape(-1)
    if tables.size + bank["tables"].size >= 2 ** 31:
        raise ValueError(f"{tables.size + bank['tables'].size} compact table floats "
                         "exceed int32 offsets")

    sections = [
        np.cumsum(w["live_site"].sum(axis=1)),  # color_end
        np.stack([w["gi"] | (w["kbits"] << 16), np.cumsum(np.where(merge, 1, w["n_inc"]))],
                 axis=1).reshape(-1),  # sites
        np.stack([first_row, np.cumsum(np.bincount(q_key, minlength=order.size))],
                 axis=1).reshape(-1),  # incs
        dense_of[q_row] | (q_stride << 16),  # scope
        bank["site_end"],  # gsites
        np.stack([bank["offset"] + tables.size, bank["self_stride"], bank["scope_end"],
                  np.zeros_like(bank["offset"])], axis=1).reshape(-1),  # gincs
        np.stack([dense_of[bank["scope"]], bank["strides"]], axis=1).reshape(-1),  # gscope
    ]
    head = np.zeros(HDR, dtype=np.int64)
    head[[H_SITES, H_ROWS, H_INCS, H_SCOPE, H_TABLE_FLOATS, H_GINCS, H_GSCOPE, H_GTAB0,
          H_WALK_INCS, H_WALK_SCOPE, H_WALK_FLOATS, H_MERGED]] = (
        L, rows.size, keep.size, inc_idx.size, K * w["reach"].sum() + bank["tables"].size,
        bank["offset"].size, bank["scope"].size, tables.size, order.size, q_row.size,
        tables.size + bank["tables"].size, msites.size)
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


def _fold_terms(w, msites, row0) -> tuple:
    """The terms of the merged tables of sites ``msites``, whose rows
    start at table row ``row0``: for each row ``r`` of a merged site's
    table and each of the site's live incidences, in ``f`` order (the
    term's ``layer``), the row (``dst``) and the incidence's row that the
    blanket configuration ``r`` reads in ``k_tables`` viewed as [-1, K]
    (``src``)."""
    m_rows = w["m_rows"][msites]
    n_pairs = int(m_rows.sum())
    p_site = np.repeat(msites, m_rows)
    p_r = np.arange(n_pairs) - np.repeat(np.cumsum(m_rows) - m_rows, m_rows)
    n_t = w["n_inc"][p_site]
    t_pair = np.repeat(np.arange(n_pairs), n_t)
    layer = np.arange(t_pair.size) - np.repeat(np.cumsum(n_t) - n_t, n_t)
    inc0 = np.cumsum(w["n_inc"]) - w["n_inc"]
    t_inc = inc0[p_site[t_pair]] + layer
    pos = np.full(w["live_sc"].shape, -1, dtype=np.int64)
    pos[w["live_sc"]] = w["e_pos"]
    pos = pos[t_inc]  # [T, S]: the blanket row each scope slot reads
    live = pos >= 0
    stride, card = np.append(w["b_stride"], 1), np.append(w["b_card"], 1)
    pos = np.where(live, pos, stride.size - 1)
    digit = (p_r[t_pair][:, None] // stride[pos]) % card[pos]
    src = w["dense_row"][t_inc] + (digit * w["strides"][t_inc] * live).sum(axis=1)
    return (np.repeat(row0, m_rows) + p_r)[t_pair], src, layer


def fold_rows(rows, dst, src, layer, out) -> None:
    """Set rows ``dst`` of ``out`` [R, K] to their terms' rows of ``rows``
    [X, K] summed in float32 from 0.0, one add a layer, layer by layer:
    the left-to-right sum the kernel makes over a site's incidences (a
    row's terms have distinct layers, a layer's terms distinct rows)."""
    acc = np.zeros_like(out)
    for m in range(int(layer.max(initial=-1)) + 1):
        on = layer == m
        acc[dst[on]] = acc[dst[on]] + rows[src[on]]
    out[dst] = acc[dst]


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
    per tensor and stacked.  The sites on merged tables are those
    ``_merge_within_plan`` picks."""
    n = dense["k_scope"].shape[0]
    banks = [None] * n
    if "gb_offset" in dense:
        banks = [{key: dense[key][i] for key in (*GATHER_KEYS, "gb_scope_vars", "tables")}
                 for i in range(n)]
    works = [_live_work(dense["k_scope"][i], dense["k_strides"][i], dense["k_tables"][i],
                        dense["k_kmask"][i],
                        np.asarray(cards[i])[dense["pal_oon"][i]].astype(np.int64),
                        None if reals is None else reals[i], banks[i])
             for i in range(n)]
    merges = _merge_within_plan(works, "gb_offset" in dense and dense["gb_offset"].shape[-1] > 0)
    per = [_both(w, m, dense["k_tables"][i]) for i, (w, m) in enumerate(zip(works, merges))]
    out = {}
    for key in COMPACT_KEYS:
        cap = compact_capacity(key, max(p[key].size for p in per))
        out[key] = np.stack([np.pad(p[key], (0, cap - p[key].size)) for p in per])
    return out


def _pad4(x):
    return x + (-x % 4)


def _merge_within_plan(works, gather: bool) -> list:
    """The live sites of each variant that walk a merged table: the merge
    rule's candidates, taken in order of incidences saved per table byte
    added (those that add none first), as far as every variant goes with
    one threshold, the lowest whose padded lists and tables launch as the
    unmerged ones (``gibbs_cuda.launch_shapes``): ``plan_launch`` gives
    these variants' launches the form, threads and staging it gives them
    unmerged."""
    from grample_tpu_torch.ops import gibbs_cuda

    K = works[0]["K"]
    rows = compact_capacity("c_rows", max(w["rows"].size for w in works))
    fixed, base, orders, cums = [], [], [], []
    for w in works:
        b = w["bank"]
        fixed.append(HDR + _pad4(w["nc"]) + _pad4(2 * w["ci"].size) + _pad4(b["site_end"].size)
                     + _pad4(4 * b["offset"].size) + _pad4(2 * b["scope"].size))
        base.append((w["n_inc"].sum(), int(w["live_sc"].sum()),
                     K * int(w["reach"].sum()) + b["tables"].size))
        cand = np.flatnonzero(w["candidate"])
        saved, added = -w["d_incs"][cand], 4 * w["d_floats"][cand]
        key = np.where(added <= 0, np.inf, saved / np.maximum(added, 1))
        order = cand[np.argsort(-key, kind="stable")]
        orders.append((order, np.sort(key)[::-1]))
        cums.append([np.concatenate([[0], np.cumsum(w[d][order])])
                     for d in ("d_incs", "d_scope", "d_floats")])

    def shapes(counts):
        lw = max(f + _pad4(2 * (i + c[0][k])) + _pad4(q + c[1][k])
                 for f, (i, q, _), c, k in zip(fixed, base, cums, counts))
        tw = max(t + c[2][k] for (_, _, t), c, k in zip(base, cums, counts))
        return gibbs_cuda.launch_shapes(4 * compact_capacity("c_lists", lw),
                                        4 * compact_capacity("c_tables", tw), rows, K, gather)

    want, pick = shapes([0] * len(works)), [0] * len(works)
    for th in np.unique(np.concatenate([k for _, k in orders])):  # the most merged first
        counts = [int(np.searchsorted(-k, -th, side="right")) for _, k in orders]
        if shapes(counts) == want:
            pick = counts
            break
    out = []
    for w, (order, _), k in zip(works, orders, pick):
        m = np.zeros(w["ci"].size, dtype=bool)
        m[order[:k]] = True
        out.append(m)
    return out


def compact_counts(c_lists) -> np.ndarray:
    """[N, 7] live sites, state rows, dense incidences, dense scope
    entries, table floats (both banks), gather incidences and gather scope
    entries of each variant, read from the headers of ``c_lists``: the
    net's live work, merged or not (``walk_counts`` has what the kernel
    walks)."""
    return np.asarray(c_lists)[:, [H_SITES, H_ROWS, H_INCS, H_SCOPE, H_TABLE_FLOATS,
                                   H_GINCS, H_GSCOPE]]


def merged_sites(kst: dict) -> np.ndarray:
    """[N] live sites on merged tables of each variant of ``kernel_stack``
    output ``kst`` (numpy); 0 where it carries no compact lists."""
    if "c_lists" not in kst:
        return np.zeros(kst["k_kmask"].shape[0], dtype=np.int64)
    return kst["c_lists"][:, H_MERGED].astype(np.int64)


def walk_counts(c_lists) -> np.ndarray:
    """[N, 4] dense incidences, dense scope entries and table floats (both
    banks) that the kernel walks, and live sites on merged tables, of each
    variant of ``c_lists``."""
    return np.asarray(c_lists)[:, [H_WALK_INCS, H_WALK_SCOPE, H_WALK_FLOATS, H_MERGED]]
