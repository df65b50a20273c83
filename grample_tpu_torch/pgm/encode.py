"""Dense tensor encoding of a factor graph for the Gibbs sweep.

The counterpart of ``grample_tpu.pgm.encode``: the whole topology is
compiled once into padded integer arrays so the per-sweep compute is
O(blanket) per site, vectorized over (chains × variables-of-a-color).

Var-major adjacency (host tools and tests):

  - ``tables``         [T]          all log-space factor tables, concatenated
  - ``adj_offset``     [V+1, F]     table offset of the j-th factor of var v
  - ``adj_self_stride``[V+1, F]     stride of v inside that factor's table
  - ``adj_mask``       [V+1, F]     valid-factor mask
  - ``adj_scope_vars`` [V+1, F, S]  scope var ids of that factor
  - ``adj_scope_strides``[V+1,F,S]  matching strides (own position 0)
  - ``color_vars``     [NC, G]      var ids per chromatic update group
  - ``color_mask``     [NC, G]      valid-entry mask

Sweep views are COLOR-MAJOR, one bank per (var, incident factor) pair
classified by the factor's *local* table size OA = table_size / card(var):

  - **dense bank** (OA <= ``oa_dense_cap``): the table slice seen from v
    is pre-gathered into a LOCAL table [OA, K]; the sweep computes a
    local mixed-radix base index from the neighbours' states
    (``sw_scope_vars`` × ``sw_other_strides``) and reads row ``base``.
  - **gather bank** ``gb_*`` (larger incidences): indexes the flat
    ``tables`` array directly.  The CUDA kernel walks it in its gather
    form (``ops.gibbs_cuda``), from compact lists and the stretches of
    ``tables`` that live incidences read (``ops.layout``); its plain
    version is ``ops.gibbs_bank.window_ops``.  The collapsed sampler's variants
    never use it: ``caps_for_variants`` raises the dense threshold to
    their widest incidence, which the collapse guard bounds.

**Color-contiguous renumbering.**  The sweep operates on a permuted
variable space in which each chromatic group's variables occupy a
contiguous block of rows: row of group-slot ``(ci, g)`` is ``ci*G + g``,
followed by one sentinel row and a tail block for ungrouped vars
(evidence).  ``new_of_old`` / ``old_of_new`` / ``slot_of_old`` map between
the layouts once per advance window.  All index padding points at the
sentinel row (card 1, never updated), so gathers stay in bounds.

The reference also builds per-color stride matrices (``sw_wbase``) for a
base-index matmul on the TPU's matrix unit; the port indexes directly
and has no such mode.  Shapes are *capacities*: every variant of a model
is padded to the same ``EncodeCaps`` so one sweep serves all variants,
stacked on a leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from grample_tpu_torch.pgm.coloring import color_graph, color_groups, verify_coloring
from grample_tpu_torch.pgm.discrete import LOG_EPS, MAX_TABLE_SIZE, DiscreteModel, table_strides

#: Largest local-table row count the dense bank materializes for PLAIN
#: encodings; bigger local tables go to the gather bank instead of
#: inflating the padded [*, OA, K] tensors.
OA_DENSE_CAP = 32

#: Largest base-model incidence (local rows) the encoder will dense-ify
#: to keep a model's encoding free of live gather-bank rows: when the
#: largest base incidence fits this bound, the dense threshold is raised
#: to cover it.
BASE_DENSE_LIMIT = 1024

#: Dense classification cap for collapse-headroom encodings (collapse
#: replacement factors routinely exceed 32 local rows).
COLLAPSE_OA_DENSE_CAP = 256

#: Total dense local-table bytes across all stacked variant slots before
#: the encoding abandons the dense bank for the all-gather mode.
LOCAL_TABLES_TOTAL_BUDGET = 2 * 1024 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class EncodeCaps:
    """Static shape capacities shared by all variants of one model."""

    num_vars: int  # V (without sentinel)
    max_card: int  # K
    adj_cap: int  # F: max dense-bank factors per variable
    scope_cap: int  # S: max scope size
    table_cap: int  # T: flat table length
    color_cap: int  # NC: max chromatic groups
    group_cap: int  # G: max vars per group
    oa_cap: int = 1  # OA: dense-bank local-table rows
    gfac_cap: int = 0  # Fg: gather-bank factors per variable
    tail_cap: int = 8  # ungrouped (evidence/collapsed) var rows
    slot_hint: int = 1  # expected stacked variants (sizes the table budget)
    #: "rowgather" (dense local-table bank, base indices by gathers) or
    #: "gather" (every incidence in the flat-table gather bank)
    base_mode: str = "rowgather"
    #: dense-classification threshold (local rows) used for every
    #: incidence encoded against these caps
    oa_dense_cap: int = 32

    @property
    def num_rows(self) -> int:
        """Rows of the permuted state: group blocks + sentinel + tail
        (rounded to 8, as in the reference; extra rows are dead)."""
        return _roundup(self.color_cap * self.group_cap + 1 + self.tail_cap, 8)

    @property
    def num_slots(self) -> int:
        """Group-slot rows (the color-major count tensor's var axis)."""
        return self.color_cap * self.group_cap

    @property
    def sentinel_row(self) -> int:
        return self.color_cap * self.group_cap

    def fits(self, other: "EncodeCaps") -> bool:
        return (
            self.num_vars == other.num_vars
            and self.max_card >= other.max_card
            and self.adj_cap >= other.adj_cap
            and self.scope_cap >= other.scope_cap
            and self.table_cap >= other.table_cap
            and self.color_cap >= other.color_cap
            and self.group_cap >= other.group_cap
            and self.oa_cap >= other.oa_cap
            and self.gfac_cap >= other.gfac_cap
            and self.tail_cap >= other.tail_cap
            and self.slot_hint >= other.slot_hint
            and self.base_mode == other.base_mode
            and self.oa_dense_cap == other.oa_dense_cap
        )


def _roundup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m if m > 1 else x


@dataclasses.dataclass
class EncodedModel:
    """One model variant, encoded to dense numpy arrays (see module doc)."""

    caps: EncodeCaps
    cards: np.ndarray  # [V+1] int32 (sentinel card 1)
    fixed: np.ndarray  # [V+1] int32
    collapsed: np.ndarray  # [V+1] bool
    update_ok: np.ndarray  # [V+1] bool — vars the sweep resamples
    tables: np.ndarray  # [T] float32, log space
    adj_offset: np.ndarray  # [V+1, F] int32
    adj_self_stride: np.ndarray  # [V+1, F] int32
    adj_mask: np.ndarray  # [V+1, F] bool
    adj_scope_vars: np.ndarray  # [V+1, F, S] int32
    adj_scope_strides: np.ndarray  # [V+1, F, S] int32
    color_vars: np.ndarray  # [NC, G] int32 (sentinel-padded)
    color_mask: np.ndarray  # [NC, G] bool
    num_colors: int
    # Exact marginal for collapsed vars (uniform elsewhere), padded [V+1, K]
    exact_marginals: np.ndarray  # float64
    # ---- layout maps (old var order <-> permuted rows) ---------------------
    new_of_old: np.ndarray = None  # [V+1] int32 -> row
    old_of_new: np.ndarray = None  # [NVp] int32 -> old var (padding -> V)
    slot_of_old: np.ndarray = None  # [V+1] int32 -> count slot (else num_slots)
    # ---- dense color-major bank -------------------------------------------
    # Seen from variable v and its j-th incident factor, the factor table
    # splits into OA "other assignments" × K own values: a LOCAL table.
    # Scope vars are in the PERMUTED numbering.
    sw_scope_vars: np.ndarray = None  # [NC, G, F, S] int32 (own pos → sentinel)
    sw_other_strides: np.ndarray = None  # [NC, G, F, S] int32 local mixed radix
    sw_local_tables: np.ndarray = None  # [NC, G, F, OA, K] f32 log (padding 0)
    sw_kmask: np.ndarray = None  # [NC, G, K] bool
    # ---- gather color-major bank (giant factors) --------------------------
    gb_offset: np.ndarray = None  # [NC, G, Fg] int32 into ``tables``
    gb_self_stride: np.ndarray = None  # [NC, G, Fg] int32
    gb_scope_vars: np.ndarray = None  # [NC, G, Fg, S] int32 (permuted)
    gb_scope_strides: np.ndarray = None  # [NC, G, Fg, S] int32
    gb_mask: np.ndarray = None  # [NC, G, Fg] bool

    def arrays(self) -> dict:
        """The fields the sweep consumes, as a dict of numpy arrays."""
        return dict(
            cards=self.cards,
            fixed=self.fixed,
            new_of_old=self.new_of_old,
            old_of_new=self.old_of_new,
            slot_of_old=self.slot_of_old,
            sw_scope_vars=self.sw_scope_vars,
            sw_other_strides=self.sw_other_strides,
            sw_local_tables=self.sw_local_tables,
            sw_kmask=self.sw_kmask,
            tables=self.tables,
            gb_offset=self.gb_offset,
            gb_self_stride=self.gb_self_stride,
            gb_scope_vars=self.gb_scope_vars,
            gb_scope_strides=self.gb_scope_strides,
            gb_mask=self.gb_mask,
        )

    def legacy_arrays(self) -> dict:
        """Var-major adjacency view (reference-shaped; tests/host tools)."""
        return dict(
            cards=self.cards,
            tables=self.tables,
            adj_offset=self.adj_offset,
            adj_self_stride=self.adj_self_stride,
            adj_mask=self.adj_mask,
            adj_scope_vars=self.adj_scope_vars,
            adj_scope_strides=self.adj_scope_strides,
            color_vars=self.color_vars,
            color_mask=self.color_mask,
            update_ok=self.update_ok,
            fixed=self.fixed,
        )


def _classify_local(
    table_size: int, card: int, dense_ok: bool = True, cap: int = OA_DENSE_CAP
) -> tuple:
    """(is_dense, oa_rows) for one (var, factor) incidence."""
    rows = int(table_size) // int(card)
    return dense_ok and rows <= cap, rows


def compute_caps(
    m: DiscreteModel,
    headroom_factors: int = 2,
    headroom_table: int = 4096,
    group_cap: int = 0,
    collapse_headroom: bool = False,
    slot_hint: int = 1,
    oa_dense_cap: int = 0,
) -> EncodeCaps:
    """Measure a model and pick capacities.

    ``collapse_headroom=True`` adds room for collapse variants up front
    (collapse replaces a var's factors with one blanket factor, which can
    have a larger scope/table).  ``oa_dense_cap`` (0 = default) sets the
    dense-classification threshold: ``COLLAPSE_OA_DENSE_CAP`` for
    collapse-headroom caps, ``OA_DENSE_CAP`` otherwise.

    Two tiers: the dense local-table bank, unless its tables across
    ``slot_hint`` stacked variants would exceed
    ``LOCAL_TABLES_TOTAL_BUDGET``, in which case every incidence is
    reclassified into the flat-table gather bank (``"gather"``).
    """
    if oa_dense_cap <= 0:
        oa_dense_cap = COLLAPSE_OA_DENSE_CAP if collapse_headroom else OA_DENSE_CAP
    base_max_oa = max(
        (int(f.table.size) // int(m.cards[int(u)]) for f in m.factors
         for u in f.scope),
        default=1,
    )
    if oa_dense_cap < base_max_oa <= BASE_DENSE_LIMIT:
        # keep the base encoding free of live gather rows (see
        # BASE_DENSE_LIMIT): raise the dense threshold to the largest
        # base incidence
        oa_dense_cap = base_max_oa
    caps = _compute_caps_once(
        m, headroom_factors, headroom_table, group_cap, collapse_headroom,
        slot_hint, dense_ok=True, oa_dense_cap=oa_dense_cap,
    )
    lt = (
        caps.color_cap * caps.group_cap * caps.adj_cap
        * caps.oa_cap * caps.max_card * 4
    )
    if lt * max(slot_hint, 1) > LOCAL_TABLES_TOTAL_BUDGET:
        caps = _compute_caps_once(
            m, headroom_factors, headroom_table, group_cap,
            collapse_headroom, slot_hint, dense_ok=False,
            oa_dense_cap=oa_dense_cap,
        )
    return caps


def _compute_caps_once(
    m: DiscreteModel,
    headroom_factors: int,
    headroom_table: int,
    group_cap: int,
    collapse_headroom: bool,
    slot_hint: int,
    dense_ok: bool,
    oa_dense_cap: int = OA_DENSE_CAP,
) -> EncodeCaps:
    v = m.num_vars
    nfac = np.zeros(v + 1, dtype=np.int64)
    ngfac = np.zeros(v + 1, dtype=np.int64)
    max_scope = 1
    tab_total = 0
    oa_cap = 1
    for f in m.factors:
        for u in f.scope:
            dense, rows = _classify_local(
                f.table.size, m.cards[int(u)], dense_ok, oa_dense_cap
            )
            if dense:
                nfac[int(u)] += 1
                oa_cap = max(oa_cap, rows)
            else:
                ngfac[int(u)] += 1
        max_scope = max(max_scope, int(f.scope.size))
        tab_total += int(f.table.size)

    colors = color_graph(v, [f.scope for f in m.factors])
    if group_cap <= 0:
        group_cap = pick_group_cap(colors, np.asarray(m.free_mask))
    groups = color_groups(colors, np.asarray(m.free_mask), group_cap)
    # slot width rounded to 8, as in the reference
    gcap = _roundup(max((g.size for g in groups), default=1), 8)

    collapse_scope = 0
    collapse_table = 0
    gfac_cap = int(ngfac.max())
    if collapse_headroom:
        # Collapse headroom: new factor scope = blanket-1 vars (<= 11 by
        # the NeighborVarMax=12 policy); only tables within
        # MAX_TABLE_SIZE are ever built, and variants whose replacement
        # incidences exceed the dense cap are never built either.
        blankets = m.blankets()
        for i, b in enumerate(blankets):
            if 1 < len(b) <= 12:
                rest = [u for u in b if u != i]
                tsize = int(
                    np.prod(m.cards[rest], dtype=np.float64).clip(max=2 * MAX_TABLE_SIZE)
                )
                if tsize <= MAX_TABLE_SIZE and all(
                    tsize // int(m.cards[u]) <= oa_dense_cap for u in rest
                ):
                    collapse_scope = max(collapse_scope, len(rest))
                    collapse_table = max(collapse_table, tsize)
                    for u in rest:
                        dense, rows = _classify_local(
                            tsize, m.cards[u], dense_ok, oa_dense_cap
                        )
                        if dense:
                            oa_cap = max(oa_cap, rows)
                        else:
                            gfac_cap = max(gfac_cap, int(ngfac[u]) + 1)

    ungrouped = v - sum(int(g.size) for g in groups)
    return EncodeCaps(
        num_vars=v,
        max_card=m.max_card,
        adj_cap=int(nfac.max()) + (headroom_factors if dense_ok else 0),
        scope_cap=max(max_scope, collapse_scope),
        table_cap=_roundup(tab_total + max(collapse_table, headroom_table), 1024),
        color_cap=len(groups) + (2 if collapse_headroom else 0),
        group_cap=gcap,
        oa_cap=oa_cap,
        gfac_cap=gfac_cap + (headroom_factors if not dense_ok else 0),
        tail_cap=_roundup(ungrouped + (16 if collapse_headroom else 1), 8),
        slot_hint=max(1, slot_hint),
        base_mode="rowgather" if dense_ok else "gather",
        oa_dense_cap=oa_dense_cap,
    )


def pick_group_cap(colors: np.ndarray, free_mask: np.ndarray) -> int:
    """Balanced chromatic group size: split oversized color classes.

    Any subset of an independent set is independent, so a color class may
    be updated in chunks; splitting keeps the padded [NC, G] slot grid
    close to the true free-variable count when class sizes are skewed.
    """
    sizes = []
    ncolors = int(colors.max()) + 1 if colors.size else 0
    for c in range(ncolors):
        n = int(((colors == c) & free_mask).sum())
        if n:
            sizes.append(n)
    if not sizes:
        return 8
    total = sum(sizes)
    # allow 2x imbalance over a perfectly balanced split before chunking
    target = _roundup(max(8, (total + len(sizes) - 1) // len(sizes)), 8) * 2
    return _roundup(min(max(sizes), target), 8)


_MODE_RANK = {"rowgather": 0, "gather": 1}


def merge_caps(a: EncodeCaps, b: EncodeCaps) -> EncodeCaps:
    """Elementwise max of two capacity sets (same model)."""
    if a.num_vars != b.num_vars:
        raise ValueError("cannot merge caps of different models")
    return EncodeCaps(
        num_vars=a.num_vars,
        max_card=max(a.max_card, b.max_card),
        adj_cap=max(a.adj_cap, b.adj_cap),
        scope_cap=max(a.scope_cap, b.scope_cap),
        table_cap=max(a.table_cap, b.table_cap),
        color_cap=max(a.color_cap, b.color_cap),
        group_cap=max(a.group_cap, b.group_cap),
        oa_cap=max(a.oa_cap, b.oa_cap),
        gfac_cap=max(a.gfac_cap, b.gfac_cap),
        tail_cap=max(a.tail_cap, b.tail_cap),
        slot_hint=max(a.slot_hint, b.slot_hint),
        # merging never re-enables a tier the budget check rejected
        base_mode=max(a.base_mode, b.base_mode, key=_MODE_RANK.__getitem__),
        oa_dense_cap=max(a.oa_dense_cap, b.oa_dense_cap),
    )


def caps_for_variants(
    models, slot_hint: int = 1, oa_dense_cap: int = 0
) -> EncodeCaps:
    """Exact merged capacities over a KNOWN variant list (no headroom).

    The collapsed sampler builds its whole variant set before the first
    sweep, so it measures the variants instead of estimating collapse
    headroom.  ``oa_dense_cap`` defaults to the largest actual incidence
    (at least ``OA_DENSE_CAP``); the per-variant guard
    ``is_collapsible(oa_cap=COLLAPSE_OA_DENSE_CAP)`` bounds it upstream.
    """
    if not models:
        raise ValueError("caps_for_variants: empty variant list")
    if oa_dense_cap <= 0:
        oa_dense_cap = max(
            max(
                (int(f.table.size) // int(mv.cards[int(u)])
                 for f in mv.factors for u in f.scope),
                default=1,
            )
            for mv in models
        )
        oa_dense_cap = max(oa_dense_cap, OA_DENSE_CAP)
    caps = None
    for mv in models:
        c = compute_caps(
            mv, headroom_factors=0, slot_hint=slot_hint,
            oa_dense_cap=oa_dense_cap,
        )
        caps = c if caps is None else merge_caps(caps, c)
    return caps


def encode_model(
    m: DiscreteModel, caps: Optional[EncodeCaps] = None, group_cap: int = 0
) -> EncodedModel:
    """Encode one model (or collapse variant) against fixed capacities."""
    if caps is None:
        caps = compute_caps(m, group_cap=group_cap)
    v, k = caps.num_vars, caps.max_card
    if m.num_vars != v:
        raise ValueError("variant variable count differs from caps")
    if m.max_card > k:
        raise ValueError("variant max card exceeds caps")
    sent = v  # sentinel var index

    cards = np.ones(v + 1, dtype=np.int32)
    cards[:v] = m.cards
    fixed = np.zeros(v + 1, dtype=np.int32)
    fixed[:v] = m.fixed
    fixed[sent] = 0  # sentinel is pinned
    collapsed = np.zeros(v + 1, dtype=bool)
    collapsed[:v] = m.collapsed
    update_ok = np.zeros(v + 1, dtype=bool)
    update_ok[:v] = m.free_mask

    # ---- flat log tables + adjacency ------------------------------------
    nf = len(m.factors)
    offsets = np.zeros(nf, dtype=np.int64)
    pos = 0
    tables = np.zeros(caps.table_cap, dtype=np.float32)
    for fi, f in enumerate(m.factors):
        offsets[fi] = pos
        t = f.table
        if not f.is_log:
            t = np.log(np.where(t < LOG_EPS, t + LOG_EPS, t))
        if pos + t.size > caps.table_cap:
            raise ValueError(
                f"table capacity {caps.table_cap} exceeded at factor {fi}"
            )
        tables[pos : pos + t.size] = t.astype(np.float32)
        pos += t.size

    F, S, Fg = caps.adj_cap, caps.scope_cap, caps.gfac_cap
    # legacy var-major adjacency over ALL incident factors (dense + gather)
    FA = F + Fg
    adj_offset = np.zeros((v + 1, FA), dtype=np.int32)
    adj_self_stride = np.zeros((v + 1, FA), dtype=np.int32)
    adj_mask = np.zeros((v + 1, FA), dtype=bool)
    adj_scope_vars = np.full((v + 1, FA, S), sent, dtype=np.int32)
    adj_scope_strides = np.zeros((v + 1, FA, S), dtype=np.int32)

    OA = caps.oa_cap
    d_scope_vars = np.full((v + 1, F, S), sent, dtype=np.int32)
    d_other_strides = np.zeros((v + 1, F, S), dtype=np.int32)
    d_local_tables = np.zeros((v + 1, F, OA, k), dtype=np.float32)

    g_offset = np.zeros((v + 1, Fg), dtype=np.int32)
    g_self_stride = np.zeros((v + 1, Fg), dtype=np.int32)
    g_scope_vars = np.full((v + 1, Fg, S), sent, dtype=np.int32)
    g_scope_strides = np.zeros((v + 1, Fg, S), dtype=np.int32)
    g_mask = np.zeros((v + 1, Fg), dtype=bool)

    nseen = np.zeros(v + 1, dtype=np.int64)
    ndense = np.zeros(v + 1, dtype=np.int64)
    ngather = np.zeros(v + 1, dtype=np.int64)
    for fi, f in enumerate(m.factors):
        strides = table_strides(m.cards[f.scope])
        if f.scope.size > S:
            raise ValueError(f"factor {f.name} scope {f.scope.size} exceeds cap {S}")
        tlog = tables[offsets[fi] : offsets[fi] + f.table.size]
        shaped = tlog.reshape(tuple(int(c) for c in m.cards[f.scope]))
        for p, u in enumerate(f.scope):
            u = int(u)
            j = nseen[u]
            if j >= FA:
                raise ValueError(f"var {u} has more than {FA} factors")
            nseen[u] = j + 1
            adj_offset[u, j] = offsets[fi]
            adj_self_stride[u, j] = strides[p]
            adj_mask[u, j] = True
            adj_scope_vars[u, j, : f.scope.size] = f.scope
            ss = strides.copy()
            ss[p] = 0  # own position: contribution comes via k * self_stride
            adj_scope_strides[u, j, : f.scope.size] = ss

            cu = int(m.cards[u])
            dense, rows = _classify_local(
                f.table.size, cu, caps.base_mode != "gather", caps.oa_dense_cap,
            )
            if dense:
                jd = ndense[u]
                if jd >= F:
                    raise ValueError(f"var {u} has more than {F} dense factors")
                ndense[u] = jd + 1
                if rows > OA:
                    raise ValueError(
                        f"factor {f.name} local table {rows} exceeds oa cap {OA}"
                    )
                # -- local table: [other assignments, own value] -----------
                local = np.moveaxis(shaped, p, -1).reshape(-1, cu)
                d_local_tables[u, jd, : local.shape[0], :cu] = local
                d_scope_vars[u, jd, : f.scope.size] = f.scope
                # local mixed-radix strides over the OTHER scope vars, laid
                # at their scope positions (own position stride 0)
                others = [q for q in range(f.scope.size) if q != p]
                ostr = table_strides(m.cards[f.scope[others]])
                ls = np.zeros(f.scope.size, dtype=np.int64)
                ls[others] = ostr
                d_other_strides[u, jd, : f.scope.size] = ls
            else:
                jg = ngather[u]
                if jg >= Fg:
                    raise ValueError(f"var {u} has more than {Fg} gather factors")
                ngather[u] = jg + 1
                g_offset[u, jg] = offsets[fi]
                g_self_stride[u, jg] = strides[p]
                g_scope_vars[u, jg, : f.scope.size] = f.scope
                g_scope_strides[u, jg, : f.scope.size] = ss
                g_mask[u, jg] = True

    # ---- chromatic schedule ---------------------------------------------
    scopes = [f.scope for f in m.factors]
    colors = color_graph(v, scopes)
    verify_coloring(colors, scopes)
    groups = color_groups(colors, update_ok[:v], group_cap or caps.group_cap)
    if len(groups) > caps.color_cap:
        raise ValueError(f"{len(groups)} color groups exceed cap {caps.color_cap}")
    gcap = caps.group_cap
    if any(g.size > gcap for g in groups):
        raise ValueError("color group exceeds group capacity")

    color_vars = np.full((caps.color_cap, gcap), sent, dtype=np.int32)
    color_mask = np.zeros((caps.color_cap, gcap), dtype=bool)
    for ci, g in enumerate(groups):
        color_vars[ci, : g.size] = g
        color_mask[ci, : g.size] = True

    exact = np.zeros((v + 1, k), dtype=np.float64)
    exact[:v, : m.marginals.shape[1]] = m.marginals
    exact[sent, 0] = 1.0

    # ---- color-contiguous renumbering (see module doc) --------------------
    NVp = caps.num_rows
    sent_row = caps.sentinel_row
    new_of_old = np.full(v + 1, sent_row, dtype=np.int32)
    slot_of_old = np.full(v + 1, caps.num_slots, dtype=np.int32)
    for ci, g in enumerate(groups):
        new_of_old[g] = ci * gcap + np.arange(g.size)
        slot_of_old[g] = ci * gcap + np.arange(g.size)
    ungrouped = [u for u in range(v) if slot_of_old[u] == caps.num_slots]
    if len(ungrouped) > caps.tail_cap:
        raise ValueError(
            f"{len(ungrouped)} ungrouped vars exceed tail cap {caps.tail_cap}"
        )
    for t, u in enumerate(ungrouped):
        new_of_old[u] = sent_row + 1 + t
    old_of_new = np.full(NVp, sent, dtype=np.int32)
    old_of_new[new_of_old[:v]] = np.arange(v)

    # ---- color-major views (the sweep's whole topology) -------------------
    # Scope vars renumbered into the permuted space; padding entries map
    # the old sentinel to the sentinel row (stride 0 everywhere).
    sw_scope_vars = new_of_old[d_scope_vars[color_vars]]  # [NC, G, F, S]
    sw_other_strides = d_other_strides[color_vars]
    sw_local_tables = d_local_tables[color_vars]  # [NC, G, F, OA, K]
    sw_kmask = (
        np.arange(k, dtype=np.int32)[None, None, :] < cards[color_vars][..., None]
    ) & color_mask[..., None]

    return EncodedModel(
        caps=caps,
        cards=cards,
        fixed=fixed,
        collapsed=collapsed,
        update_ok=update_ok,
        tables=tables,
        adj_offset=adj_offset,
        adj_self_stride=adj_self_stride,
        adj_mask=adj_mask,
        adj_scope_vars=adj_scope_vars,
        adj_scope_strides=adj_scope_strides,
        color_vars=color_vars,
        color_mask=color_mask,
        num_colors=len(groups),
        exact_marginals=exact,
        new_of_old=new_of_old,
        old_of_new=old_of_new,
        slot_of_old=slot_of_old,
        sw_scope_vars=sw_scope_vars.astype(np.int32),
        sw_other_strides=sw_other_strides.astype(np.int32),
        sw_local_tables=sw_local_tables,
        sw_kmask=sw_kmask,
        gb_offset=g_offset[color_vars],
        gb_self_stride=g_self_stride[color_vars],
        gb_scope_vars=new_of_old[g_scope_vars[color_vars]],
        gb_scope_strides=g_scope_strides[color_vars],
        gb_mask=g_mask[color_vars],
    )


def stack_variants(variants: Sequence[EncodedModel]) -> dict:
    """Stack N same-caps variants into [N, ...] arrays for the sweep."""
    caps = variants[0].caps
    for enc in variants[1:]:
        if enc.caps != caps:
            raise ValueError("all variants must share identical caps")
    out: dict = {}
    for key in variants[0].arrays():
        out[key] = np.stack([enc.arrays()[key] for enc in variants])
    return out
