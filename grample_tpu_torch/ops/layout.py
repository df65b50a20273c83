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
  pal_oon   [N, NVp] int32 — kernel row -> old var id
  pal_noo   [N, V+1] int32 — old var id -> kernel row
  pal_soo   [N, V+1] int32 — old var id -> kernel count slot (NSLOT: none)

Rows at and beyond ``NC * G`` (sentinel, evidence tail) keep their encode
order and are never written by a sweep.
"""

from __future__ import annotations

import numpy as np


def kernel_perm(local_tables: np.ndarray) -> np.ndarray:
    """[NC, G] per-color stable descending-degree order of one variant
    (reference ``gibbs_pallas.py:137-140``).  An incidence whose local
    table is identically zero adds nothing to any conditional and does
    not count toward the degree."""
    real = np.abs(local_tables).max(axis=(3, 4)) > 0  # [NC, G, F]
    return np.argsort(-real.sum(axis=2), axis=1, kind="stable")


def kernel_stack(stack: dict) -> dict:
    """Kernel-order sweep constants for a stacked encoding."""
    n, nc, G = stack["sw_scope_vars"].shape[:3]
    nvp = stack["old_of_new"].shape[1]
    nslot = nc * G
    out = {k: [] for k in ("k_scope", "k_strides", "k_tables", "k_kmask",
                           "pal_oon", "pal_noo", "pal_soo")}
    ci_idx = np.arange(nc)[:, None]  # pairs with perm [NC, G]
    for i in range(n):
        perm = kernel_perm(stack["sw_local_tables"][i])
        shared_of_pal = np.arange(nvp, dtype=np.int32)
        shared_of_pal[:nslot] = (ci_idx * G + perm).reshape(-1)
        pal_of_shared = np.empty_like(shared_of_pal)
        pal_of_shared[shared_of_pal] = np.arange(nvp, dtype=np.int32)
        out["k_scope"].append(
            pal_of_shared[stack["sw_scope_vars"][i][ci_idx, perm]])
        out["k_strides"].append(stack["sw_other_strides"][i][ci_idx, perm])
        out["k_tables"].append(stack["sw_local_tables"][i][ci_idx, perm])
        out["k_kmask"].append(stack["sw_kmask"][i][ci_idx, perm])
        out["pal_oon"].append(stack["old_of_new"][i][shared_of_pal])
        out["pal_noo"].append(pal_of_shared[stack["new_of_old"][i]])
        soo = stack["slot_of_old"][i]  # grouped slots coincide with rows < nslot
        out["pal_soo"].append(
            np.where(soo < nslot, pal_of_shared[np.minimum(soo, nvp - 1)],
                     nslot))
    dtypes = {"k_tables": np.float32, "k_kmask": np.uint8}
    return {k: np.stack(v).astype(dtypes.get(k, np.int32)) for k, v in out.items()}
