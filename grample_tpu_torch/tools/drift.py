"""Plain-sampler rising-error analysis on a slow-mixing net (Grids_13).

Counterpart of ``grample_tpu.tools.drift``.  A long plain run on
Grids_13 shows max Hellinger rising over time.  Hypotheses: (a) ensemble
mode drift: individual chains hop between the grid's quasi-deterministic
modes with net flux toward the dominant basin, so the CHAIN-ENSEMBLE
distribution slides away from the annealed-burn-in start (real Gibbs
dynamics, would also affect the reference); (b) a counting/merge bug
(window counts diverging from state occupancy).

This tool advances a plain group window by window and records, per tick:
  - cumulative-count estimate error (what the engine reports),
  - window-LOCAL estimate error (this window's halves only),
  - ensemble occupancy of the worst var's outcome 0 (drift trajectory).
If window-local error drifts the same way while local-vs-cumulative
stay consistent, it is (a): the estimator faithfully averages a
drifting ensemble.  A divergence between local counts and state
occupancy would be (b).

    python -m grample_tpu_torch.tools.drift --net Grids_13 --windows 40 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from grample_tpu_torch.metrics.divergences import hellinger, pad_marginals
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.uai import load_model, read_mar_file


def window_row(g, sol: np.ndarray, w: int, worst_var=None) -> dict:
    """One tick's record for group ``g`` just after a counted window."""
    m = g.base
    v, k = m.num_vars, g.kdim
    free, cards = m.free_mask, m.cards
    nact = g.num_variants
    # window-local estimate: THIS window's halves only
    local = g.halves[:nact].sum(dim=(0, 1, 2))[:v].cpu().numpy().astype(np.float64)
    local_est = local + 1e-9
    cum = g.merged_marginals()
    h_local = hellinger(local_est, sol, cards)[free]
    h_cum = hellinger(cum, sol, cards)[free]
    # state occupancy right now (consistency check vs window counts)
    st = g.state[:nact, :, :v]
    occ = torch.stack([(st == kk).sum(dim=(0, 1)) for kk in range(k)], dim=1)
    occ = occ.cpu().numpy().astype(np.float64)
    h_occ = hellinger(occ + 1e-9, sol, cards)[free]
    if worst_var is None:
        worst_var = int(np.nonzero(free)[0][np.argmax(h_cum)])
    wv_occ0 = float(occ[worst_var, 0] / max(occ[worst_var].sum(), 1))
    wv_loc0 = float(local_est[worst_var, 0] / max(local_est[worst_var].sum(), 1e-9))
    return {
        "window": w,
        "sweeps": g.total_sweeps,
        "max_hell_cum": round(float(h_cum.max()), 5),
        "mean_hell_cum": round(float(h_cum.mean()), 5),
        "max_hell_window": round(float(h_local.max()), 5),
        "mean_hell_window": round(float(h_local.mean()), 5),
        "max_hell_occupancy": round(float(h_occ.max()), 5),
        "worst_var": worst_var,
        "worst_var_occ0": round(wv_occ0, 5),
        "worst_var_window0": round(wv_loc0, 5),
        "sol_worst0": round(float(sol[worst_var, 0]), 5),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default=os.environ.get("GRAMPLE_RES", "res"))
    ap.add_argument("--net", default="Grids_13")
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--cw", type=int, default=2000)
    ap.add_argument("--chains", type=int, default=2048)
    ap.add_argument("--burn", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device the chains run on (cuda, cuda:N or cpu)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    path = os.path.join(args.res, args.net + ".uai")
    if not os.path.exists(path + ".MAR"):
        print(f"net {args.net!r} with its .MAR not found under {args.res!r}: pass "
              "--res or set GRAMPLE_RES", file=sys.stderr)
        return 1
    m = load_model(path, use_evidence=os.path.exists(path + ".evid"))
    sol = pad_marginals(read_mar_file(path + ".MAR"), m.cards)

    g = ChainGroup(m, chains_per_variant=args.chains, converge_window=args.cw,
                   device=args.device, seed=args.seed)
    g.add_variant(m)
    g.add_variant(m)
    g.warmup()
    g.burn_annealed(args.burn)

    rows = []
    for w in range(args.windows):
        g.advance(args.cw, defer=False)
        rows.append(window_row(g, sol, w, rows[0]["worst_var"] if rows else None))
        print(json.dumps(rows[-1]), flush=True)

    if args.out:
        with open(args.out, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
