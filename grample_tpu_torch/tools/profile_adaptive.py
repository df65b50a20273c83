"""Per-component profile of an adaptive tick.

Counterpart of ``grample_tpu.tools.profile_adaptive``.  An adaptive run
spends host time between its windows: the flush of the count deltas,
the RB snapshot, the merge, and the adapt step itself (collapse, encode,
restack or slot write, the new slots' burn).  This tool runs the adaptive
engine loop shape by hand on one full-width ``ChainGroup`` and
wall-times each component:

    python -m grample_tpu_torch.tools.profile_adaptive --net Grids_13 --secs 60 [--device cuda]

``advance`` is the time to *launch* a tick's windows (they run
asynchronously on a GPU); the device time they take shows up in
``flush``, the tick's first sync.  Left out against the JAX package's
tool: the ``use_pallas`` column (the port has one sweep per device type).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from grample_tpu_torch.sampler.adaptive import adapt_step
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.uai import load_model


def profile(m, secs: float, chains: int, cw: int, nwin: int, adds: int,
            device: str = "cuda", burn: int = 2000, max_ticks: int = 0) -> dict:
    """Run adaptive ticks on model ``m`` for ``secs`` seconds (or
    ``max_ticks`` ticks) and return seconds and shares per component."""
    g = ChainGroup(m, chains_per_variant=chains, converge_window=cw, device=device,
                   seed=1, collapse_headroom=True)
    g.reserve(g.max_variants)  # the engine's auto-reserve (small nets)
    g.add_variant(m)
    g.add_variant(m)
    g.warmup()
    g.burn_annealed(burn)

    t = {k: 0.0 for k in ("advance", "flush", "rb", "merged", "adapt")}
    n_ticks = 0
    t_end = time.time() + secs
    t_loop0 = time.time()
    while time.time() < t_end and not (max_ticks and n_ticks >= max_ticks):
        t0 = time.time()
        for _ in range(nwin):
            g.advance(cw, defer=True)
        t["advance"] += time.time() - t0
        t0 = time.time()
        g.flush()
        t["flush"] += time.time() - t0
        t0 = time.time()
        g.rb_accumulate()
        t["rb"] += time.time() - t0
        t0 = time.time()
        g.merged_marginals()
        t["merged"] += time.time() - t0
        t0 = time.time()
        if g.num_variants < g.max_variants:
            adapt_step(g, adds)
        t["adapt"] += time.time() - t0
        n_ticks += 1
    t["other"] = (time.time() - t_loop0) - sum(t.values())

    total = sum(t.values())
    return {
        "ticks": n_ticks,
        "variants": g.num_variants,
        "chains": g.num_chains,
        "samples": g.total_samples,
        "samples_per_sec": round(g.total_samples / max(total, 1e-9), 1),
        "device": str(g.device),
        **{f"secs_{k}": round(v, 2) for k, v in t.items()},
        **{f"share_{k}": round(v / max(total, 1e-9), 4) for k, v in t.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default=os.environ.get("GRAMPLE_RES", "res"))
    ap.add_argument("--net", default="Grids_13")
    ap.add_argument("--secs", type=float, default=60.0)
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--cw", type=int, default=2000)
    ap.add_argument("--nwin", type=int, default=4,
                    help="windows per tick (the engine batches ~status_secs)")
    ap.add_argument("--adds", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device the chains run on (cuda, cuda:N or cpu)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    path = os.path.join(args.res, args.net + ".uai")
    if not os.path.exists(path):
        print(f"net {args.net!r} not found under {args.res!r}: pass --res or set "
              "GRAMPLE_RES", file=sys.stderr)
        return 1
    m = load_model(path, use_evidence=os.path.exists(path + ".evid"))
    out = {"net": args.net, **profile(m, args.secs, args.chains, args.cw, args.nwin,
                                      args.adds, args.device)}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
