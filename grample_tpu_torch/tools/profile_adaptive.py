"""Where an adaptive run's ticks spend their time, from the engine's tracer.

Counterpart of ``grample_tpu.tools.profile_adaptive``.  An adaptive run
spends host time between its windows: the flush of the count deltas (and,
in a split group, the aux tick), the RB snapshot, the status tick and the
adapt step itself (ranking, collapse, placement, the new slots' burn).
This tool runs the engine with ``-s adaptive`` on the net, as the CLI
does (the split group where the engine picks it), and prints the totals
of its ``tick.*`` and ``adapt.*`` spans and their shares of the tick
time:

    python -m grample_tpu_torch.tools.profile_adaptive --net Grids_13 --secs 60 [--device cuda]

``tick.launch`` is the time to *enqueue* a tick's windows (they run
asynchronously on a GPU); the device time they take shows up in
``tick.flush``, the tick's first sync.  ``tick.aux`` lies inside
``tick.flush``, ``adapt.*`` inside ``tick.adapt`` and ``adapt.burn``
inside ``adapt.place``; ``tick.other`` is the tick's own time outside
its launch, flush, RB snapshot and adapt step (clock decisions, the
status tick, a checkpoint).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.uai import load_model

#: the tick's direct children, whose shares with ``tick.other`` sum to 1
TICK_PARTS = ("tick.launch", "tick.flush", "tick.rb", "tick.adapt")
#: spans nested deeper, reported beside them
NESTED = ("tick.aux", "adapt.rank", "adapt.collapse", "adapt.place", "adapt.burn")


def profile(path: str, secs: float, chains: int, cw: int, adds: int,
            device: str = "cuda", burn: int = 2000, seed: int = 1) -> dict:
    """Run ``-s adaptive`` on the net at ``path`` for ``secs`` seconds of
    sampling clock; seconds and shares of the tick time per span."""
    v = load_model(path).num_vars
    cfg = EngineConfig(model_path=path, device=device,
                       use_evidence=os.path.exists(path + ".evid"), sampler="adaptive",
                       chains=2, chains_per_variant=chains, chain_adds=adds,
                       burnin=burn * v, converge_window=cw * v, max_secs=secs, seed=seed)
    res = Engine(cfg, log=lambda line: None).run()
    spans = res.spans
    secs_of = {name: spans.get(name, {}).get("total_s", 0.0) for name in TICK_PARTS + NESTED}
    tick = spans.get("tick", {"n": 0, "total_s": 0.0, "self_s": 0.0})
    secs_of["tick.other"] = tick["self_s"]
    return {
        "ticks": tick["n"],
        "variants": res.variants,
        "chains": res.chains,
        "samples": res.samples,
        "runtime": res.runtime,
        "samples_per_sec": round(res.samples_per_sec, 1),
        "device": device,
        "secs_tick": tick["total_s"],
        **{f"secs_{k}": round(s, 4) for k, s in secs_of.items()},
        **{f"share_{k}": round(s / max(tick["total_s"], 1e-9), 4) for k, s in secs_of.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default=os.environ.get("GRAMPLE_RES", "res"))
    ap.add_argument("--net", default="Grids_13")
    ap.add_argument("--secs", type=float, default=60.0)
    ap.add_argument("--chains", type=int, default=1024, help="chains per variant")
    ap.add_argument("--cw", type=int, default=2000, help="convergence window, sweeps")
    ap.add_argument("--adds", type=int, default=4, help="collapse variants per adapt step")
    ap.add_argument("--device", default="cuda",
                    help="torch device the chains run on (cuda, cuda:N or cpu)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    path = os.path.join(args.res, args.net + ".uai")
    if not os.path.exists(path):
        print(f"net {args.net!r} not found under {args.res!r}: pass --res or set "
              "GRAMPLE_RES", file=sys.stderr)
        return 1
    out = {"net": args.net, **profile(path, args.secs, args.chains, args.cw, args.adds,
                                      args.device)}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
