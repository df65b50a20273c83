"""Full-suite acceptance harness: the reference's experiment scripts.

Counterpart of ``grample_tpu.tools.experiments``.  Ports the semantics of
``script/experiment`` (adaptive: burnin 2000·V, 2 starting chains, +4
chains per adapt step, cwin = burnin, scored as Hellinger/JSD vs ``.MAR``
with a merlin cross-check), ``script/experiment-plain`` (plain Gibbs, 2
chains) and ``script/experiment-rnd`` (random collapse, 8 chains, half
budget) over the UAI benchmark suite, emitting one JSON line per (net,
mode) run plus a markdown summary table.

    python -m grample_tpu_torch.tools.experiments --secs 45 --modes adaptive,plain \
        --out results/acceptance.jsonl [--device cuda]

The nets are read from ``--res`` (default: the ``GRAMPLE_RES``
environment variable, else ``res``); where that holds no net with a
``.MAR`` the tool says so and exits non-zero.  Unlike the reference
scripts (which shell out to the binary per net), this drives the port's
Engine in-process, on ``--device`` (default ``cuda``).

Left out against the JAX package's tool: the ``pallas`` column (the port
has one sweep per device type and never falls back) and ``--isolate``
(one subprocess per net, a workaround for a remote accelerator link
that died in long runs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: directory of UAI nets with bundled exact .MAR ground truth
DEFAULT_RES = os.environ.get("GRAMPLE_RES", "res")

MODES = {
    # reference script/experiment:5-38
    "adaptive": dict(sampler="adaptive", chains=2, chain_adds=4, secs_scale=1.0),
    # reference script/experiment-plain:5-27
    "plain": dict(sampler="simple", chains=2, chain_adds=1, secs_scale=1.0),
    # reference script/experiment-rnd:5-27 (8 chains, half the budget)
    "rnd": dict(sampler="collapsed", chains=8, chain_adds=1, secs_scale=0.5),
}


def suite_nets(res_dir: str):
    if not os.path.isdir(res_dir):
        return []
    out = []
    for f in sorted(os.listdir(res_dir)):
        if f.endswith(".uai") and os.path.exists(os.path.join(res_dir, f + ".MAR")):
            out.append(f[: -len(".uai")])
    return out


def run_one(res_dir: str, net: str, mode: str, secs: float, vchains: int,
            seed: int, log=lambda s: None, burnin: int = -1,
            cwin: int = 0, rb_mixture: bool = True,
            trace_dir: str = "", budget: str = "sampling",
            device: str = "cuda") -> dict:
    from grample_tpu_torch.sampler.engine import Engine, EngineConfig

    spec = MODES[mode]
    path = os.path.join(res_dir, net + ".uai")
    cfg = EngineConfig(
        model_path=path,
        device=device,
        use_evidence=os.path.exists(path + ".evid"),
        use_solution=True,
        sampler=spec["sampler"],
        chains=spec["chains"],
        chain_adds=spec["chain_adds"],
        chains_per_variant=vchains,
        rb_mixture=rb_mixture,
        max_secs=secs * spec["secs_scale"],
        budget=budget,
        seed=seed,
        burnin=burnin,
        converge_window=cwin,
        status_secs=1e9,  # quiet
        # reference --experiment/-p: per-tick CSV time series in the
        # trace file (cmd/root.go:455-458, :520-533) for plateau curves
        trace_path=(os.path.join(trace_dir, f"{net}_{mode}.trace")
                    if trace_dir else ""),
        experiment=bool(trace_dir),
    )
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    t0 = time.time()
    try:
        res = Engine(cfg, log=log).run()
    except Exception as e:  # a net that cannot run is itself a result
        return {"net": net, "mode": mode, "error": f"{type(e).__name__}: {e}"}
    out = {
        "net": net,
        "mode": mode,
        "secs": round(time.time() - t0, 1),
        "samples": res.samples,
        "samples_per_sec": round(res.samples_per_sec, 1),
        "chains": res.chains,
        "variants": res.variants,
        "collapsed": len(res.collapsed),
        "aux_secs": round(res.aux_secs, 1),
        "budget": budget,
        "device": device,
        "mean_hellinger": round(float(res.final_score.mean_hellinger), 6),
        "max_hellinger": round(float(res.final_score.max_hellinger), 6),
        "mean_js": round(float(res.final_score.mean_js), 6),
        "max_js": round(float(res.final_score.max_js), 6),
    }
    if res.merlin_score is not None:
        out["merlin_mean_hellinger"] = round(float(res.merlin_score.mean_hellinger), 6)
        out["merlin_max_hellinger"] = round(float(res.merlin_score.max_hellinger), 6)
    return out


def summarize(rows, out):
    """Markdown table + the adaptive-vs-plain comparison (kelly19a claim)."""
    by_net = {}
    for r in rows:
        if "error" not in r:
            by_net.setdefault(r["net"], {})[r["mode"]] = r
    out.write("| net | mode | meanHell | maxHell | maxJS | merlin meanHell | samples/s |\n")
    out.write("|---|---|---|---|---|---|---|\n")
    for r in rows:
        if "error" in r:
            out.write(f"| {r['net']} | {r['mode']} | ERROR: {r['error']} | | | | |\n")
            continue
        out.write(
            f"| {r['net']} | {r['mode']} | {r['mean_hellinger']:.4f} "
            f"| {r['max_hellinger']:.4f} | {r['max_js']:.4f} "
            f"| {r.get('merlin_mean_hellinger', float('nan')):.4f} "
            f"| {r['samples_per_sec']:,.0f} |\n"
        )
    # adaptive >= plain (the kelly19a claim), on max Hellinger as in the paper
    wins = losses = 0
    for net, modes in by_net.items():
        if "adaptive" in modes and "plain" in modes:
            a, p = modes["adaptive"]["max_hellinger"], modes["plain"]["max_hellinger"]
            if a <= p:
                wins += 1
            else:
                losses += 1
    if wins + losses:
        out.write(
            f"\nadaptive <= plain (max Hellinger): {wins}/{wins + losses} nets\n"
        )
    return wins, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default=DEFAULT_RES)
    ap.add_argument("--nets", default="all", help="comma list or 'all'")
    ap.add_argument("--modes", default="adaptive,plain")
    ap.add_argument("--secs", type=float, default=300.0,
                    help="budget per run (reference: 300)")
    ap.add_argument("--vchains", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device the chains run on (cuda, cuda:N or cpu)")
    ap.add_argument("--out", default="", help="JSONL output path")
    ap.add_argument("--trace-dir", default="",
                    help="write per-run experiment trace files here")
    ap.add_argument("--budget", default="sampling",
                    choices=("sampling", "wall"),
                    help="budget semantics passed to the engine")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    nets = suite_nets(args.res) if args.nets == "all" else args.nets.split(",")
    missing = [n for n in nets if not os.path.exists(os.path.join(args.res, n + ".uai"))]
    if not nets or missing:
        print(f"no UAI nets with a .MAR under {args.res!r}"
              + (f" (missing: {', '.join(missing)})" if missing else "")
              + ": pass --res or set GRAMPLE_RES", file=sys.stderr)
        return 1
    modes = args.modes.split(",")
    log = print if args.verbose else (lambda s: None)

    rows = []
    fh = open(args.out, "w") if args.out else None
    for net in nets:
        for mode in modes:
            r = run_one(args.res, net, mode, args.secs, args.vchains, args.seed, log,
                        trace_dir=args.trace_dir, budget=args.budget, device=args.device)
            rows.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if fh:
                fh.write(line + "\n")
                fh.flush()
    if fh:
        fh.close()
        with open(os.path.splitext(args.out)[0] + ".md", "w") as md:
            summarize(rows, md)
    else:
        summarize(rows, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
