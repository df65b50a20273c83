"""Command-line interface: ``sample`` (``-s simple``, ``-s collapsed`` and
``-s adaptive``, with ``--checkpoint``/``--resume`` and ``--mesh``),
``collapse`` and ``dot``.

Mirrors ``grample_tpu.cli`` (reference ``cmd/root.go:163-250``) with the
same flags and derived defaults, on a PyTorch device:

    python -m grample_tpu_torch.cli sample -m net.uai -d -o -s simple
    python -m grample_tpu_torch.cli sample -m net.uai -d -o -s collapsed -c 8 --vchains 32768
    python -m grample_tpu_torch.cli sample -m net.uai -d -o -s adaptive -a 4 --vchains 8192
    python -m grample_tpu_torch.cli sample -m net.uai -s adaptive --checkpoint ck.npz --resume
    python -m grample_tpu_torch.cli sample -m net.uai -o --device cpu
    python -m grample_tpu_torch.cli sample -m net.uai -s adaptive --mesh auto
    python -m grample_tpu_torch.cli collapse -m net.uai
    python -m grample_tpu_torch.cli dot -m net.uai

A multi-host run starts one process per host, each owning the GPUs it
sees, and joins them with ``--distributed`` (``torch.distributed`` over
gloo, from torchrun's environment: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); the chain mesh then spans every host's
GPUs, and rank 0 writes the outputs:

    torchrun --nproc-per-node 1 --nnodes H ... -m grample_tpu_torch.cli sample -m net.uai -s adaptive --mesh auto --distributed

``CUDA_VISIBLE_DEVICES`` splits a host between several processes.  A
checkpoint path must name a file that every host sees.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("-v", "--verbose", action="store_true", help="verbose output")
    common.add_argument("-e", "--seed", type=int, default=0, help="random seed (<1: wall clock)")
    common.add_argument("-t", "--trace", default="", help="trace output file")
    common.add_argument("--device", default="cuda",
                        help="torch device the chains run on (cuda, cuda:N or cpu)")
    p = argparse.ArgumentParser(
        prog="grample-tpu-torch",
        description="Gibbs marginal inference for UAI discrete PGMs on a GPU",
        parents=[common],
    )
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("sample", help="estimate marginals (the MAR task)", parents=[common])
    s.add_argument("-m", "--model", required=True, help="UAI model file")
    s.add_argument("-s", "--sampler", default="simple",
                   choices=["simple", "collapsed", "adaptive"])
    s.add_argument("-d", "--evidence", action="store_true",
                   help="apply evidence from <model>.evid")
    s.add_argument("-o", "--solution", action="store_true",
                   help="score against <model>.MAR (and .merlin.MAR if present)")
    s.add_argument("-b", "--burnin", type=int, default=-1,
                   help="burn-in in single-site samples (<0: 2000*vars)")
    s.add_argument("-w", "--cwin", type=int, default=0,
                   help="convergence window in samples (<=0: burnin)")
    s.add_argument("-c", "--chains", type=int, default=0,
                   help="logical chains / variant slots (<=0: 2)")
    s.add_argument("--vchains", type=int, default=64,
                   help="micro-chains per logical chain (the batch axis)")
    s.add_argument("-a", "--chainadds", type=int, default=1,
                   help="chains added per adaptation step")
    s.add_argument("-i", "--maxiters", type=int, default=0,
                   help="max site samples (0: unlimited)")
    s.add_argument("-x", "--maxsecs", type=float, default=300.0,
                   help="max runtime seconds")
    s.add_argument("--budget", default="sampling", choices=("sampling", "wall"),
                   help="maxsecs bounds sampling time (kernel build and first"
                        " launch excluded) or literal wall clock (the"
                        " reference --maxsecs contract)")
    s.add_argument("-p", "--experiment", action="store_true",
                   help="experiment mode: CSV time series into the trace file")
    s.add_argument("--addr", default="", help="monitor HTTP address, e.g. :8000")
    s.add_argument("--measure", default="hellinger",
                   choices=["hellinger", "js", "maxabs", "meanabs"])
    s.add_argument("--adapt-policy", default="worst", choices=["worst", "ref-tail"])
    s.add_argument("--no-warm-start", action="store_true",
                   help="uniform-init adaptive chains (reference behavior)")
    s.add_argument("--anneal", type=int, default=20, metavar="STAGES",
                   help="tempered burn-in stages (0 = plain uniform-init "
                        "burn, the reference behavior)")
    s.add_argument("--no-rb-mixture", action="store_true",
                   help="freeze collapsed-var marginals at collapse time "
                        "(reference behavior) instead of the RB mixture")
    s.add_argument("--mar-out", default="", help="write final MAR solution to file")
    s.add_argument("--checkpoint", default="", help="checkpoint file path")
    s.add_argument("--checkpoint-secs", type=float, default=60.0)
    s.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists (budgets continue)")
    s.add_argument("--split-group", default="auto", choices=("auto", "on", "off"),
                   help="adaptive split execution: plain slots on plain caps + "
                        "reduced-chain collapse slots (see sampler/split.py)")
    s.add_argument("--reserve", type=int, default=0,
                   help="pre-size variant slot capacity (avoids mid-run restacks)")
    s.add_argument("--mesh", default="off",
                   help="device mesh: off | auto | VxC (variants x chains), e.g. 2x4: "
                        "shard the chains over several GPUs")
    s.add_argument("--distributed", action="store_true",
                   help="join the ranks of a multi-host run (torchrun's environment: RANK, "
                        "WORLD_SIZE, MASTER_ADDR, MASTER_PORT); the mesh spans every rank's "
                        "GPUs, so it needs --mesh auto or VxC")

    c = sub.add_parser("collapse", parents=[common],
                       help="per-variable exact-collapse validation vs <model>.MAR")
    c.add_argument("-m", "--model", required=True)
    # evidence always applies, as in the reference (its flag defaults on)
    c.add_argument("-d", "--evidence", action="store_true", default=True)
    d = sub.add_parser("dot", help="export the moral graph in Graphviz format",
                       parents=[common])
    d.add_argument("-m", "--model", required=True)
    d.add_argument("-d", "--evidence", action="store_true")
    return p


def cmd_sample(args) -> int:
    from grample_tpu_torch.monitor import Monitor
    from grample_tpu_torch.parallel import distributed
    from grample_tpu_torch.sampler.engine import Engine, EngineConfig

    cfg = EngineConfig(
        model_path=args.model,
        device=args.device,
        use_evidence=args.evidence,
        use_solution=args.solution,
        sampler=args.sampler,
        burnin=args.burnin,
        converge_window=args.cwin,
        chains=args.chains,
        chains_per_variant=args.vchains,
        chain_adds=args.chainadds,
        max_iters=args.maxiters,
        max_secs=args.maxsecs,
        budget=args.budget,
        seed=args.seed,
        measure=args.measure,
        adapt_policy=args.adapt_policy,
        warm_start=not args.no_warm_start,
        anneal_stages=args.anneal,
        rb_mixture=not args.no_rb_mixture,
        trace_path=args.trace,
        experiment=args.experiment,
        verbose=args.verbose,
        mar_out=args.mar_out,
        checkpoint_path=args.checkpoint,
        checkpoint_secs=args.checkpoint_secs,
        resume=args.resume,
        split_group=args.split_group,
        reserve_slots=args.reserve,
        mesh=args.mesh,
        distributed=args.distributed,
    )
    engine = Engine(cfg)  # checks the config before any work
    if args.distributed:
        # join the ranks before any device query (reference cli.py:101-107)
        distributed.init_distributed()
    monitor = None
    try:
        if args.addr and distributed.is_main():
            monitor = Monitor(args.addr)
            monitor.start()
            print(f"monitor listening on :{monitor.port}/debug/vars")
        engine.monitor = monitor
        engine.run()
    finally:
        if monitor:
            monitor.stop()
        if args.distributed:
            distributed.shutdown()
    return 0


def cmd_collapse(args) -> int:
    """Per-variable exact-collapse validation (reference cmd/collapse.go;
    the same lines as ``grample_tpu.cli.cmd_collapse``)."""
    import numpy as np

    from grample_tpu_torch.metrics import error_suite
    from grample_tpu_torch.metrics.divergences import pad_marginals
    from grample_tpu_torch.sampler.collapse import collapse_var, is_collapsible
    from grample_tpu_torch.uai import load_model, read_mar_file

    model = load_model(args.model, use_evidence=args.evidence)
    sol = pad_marginals(read_mar_file(args.model + ".MAR"), model.cards)
    merlin = None
    mp = args.model + ".merlin.MAR"
    if os.path.exists(mp):
        merlin = pad_marginals(read_mar_file(mp), model.cards)

    blankets = model.blankets()
    for i in range(model.num_vars):
        if model.fixed[i] >= 0:
            continue
        if not is_collapsible(model, i, blankets[i]):
            print(f"Var[{i}] {model.var_name(i)}: SKIPPED (blanket {len(blankets[i])})")
            continue
        _, exact = collapse_var(model, i)
        card = int(model.cards[i])
        est = np.zeros((model.num_vars, model.marginals.shape[1]))
        est[i, :card] = exact
        one = np.array([i])
        col_vs_sol = error_suite(est[one], sol[one], model.cards[one])
        print(f"Var[{i}] {model.var_name(i)} (card {card}, blanket {len(blankets[i])})")
        print(f"  collapsed: {np.round(exact, 6)}")
        print(f"  solution : {np.round(sol[i, :card], 6)}")
        print(f"  Col vs Sol: Hell={col_vs_sol.max_hellinger:.6f} JS={col_vs_sol.max_js:.6f}")
        if merlin is not None:
            mer_vs_sol = error_suite(merlin[one], sol[one], model.cards[one])
            mer_vs_col = error_suite(merlin[one], est[one], model.cards[one])
            print(f"  Mer vs Sol: Hell={mer_vs_sol.max_hellinger:.6f}"
                  f"  Mer vs Col: Hell={mer_vs_col.max_hellinger:.6f}")
    return 0


def cmd_dot(args) -> int:
    """Graphviz moral-graph export (reference cmd/dot.go:18-79; the same
    lines as ``grample_tpu.cli.cmd_dot``)."""
    from grample_tpu_torch.pgm.coloring import moral_adjacency
    from grample_tpu_torch.uai import load_model

    model = load_model(args.model, use_evidence=args.evidence)
    adj = moral_adjacency(model.num_vars, [f.scope for f in model.factors])
    print("strict graph G {")
    for a in range(model.num_vars):
        for b in sorted(adj[a]):
            if b > a:
                print(f"    {model.var_name(a)} -- {model.var_name(b)};")
    print("}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "sample":
        return cmd_sample(args)
    if args.command == "collapse":
        return cmd_collapse(args)
    if args.command == "dot":
        return cmd_dot(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
