"""The control of the ``correct`` check: the reference put in the program's
place, computed one precision below the configuration's.

The port samples from float32 log tables, so the control is the exact
reference (``benchmark.exact``) run in bfloat16: its marginals stand in
for the program's and are judged as the program's are, by the largest
Hellinger distance over the free vars against the float64 reference, and
by the mean.  Each limit of a cell has to fail it.  Beside it,
``tables_only`` rounds the tables to bfloat16 and keeps the arithmetic
in float64: what a program that stored its tables in bfloat16 would be
off by.

    python3 -m benchmark.control --device cuda --seeds 1,2,3

prints one JSON line per configuration and seed.
"""

from __future__ import annotations

import argparse
import json

import torch

from benchmark import exact, nets, registry


def marginals(net: dict, device: str = "cpu"):
    """The control's marginals: the exact reference run in bfloat16."""
    return exact.exact_marginals(net, dtype=torch.bfloat16, device=device)


def readings(net: dict, device: str = "cpu") -> dict:
    """The numbers a cell compares, ``hellinger_max`` and ``hellinger_mean``
    over the free vars, of the bfloat16 reference; and, under
    ``tables_only_*``, of float64 arithmetic on bfloat16-rounded tables."""
    truth = exact.exact_marginals(net)
    free = exact.free_mask(net)
    low = marginals(net, device)
    rounded = dict(net, factors=[(s, torch.as_tensor(t).to(torch.bfloat16).double().numpy())
                                 for s, t in net["factors"]])
    tab = exact.exact_marginals(rounded)
    out = {}
    for prefix, est in (("", low), ("tables_only_", tab)):
        h = exact.hellinger(est[free], truth[free])
        out[prefix + "hellinger_max"] = float(h.max())
        out[prefix + "hellinger_mean"] = float(h.mean())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the correct check's control readings")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", default="1,2,3")
    args = p.parse_args(argv)
    for conf in registry.benchmark()["configs"]:
        spec = registry.config(conf["name"])["net"]
        for seed in (int(s) for s in args.seeds.split(",")):
            line = {"config": conf["name"], "seed": seed, "device": args.device}
            line.update(readings(nets.build(spec, seed), args.device))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
