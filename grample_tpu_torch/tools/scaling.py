"""Mesh scaling measurement of the sharded chain runtime.

Counterpart of ``grample_tpu.tools.scaling``: WEAK scaling (the chain
count per shard held constant) of the sweep, which needs no communication,
and of the per-tick reduction surface (merged marginals + PSRF, whose
shard moments are summed on the host).

    python -m grample_tpu_torch.tools.scaling --net Grids_13 --out results/scaling.jsonl

On a machine with as many GPUs as shards the mesh takes one card per
shard (``"virtual": false``, ``"cards"`` names them): one process
launches each card's window in turn, and the cards run side by side (on
four NVIDIA H100 80GB HBM3 at 700.00 W the 10x10 grid at 262144 chains a
card kept 0.991 of one card's samples/s per card; ``chip_smoke.py`` 8g).
With fewer it builds a virtual mesh: every shard on ``--device``
(``parallel.mesh.chain_mesh(devices=...)``, where the reference forces a
host-platform device count), and the row says ``"virtual": true``.  A
virtual mesh serialises its shards on one device, so its rows measure
what sharding costs there (more, smaller launches and the host's
reduction), not how the runtime scales.  The sweep clock starts after
every card has finished the burn-in and stops when the flush has read
every card's counts.

Emits one JSON line per (net, shard count).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def measure(net: str, res_dir: str, n_dev: int, cpv_per_dev: int,
            cw: int, windows: int, device: str = "cuda") -> dict:
    import torch

    from grample_tpu_torch.parallel.mesh import ShardedChainGroup, chain_mesh
    from grample_tpu_torch.uai import load_model

    path = os.path.join(res_dir, net + ".uai")
    m = load_model(path, use_evidence=os.path.exists(path + ".evid"))
    dev = torch.device(device)
    virtual = dev.type != "cuda" or torch.cuda.device_count() < n_dev
    mesh = chain_mesh(n_devices=n_dev, variant_ways=1,
                      devices=[dev] * n_dev if virtual else None)
    g = ShardedChainGroup(
        m, chains_per_variant=cpv_per_dev * n_dev, converge_window=cw,
        seed=1, mesh=mesh,
    )
    g.add_variant(m)
    g.add_variant(m)
    g.warmup()
    g.burn(16)
    cards = mesh.local_devices()
    for d in cards:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    # sweep timing: windows dispatched with deferred deltas, one sync
    t0 = time.perf_counter()
    for _ in range(windows):
        g.advance(cw, defer=True)
    g.flush()
    sweep_secs = time.perf_counter() - t0
    samples = g.total_samples
    # reduction surface: merge + PSRF at scoring cadence
    t1 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        merged = g.merged_marginals()
        g.convergence(merged=merged)
    red_secs = (time.perf_counter() - t1) / reps
    return {
        "net": net,
        "devices": n_dev,
        "virtual": virtual,
        "device": str(dev),
        "cards": [str(d) for d in cards],
        "chains": g.num_chains,
        "chains_per_device": cpv_per_dev * g.num_variants,
        "windows": windows,
        "cw": cw,
        "samples": samples,
        "sweep_secs": round(sweep_secs, 3),
        "samples_per_sec": round(samples / sweep_secs, 1),
        "reduction_secs_per_tick": round(red_secs, 4),
        "reduction_share_per_tick": round(
            red_secs / (sweep_secs / windows + red_secs), 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default=os.environ.get("GRAMPLE_RES", "res"))
    ap.add_argument("--net", default="Grids_13")
    ap.add_argument("--counts", default="1,2,4,8")
    ap.add_argument("--cpv", type=int, default=256,
                    help="micro-chains per variant per shard (weak scaling)")
    ap.add_argument("--cw", type=int, default=64)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="device of a virtual mesh's shards (cuda, cuda:N or cpu)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if not os.path.exists(os.path.join(args.res, args.net + ".uai")):
        print(f"net {args.net!r} not found under {args.res!r}: pass --res or set "
              "GRAMPLE_RES", file=sys.stderr)
        return 1
    rows = []
    for n in [int(x) for x in args.counts.split(",")]:
        try:
            row = measure(args.net, args.res, n, args.cpv, args.cw, args.windows,
                          args.device)
        except Exception as e:  # a count that cannot run is itself a result
            row = {"net": args.net, "devices": n, "error": f"{type(e).__name__}: {e}"[:200]}
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
