"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a net (``benchmark/configs``) under a traffic mix
(``benchmark/traffic``): the sampler mode, chains, device mesh and cards
a user runs on it.  The run is one job of the port, ``grample_tpu_torch``:

1. the net's tables are drawn from ``--seed`` and written as UAI files
   under ``TMPDIR`` (not timed);
2. set-up starts: torch, the card check, the port's import, the engine's
   build, warm-up and first launches; the engine's sampling clock then
   runs ``--seconds`` (burn-in, ticks, adapt steps, the aux group), and
   its ``RunResult`` is the window's output;
3. once the window has closed and the peak memory is read, the plain
   reference (``benchmark.exact``) works out the net's exact marginals
   on the host and the run is judged: ``correct`` holds where every
   number of the cell's limits (``benchmark/workloads/<cell>.json``) is
   within its limit.

With ``--trace 0`` the line's metrics are the cell's ``end_to_end`` ones,
with ``--trace 1`` its ``per_layer`` ones, read from a ``torch.profiler``
span (``benchmark.trace``).  The last line of standard output is the
result, one JSON object; the last lines of standard error are the numbers
compared, each beside its limit.  Without CUDA cards, or fewer than the
cell asks for, the run prints no result and exits 2.  If a module named
``jax``, ``jaxlib``, ``flax`` or ``grample_tpu`` (whole top-level names)
was loaded, it prints no result and exits 3.

The program's caches stay in the checkout: ``HOME`` (the wide aux spec's
cache) points at ``.benchcache/home``; the CUDA build is the port's own
``grample_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from benchmark import count, nets, registry

#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "grample_tpu")
CACHE = os.path.join(registry.ROOT, ".benchcache")


def forbidden_modules(modules=None) -> list:
    """The ``FORBIDDEN`` names among the top-level names of ``modules``
    (default ``sys.modules``), compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


#: traffic keys that name an ``EngineConfig`` field by the CLI's flag
RENAMES = {"vchains": "chains_per_variant"}
#: ``EngineConfig`` fields the harness sets: from the run's arguments and
#: the configuration, never from a traffic mix
HARNESS_FIELDS = ("model_path", "device", "use_evidence", "use_solution", "burnin",
                  "converge_window", "max_secs", "budget", "seed")


def engine_config(cell: dict, path: str, seed: int, seconds: float, device: str):
    """The ``EngineConfig`` that ``cli.py sample`` builds from the cell's
    flags: every key of the traffic mix but ``why`` sets the field it names
    (``vchains`` is ``chains_per_variant``); one that names no field, or a
    field the harness sets, raises."""
    from grample_tpu_torch.sampler.engine import EngineConfig

    conf = cell["config"]
    flags = {RENAMES.get(k, k): x for k, x in cell["traffic"].items() if k != "why"}
    fields = {f.name for f in dataclasses.fields(EngineConfig)} - set(HARNESS_FIELDS)
    unknown = sorted(set(flags) - fields)
    if unknown:
        raise KeyError(f"traffic keys that set no EngineConfig field a mix may set: {unknown}")
    v = len(cell["net"]["cards"])
    return EngineConfig(
        model_path=path, device=device, use_evidence=True, use_solution=False,
        burnin=conf["burnin_sweeps"] * v, converge_window=conf["cwin_sweeps"] * v,
        max_secs=float(seconds), budget="sampling", seed=int(seed) % (1 << 62) + 1, **flags)


def run_program(cell: dict, path: str, seed: int, seconds: float, trace: bool, t0: float,
                device: str = "cuda") -> dict:
    """Run the cell's job once; the run's records (``rec``)."""
    import torch

    from benchmark.trace import SpanMonitor, reduce_span
    from grample_tpu_torch.sampler.engine import Engine

    cards = ([torch.device("cuda", i) for i in range(cell["entry"]["chips"])]
             if device == "cuda" else [])
    for d in cards:
        torch.zeros(1, device=d)  # the card's context and allocator, then its peak
        torch.cuda.reset_peak_memory_stats(d)
    mon = SpanMonitor(cards, profile=trace)
    cfg = engine_config(cell, path, seed, seconds, device)
    result = Engine(cfg, log=mon.log, monitor=mon).run()
    mon.stop()
    rec = {
        "result": result,
        "setup_s": mon.updates[-1][0] - t0 - result.runtime,
        "peak_bytes": max((torch.cuda.max_memory_allocated(d) for d in cards), default=0),
        "burnin_peak_bytes": mon.burnin_peak,
        "adapt_s": mon.adapt_seconds(),
        "span": reduce_span(mon.prof, len(cards), mon.marks) if trace and cards else {},
        "span_sites": mon.updates[-1][1] - mon.updates[0][1],
        "n_devices": len(cards),
        "cw_sweeps": cell["config"]["cwin_sweeps"],
    }
    mon.prof = None
    return rec


def card_facts(torch) -> dict:
    """The first card's name, power limit (W), SM count and ``clocks.max.sm``."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    power, clock = (float(x) for x in out.splitlines()[0].split(","))
    return {"kind": torch.cuda.get_device_name(0), "power_limit_w": power,
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "clock_hz": clock * 1e6}


def judge(cell: dict, rec: dict, trace: bool) -> dict:
    """The result line's ``correct``, ``attempted``, ``failed``, ``metrics``
    and ``checks``, from the reference's exact marginals."""
    from benchmark import exact

    net = rec["net"] = cell["net"]
    truth = exact.exact_marginals(net)
    free = exact.free_mask(net)
    marg = np.asarray(rec["result"].marginals, dtype=np.float64)
    sound = (marg.shape == truth.shape and bool(np.isfinite(marg).all())
             and bool(np.allclose(marg[free].sum(axis=1), 1.0, atol=1e-6)))
    rec["hellinger"] = (exact.hellinger(marg[free], truth[free]) if sound
                        else np.full(int(free.sum()), np.inf))
    metrics = {}
    root = cell.get("root", registry.ROOT)
    for m in cell["per_layer" if trace else "end_to_end"]:
        value = registry.reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = {name: {"value": float(registry.reader(name, root)(rec)), "limit": float(limit)}
              for name, limit in sorted(cell["limits"].items())}
    correct = sound and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                            for c in checks.values())
    limit_h = cell["limits"].get("hellinger_max", math.inf)
    return {"correct": correct, "attempted": int(free.sum()),
            "failed": int((~(rec["hellinger"] <= limit_h)).sum()),
            "metrics": metrics, "checks": checks}


def result_line(out: dict, device: dict, span: dict) -> dict:
    """The result line: ``judge``'s verdict and metrics, the device (with the
    span's mean busy seconds and wall where a span was traced), the
    breakdown, and the numbers compared, last."""
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = dict(device)
    if span:
        line["device"]["busy_s"] = float(np.mean(span["busy_s"]))
        line["device"]["window_s"] = span["wall"]
        line["breakdown"] = {"device_ops": span["ops"], "idle_gaps": span["gaps"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("HOME", "home"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)
    cell = registry.cell(args.workload)
    cell["net"] = nets.build(cell["config"]["net"], args.seed, cell.get("root", registry.ROOT))
    trace = bool(args.trace)
    with tempfile.TemporaryDirectory(prefix="bench-net-") as td:
        path = nets.write_uai(cell["net"], td, args.workload)
        t0 = time.perf_counter()
        import torch

        need = cell["entry"]["chips"]
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            print(f"benchmark: {args.workload} needs {need} CUDA card(s), found {have}",
                  file=sys.stderr)
            return 2
        rec = run_program(cell, path, args.seed, args.seconds, trace, t0)
    facts = card_facts(torch)
    peaks = count.PEAKS.get(facts["kind"])
    rec["peak_ops"] = peaks and facts["sms"] * peaks["lanes_per_sm"] * facts["clock_hz"]
    rec["peak_bytes_per_s"] = peaks and peaks["bytes_per_s"]
    out = judge(cell, rec, trace)
    device = {"platform": "gpu", "kind": facts["kind"], "count": need,
              "memory_peak_bytes": int(rec["peak_bytes"]),
              "power_limit_w": facts["power_limit_w"], "clocks_max_sm_hz": facts["clock_hz"]}
    line = result_line(out, device, rec["span"] if trace else {})
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that no run may load: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
