"""Headline benchmark of the port: throughput and inference quality on one card.

Counterpart of ``bench.py`` at the repository root (the JAX package's
benchmark), with its three measured legs, its phase entry point, its
``BENCH-PHASE-RESULT:`` marker, its env knobs and its one JSON line:

1. **Anchor**: the single-core C++ random-scan sampler
   (``grample_tpu_torch/csrc/anchor.cpp``, the reference's hot loop
   ``sampler/gibbs-simple.go:163-271``), measured on this host, scored
   against ``<net>.uai.MAR`` where that file exists.
2. **Throughput**: counted site-samples/s of the sweep at ``BENCH_CHAINS``
   chains (fewer where the split-half counts would pass 2 GiB,
   ``bench_chains``): three deferred 256-sweep windows and one flush.
3. **Quality**: an adaptive engine run (the reference's experiment
   shape, ``script/experiment:5-38``) scored against ``.MAR`` and the
   merlin solver's ``.merlin.MAR``.

``vs_baseline`` = the card's samples/s over the anchor's on the same net.

    python -m grample_tpu_torch.bench                      # every leg
    python -m grample_tpu_torch.bench <phase> <net> <secs>  # one phase

Keys of the throughput leg, against the reference's: ``tpu_samples_per_sec``
is ``device_samples_per_sec``; ``pallas`` is ``route``, the group's
``"kernel"`` or ``"ops"`` (``ops/sweep.py::route_for``); ``platform`` is
``device``, the card's name and power limit as ``nvidia-smi`` prints them
(``"cpu"`` under ``BENCH_DEVICE=cpu``); ``est_flops_per_site`` and
``est_tflops`` are ``est_ops_per_site`` and ``est_tops``, the arithmetic
one counted site's draw needs (``ops/bound.py::site_operations``; the
reference's formula read a matmul sweep mode the port does not have).
``launches_by_form`` is new: the phase's kernel launches by form, so a
caller sees that the kernel ran.  The engine leg adds ``kernel``
(``RunResult.kernel``).

Each phase runs in a fresh process, as the reference's do, under the wall
budget ``BENCH_WALL``: the anchor and throughput legs of each net first,
then the engine legs with budgets shrunk to what is left; what does not
fit is skipped with a note.  A phase that fails is an ``error`` entry and
is not retried.

Env knobs: ``BENCH_WALL`` (1300 s), ``BENCH_CHAINS`` (262144),
``BENCH_SECS`` (300, the engine budget before shrinking), ``BENCH_NETS``
(``Grids_13,Promedus_19``), ``BENCH_ANCHOR_SAMPLES`` (4e7), ``GRAMPLE_RES``
(the nets' directory, else ``res``) and ``BENCH_DEVICE`` (``cuda``): the
device legs run there, and with ``cuda`` on a machine without a CUDA
device they fail; ``cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

RES = os.environ.get("GRAMPLE_RES", "res")
CHAINS = int(os.environ.get("BENCH_CHAINS", "262144"))
SECS = float(os.environ.get("BENCH_SECS", "300"))
WALL = float(os.environ.get("BENCH_WALL", "1300"))
NETS = os.environ.get("BENCH_NETS", "Grids_13,Promedus_19").split(",")
ANCHOR_SAMPLES = int(os.environ.get("BENCH_ANCHOR_SAMPLES", "40000000"))
DEVICE = os.environ.get("BENCH_DEVICE", "cuda")
MARKER = "BENCH-PHASE-RESULT:"

#: micro-chains per variant of the engine leg (the reference's 8192)
ENGINE_VCHAINS = 8192

#: an engine leg's wall beyond its sampling budget (process start, model
#: load, encoding, the wide aux spec, burn-in, scoring), used to size
#: subprocess timeouts and shrunk budgets; the wall model is
#: OVERHEAD + 2 * secs, as the reference's.  The largest measured on the
#: card, rounded up: ``chip_smoke.py`` phase 7's engine leg on a 916-var
#: Promedus-shaped net with its wide aux spec computed (``PERF.md`` §6)
ENGINE_OVERHEAD = 70.0

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_chains(num_vars: int, max_card: int, chains: int) -> int:
    """``chains`` halved until the split-half window counts, int32
    ``[2, chains, V+1, K]``, fit in 2 GiB, or down to 1024 (the reference's
    rule, so that both benches run the same chain count)."""
    while chains > 1024 and 2 * chains * (num_vars + 1) * max_card * 4 > 2 << 30:
        chains //= 2
    return chains


def _device() -> str:
    """``BENCH_DEVICE``, refused where it is a CUDA device and there is
    none: a device leg never carries on on the CPU unasked."""
    import torch

    if DEVICE.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"BENCH_DEVICE={DEVICE}: no CUDA device (torch.cuda.is_available() "
                           "is false); BENCH_DEVICE=cpu runs the plain versions on the CPU")
    return DEVICE


def _load(net: str):
    from grample_tpu_torch.uai import load_model

    path = os.path.join(RES, net + ".uai")
    return path, load_model(path, use_evidence=os.path.exists(path + ".evid"))


# --------------------------------------------------------------------------
# phases (each runs in a fresh process; prints one MARKER line)

def phase_anchor(net: str, _secs: float) -> dict:
    """Single-core C++ reference mirror: rate and long-run accuracy."""
    from grample_tpu_torch.metrics import error_suite
    from grample_tpu_torch.metrics.divergences import pad_marginals
    from grample_tpu_torch.native import anchor_gibbs
    from grample_tpu_torch.uai import read_mar_file

    path, model = _load(net)
    out = anchor_gibbs(model, ANCHOR_SAMPLES, seed=5)
    if out is None:
        return {}
    counts, _secs_used, rate = out
    res = {"anchor_samples_per_sec": round(rate, 1)}
    mar = path + ".MAR"
    if os.path.exists(mar):
        k = counts.shape[1]
        est = counts.astype(np.float64)
        est += (np.arange(k)[None, :] < model.cards[:, None]) / np.maximum(
            model.cards[:, None], 1
        )
        sol = pad_marginals(read_mar_file(mar), model.cards)
        a = error_suite(est, sol, model.cards, model.fixed, None)
        res["anchor_mean_hellinger"] = round(float(a.mean_hellinger), 4)
    return res


def phase_throughput(net: str, _secs: float) -> dict:
    """Counted site-samples/s of the sweep at ``bench_chains`` chains."""
    device = _device()
    import torch

    from grample_tpu_torch.ops import gibbs_cuda
    from grample_tpu_torch.ops.bound import card_line, site_operations
    from grample_tpu_torch.sampler.chains import ChainGroup

    _, model = _load(net)
    chains = bench_chains(model.num_vars, int(model.max_card), CHAINS)
    g = ChainGroup(model, chains, 256, device, seed=42)
    g.add_variant(model)
    g.burn(8)
    g.advance(8)  # first counted launch, and settle
    on_card = g.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(g.device)
    t0 = time.perf_counter()
    taken = 0
    # deferred windows: count deltas stay on the device between windows,
    # as the engine dispatches them
    for _ in range(3):
        taken += g.advance(256, defer=True)
    g.flush()
    if on_card:
        torch.cuda.synchronize(g.device)
    rate = taken / (time.perf_counter() - t0)
    ops = site_operations(g.kdim, count=True, gather=g.caps.gfac_cap > 0)
    return {
        "device_samples_per_sec": round(rate, 1),
        "route": g.route,
        "est_ops_per_site": ops,
        "est_tops": round(rate * ops / 1e12, 2),
        "device": card_line() if on_card else g.device.type,
        "launches_by_form": dict(gibbs_cuda.gibbs_window.launches_by_form),
    }


def phase_engine(net: str, secs: float) -> dict:
    """Adaptive engine run at a real budget; scores against .MAR and merlin."""
    device = _device()
    from grample_tpu_torch.sampler.engine import Engine, EngineConfig

    path, model = _load(net)
    cfg = EngineConfig(
        model_path=path,
        device=device,
        use_evidence=os.path.exists(path + ".evid"),
        use_solution=True,
        sampler="adaptive",
        chains=2,
        chains_per_variant=ENGINE_VCHAINS,
        chain_adds=4,  # reference script/experiment:5-38
        max_secs=secs,
        seed=1,
        burnin=2000 * model.num_vars,  # the window is the burn-in: 2000 sweeps
    )
    res = Engine(cfg, log=lambda s: None).run()
    out = {
        "engine_samples_per_sec": round(res.samples_per_sec, 1),
        "engine_budget_secs": secs,
        "samples": res.samples,
        "chains": res.chains,
        "collapsed_vars": len(res.collapsed),
        "mean_hellinger": round(float(res.final_score.mean_hellinger), 4),
        "max_hellinger": round(float(res.final_score.max_hellinger), 4),
        "kernel": res.kernel,
    }
    if res.merlin_score is not None:
        out["merlin_mean_hellinger"] = round(float(res.merlin_score.mean_hellinger), 4)
        out["merlin_max_hellinger"] = round(float(res.merlin_score.max_hellinger), 4)
        out["beats_merlin_mean"] = bool(
            out["mean_hellinger"] <= out["merlin_mean_hellinger"]
        )
    return out


PHASES = {
    "anchor": phase_anchor,
    "throughput": phase_throughput,
    "engine": phase_engine,
}


def run_phase_subprocess(phase: str, net: str, timeout: float, secs: float = 0.0) -> dict:
    """Run one phase in a fresh process; a failure is an ``error`` entry."""
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "grample_tpu_torch.bench", phase, net, str(secs)],
            capture_output=True,
            text=True,
            timeout=timeout,
            cwd=REPO,
        )
    except subprocess.TimeoutExpired:
        return {"error": f"{phase} failed: timeout after {timeout:.0f}s"}
    for line in proc.stdout.splitlines():
        if line.startswith(MARKER):
            return json.loads(line[len(MARKER):])
    err = (proc.stderr or "").strip().splitlines()
    return {"error": f"{phase} failed: " + (err[-1][:200] if err else f"exit {proc.returncode}")}


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] in PHASES:
        secs = float(sys.argv[3]) if len(sys.argv) > 3 else SECS
        print(MARKER + json.dumps(PHASES[sys.argv[1]](sys.argv[2], secs)))
        return 0

    t0 = time.time()
    deadline = t0 + WALL

    def remaining() -> float:
        return deadline - time.time()

    nets = [n for n in NETS if os.path.exists(os.path.join(RES, n + ".uai"))]
    detail = {n: {} for n in nets}
    skipped = []

    # ---- priority 1: the headline ratio (anchor + throughput per net) ----
    for name in nets:
        if remaining() < 60:
            skipped.append(f"anchor/throughput:{name}")
            continue
        # the anchor's timeout from its sample count at a floor of 1e6
        # samples/s (measured anchors run near 1e7/s)
        anchor_timeout = min(remaining(), max(600.0, ANCHOR_SAMPLES / 1e6))
        detail[name].update(run_phase_subprocess("anchor", name, anchor_timeout))
        if "anchor_samples_per_sec" not in detail[name]:
            skipped.append(f"anchor:{name}:" + str(
                detail[name].get("error", "no rate"))[:80])
        budget = min(420, remaining())
        if budget < 60:
            skipped.append(f"throughput:{name}")
            continue
        detail[name].update(run_phase_subprocess("throughput", name, budget))

    # ---- priority 2: engine quality legs, budgets shrunk to fit ----------
    for i, name in enumerate(nets):
        legs_left = len(nets) - i
        # wall model: OVERHEAD + sampling budget + adapt-step compensation
        # (at most one budget) -> solve for secs from the share
        share = remaining() / legs_left - ENGINE_OVERHEAD
        secs = min(SECS, share / 2)
        if secs < min(30, SECS):
            skipped.append(f"engine:{name}")
            continue
        timeout = min(remaining(), ENGINE_OVERHEAD + 2 * secs + 120)
        detail[name].update(run_phase_subprocess("engine", name, timeout, secs=secs))

    headline_rate = None
    headline_anchor = None
    for name in nets:
        d = detail[name]
        if d.get("anchor_samples_per_sec") and d.get("device_samples_per_sec"):
            d["speedup_vs_anchor"] = round(
                d["device_samples_per_sec"] / d["anchor_samples_per_sec"], 1
            )
        if headline_rate is None and d.get("device_samples_per_sec"):
            headline_rate = d["device_samples_per_sec"]
            headline_anchor = d.get("anchor_samples_per_sec")

    out = {
        "metric": f"gibbs_site_samples_per_sec ({nets[0] if nets else '-'}, {CHAINS} chains)",
        "value": headline_rate,
        "unit": "samples/s/gpu",
        "vs_baseline": round(headline_rate / headline_anchor, 1)
        if headline_rate and headline_anchor
        else None,
        "baseline": "measured single-core C++ reference-mirror (samples/s)",
        "detail": detail,
        "wall_s": round(time.time() - t0, 1),
        "wall_budget_s": WALL,
    }
    if skipped:
        out["skipped"] = skipped
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
