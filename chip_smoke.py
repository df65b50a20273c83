#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``grample_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the sweep kernel from ``grample_tpu_torch/csrc`` with nvcc;
  3. the kernel against its plain PyTorch version on the card: a 10x10
     binary grid (100 vars, 280 factors, 3 evidence vars), 2 variants x
     131072 chains, the same seed and hash width, one sweep, counted and
     uncounted.  At most 0.1 % of free sites may differ (a draw that sits
     on a CDF boundary can flip with expf's last bit); count totals must
     equal sweeps x chains x free vars exactly; evidence rows must stay;
  4. the main path through the CLI: ``sample -s simple`` on a 4x4 grid
     with evidence and an exact ``.MAR``, 2 x 131072 chains; the MAR it
     writes must be within 0.005 max Hellinger of the exact marginals
     (5 sigma of that sample count, see ``HELL_BOUND``) and the kernel's
     launch counter must have grown;
  5. timing: counted site-samples/s of the kernel and of the plain
     version on the 10x10 grid at 262144 chains, one 256-sweep window;
  6. a JSON line describing each kernel, then, last,
     ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository beside it; without either it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 1234
GRID_CHAINS = 131072  # per variant; 2 variants = 262144 chains
TIMED_SWEEPS = 256
MAX_MISMATCH = 1e-3
#: 5 sigma of the max Hellinger error for >= 262144 independent draws per
#: var: sigma_H ~ 1/sqrt(8 N) = 6.9e-4 -> 5 sigma = 3.5e-3, plus at most
#: 7e-4 bias from each chain's uniform 1/card seed over >= 500 counted
#: sweeps
HELL_BOUND = 0.005


def grid_model(side: int, seed: int):
    """Binary grid Markov net: one unary factor per var, one pairwise per
    edge (the Grids_* family shape; ``__graft_entry__._grid_model``)."""
    from grample_tpu_torch.pgm.discrete import DiscreteModel, Factor

    rng = np.random.default_rng(seed)
    v = side * side
    factors = [Factor(f"u{i}", [i], rng.random(2) + 0.2) for i in range(v)]
    for r in range(side):
        for c in range(side):
            i = r * side + c
            if c + 1 < side:
                factors.append(Factor(f"h{i}", [i, i + 1], rng.random(4) + 0.2))
            if r + 1 < side:
                factors.append(Factor(f"v{i}", [i, i + side], rng.random(4) + 0.2))
    return DiscreteModel(type="MARKOV", cards=[2] * v, factors=factors)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def grid_window_inputs(torch, dev):
    """Kernel-order inputs of the 10x10 grid, 2 variants x GRID_CHAINS."""
    from grample_tpu_torch.ops.sweep import sweep_tensors
    from grample_tpu_torch.pgm.encode import compute_caps, encode_model, stack_variants

    models = [grid_model(10, s) for s in (1, 2)]
    evidence = {0: 1, 55: 0, 99: 1}
    for m in models:
        m.apply_evidence(evidence)
    caps = compute_caps(models[0], headroom_factors=0)
    encs = [encode_model(m, caps) for m in models]
    kst = sweep_tensors(stack_variants(encs), dev)
    rng = np.random.default_rng(SEED)
    nvp = caps.num_rows
    state_p = rng.integers(0, 2, size=(2, nvp, GRID_CHAINS), dtype=np.int32)
    oon = kst["pal_oon"].cpu().numpy()  # kernel row -> old var
    for n in range(2):
        fixed = encs[n].fixed[oon[n]]  # [NVp]; sentinel/dead rows pinned 0
        state_p[n] = np.where(fixed[:, None] >= 0, fixed[:, None], state_p[n])
    free_rows = kst["k_kmask"].reshape(2, -1, caps.max_card).any(dim=2)  # [N, NSLOT]
    n_free = int(models[0].free_mask.sum())
    return kst, torch.as_tensor(state_p, device=dev), free_rows, n_free, caps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from grample_tpu_torch import cli
    from grample_tpu_torch.metrics import error_suite
    from grample_tpu_torch.metrics.divergences import pad_marginals
    from grample_tpu_torch.ops import _build, gibbs_cuda
    from grample_tpu_torch.ops.gibbs_torch import window_plain
    from grample_tpu_torch.ops.sweep import KERNEL_KEYS, hash_block
    from grample_tpu_torch.pgm.exact import exact_marginals
    from grample_tpu_torch.uai import read_mar_file
    from grample_tpu_torch.uai.writer import write_mar, write_model

    dev = torch.device("cuda:0")

    # ---- 1. the card -----------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    gibbs_cuda._lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(_build.library_path())}", flush=True)

    # ---- 3. kernel against the plain version --------------------------------
    kst, state0, free_rows, n_free, caps = grid_window_inputs(torch, dev)
    args = [kst[k] for k in KERNEL_KEYS]
    cb = hash_block(GRID_CHAINS)
    nslot = caps.num_slots
    max_err = 0
    for count in (True, False):
        sk, ck = gibbs_cuda.gibbs_window(*args, state0.clone(), SEED, 1, 0, count, cb)
        sp, cp = window_plain(*args, state0.clone(), SEED, 1, 0, count, cb)
        torch.cuda.synchronize()
        diff = (sk[:, :nslot] != sp[:, :nslot]) & free_rows[:, :, None]
        frac = diff.sum().item() / (free_rows.sum().item() * GRID_CHAINS)
        max_err = max(max_err, int((sk - sp).abs().max().item()))
        check(frac <= MAX_MISMATCH, f"count={count}: {frac:.2e} of free sites differ")
        check(torch.equal(sk[:, nslot:], state0[:, nslot:]),
              "kernel wrote a tail (evidence/sentinel) row")
        check(torch.equal(sp[:, nslot:], state0[:, nslot:]),
              "plain version wrote a tail (evidence/sentinel) row")
        if count:
            want = 1 * 2 * GRID_CHAINS * n_free
            for name, cn in (("kernel", ck), ("plain", cp)):
                got = int((cn.sum(dim=(1, 2, 4)) * free_rows).sum().item())
                check(got == want, f"{name} count total {got} != {want}")
            agree = (sk[:, :nslot] == sp[:, :nslot]).all(dim=0)  # [NSLOT, C]
            check(torch.equal(ck[:, :, :, agree], cp[:, :, :, agree]),
                  "counts differ where states agree")
        print(f"kernel vs plain (count={count}): {frac:.3e} of free sites differ"
              f" (bound {MAX_MISMATCH}), evidence rows intact", flush=True)

    # ---- 4. the main path through the CLI ------------------------------------
    model = grid_model(4, 7)
    evidence = {5: 1, 10: 0}
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "grid4.uai")
        with open(path, "w") as fh:
            fh.write(write_model(model))
        with open(path + ".evid", "w") as fh:
            fh.write(f"{len(evidence)} " + " ".join(f"{k} {v}" for k, v in evidence.items()))
        model.apply_evidence(evidence)
        truth = exact_marginals(model)
        with open(path + ".MAR", "w") as fh:
            fh.write(write_mar([truth[i, :2] for i in range(model.num_vars)]))
        mar_out = os.path.join(td, "out.MAR")
        v = model.num_vars
        gibbs_cuda.gibbs_window.launches = 0
        t0 = time.perf_counter()
        rc = cli.main([
            "sample", "-m", path, "-d", "-o", "-s", "simple",
            "--vchains", str(GRID_CHAINS), "-b", str(200 * v), "-w", str(100 * v),
            "-i", str(4 * 100 * 2 * GRID_CHAINS * (v - len(evidence))),
            "-x", "60", "-e", str(SEED), "--mar-out", mar_out,
        ])
        torch.cuda.synchronize()
        cli_secs = time.perf_counter() - t0
        launches = gibbs_cuda.gibbs_window.launches
        check(rc == 0, f"cli returned {rc}")
        check(launches > 0, "the CLI run did not launch the sweep kernel")
        check(os.path.exists(mar_out), "--mar-out wrote no file")
        est = pad_marginals(read_mar_file(mar_out), model.cards)
        check(np.isfinite(est).all() and est.shape == (v, 2), "bad MAR output")
        score = error_suite(est, truth, model.cards, model.fixed, None)
    check(score.max_hellinger < HELL_BOUND,
          f"max Hellinger {score.max_hellinger:.5f} >= {HELL_BOUND}")
    print(f"cli sample -s simple: {cli_secs:.1f} s, {launches} kernel launches, "
          f"max Hellinger {score.max_hellinger:.6f} (bound {HELL_BOUND})", flush=True)

    # ---- 5. timing ---------------------------------------------------------
    sites = TIMED_SWEEPS * 2 * GRID_CHAINS * n_free

    def timed(fn, count: bool = True) -> float:
        st = state0.clone()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args, st, SEED, TIMED_SWEEPS, TIMED_SWEEPS // 2, count, cb)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    gibbs_cuda.gibbs_window(*args, state0.clone(), SEED, 1, 0, True, cb)  # warm
    kernel_ms = min(timed(gibbs_cuda.gibbs_window), timed(gibbs_cuda.gibbs_window))
    plain_ms = timed(window_plain)
    uncounted_ms = min(timed(gibbs_cuda.gibbs_window, False),
                       timed(gibbs_cuda.gibbs_window, False))
    k_rate, p_rate = sites / (kernel_ms / 1e3), sites / (plain_ms / 1e3)
    print(f"timing ({card}): 10x10 grid, 262144 chains, {TIMED_SWEEPS}-sweep counted "
          f"window: kernel {kernel_ms:.3f} ms = {k_rate:.4e} site-samples/s, plain "
          f"{plain_ms:.3f} ms = {p_rate:.4e} site-samples/s, kernel/plain speed "
          f"{plain_ms / kernel_ms:.2f}x" + ("" if kernel_ms < plain_ms
                                            else " (the kernel is SLOWER)"), flush=True)
    print(f"timing: the same window uncounted: kernel {uncounted_ms:.3f} ms "
          f"({uncounted_ms / kernel_ms:.3f} of the counted window)", flush=True)

    # ---- 6. results --------------------------------------------------------
    kernels = [{
        "name": "gibbs_window",
        "route": "cuda",
        "source": "grample_tpu_torch/csrc/gibbs_window.cu",
        "replaces": "grample_tpu/ops/gibbs_pallas.py:297",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
