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
  3b. the same for the kernel's wide-table form: 8 collapse variants of a
     Promedus-shaped Bayes net (916 binary vars, CPTs of 0-2 parents, 5 %
     evidence; ``tests/torch_models.py::promedus_like``), its 8 widest
     collapsible vars, whose stacked local tables have 33-256 rows
     (asserted), 8 x 16384 chains, one sweep, counted and uncounted;
  4. the main path through the CLI: ``sample -s simple`` on a 4x4 grid
     with evidence and an exact ``.MAR``, 2 x 131072 chains; the MAR it
     writes must be within 0.005 max Hellinger of the exact marginals
     (5 sigma of that sample count, see ``HELL_BOUND``) and the kernel's
     launch counter must have grown;
  4b. the collapsed path through the CLI: ``sample -s collapsed -c 8
     --vchains 32768`` on a fully connected 8-var binary net with
     evidence (every collapse variant has 64-row local tables), long
     enough for the RB mixture to take over; the same Hellinger bound,
     the launch counter grown, the collapsed vars in the log;
  5. timing (CUDA events; each line names the card and its power limit):
     the 10x10 grid at 262144 chains, one 256-sweep counted window,
     kernel and plain; the 8 Promedus-shaped collapse variants at 8 x
     16384 chains, a 256-sweep counted window on the kernel and a shorter
     one on both kernel and plain, with occupancy and table bytes; the
     same window on 8 plain copies of the net; and an engine run
     ``-s collapsed -c 8 --vchains 16384`` on that net, about 10 s of
     sampling, with its counted site-samples/s and peak device memory;
  6. a JSON line describing each kernel form, then, last,
     ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository beside it; without either it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import io
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
#: collapse variants x chains per variant of the wide-table phases
WIDE_SLOTS, WIDE_CHAINS = 8, 16384
#: counted sweeps of the window timed on both the kernel and the plain
#: version (the plain version takes about 0.7 s per sweep there on an H100)
WIDE_PAIR_SWEEPS = 8
#: chains per collapse variant of the collapsed CLI run (8 x 32768)
COLLAPSED_CHAINS = 32768
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


def window_inputs(torch, dev, variants, caps, chains):
    """Kernel-order sweep tensors of ``variants`` encoded against ``caps``,
    a random kernel-order state of ``chains`` chains per variant with
    evidence pinned, its free-row mask [N, NSLOT], and the free sites of
    one chain summed over the variants."""
    from grample_tpu_torch.ops.sweep import check_supported, sweep_tensors
    from grample_tpu_torch.pgm.encode import encode_model, stack_variants

    check_supported(caps)
    encs = [encode_model(v, caps) for v in variants]
    kst = sweep_tensors(stack_variants(encs), dev)
    n = len(variants)
    rng = np.random.default_rng(SEED)
    state_p = rng.integers(0, 2, size=(n, caps.num_rows, chains), dtype=np.int32)
    oon = kst["pal_oon"].cpu().numpy()  # kernel row -> old var
    for i in range(n):
        fixed = encs[i].fixed[oon[i]]  # [NVp]; sentinel/dead rows pinned 0
        state_p[i] = np.where(fixed[:, None] >= 0, fixed[:, None], state_p[i])
    free_rows = kst["k_kmask"].reshape(n, -1, caps.max_card).any(dim=2)
    n_free = sum(int(v.free_mask.sum()) for v in variants)
    return kst, torch.as_tensor(state_p, device=dev), free_rows, n_free


def grid_variants():
    """The 10x10 grid's 2 variants (tables from seeds 1 and 2, 3 evidence
    vars) and their caps."""
    from grample_tpu_torch.pgm.encode import compute_caps

    models = [grid_model(10, s) for s in (1, 2)]
    for m in models:
        m.apply_evidence({0: 1, 55: 0, 99: 1})
    return models, compute_caps(models[0], headroom_factors=0)


def promedus_variants(wide: bool):
    """The Promedus-shaped net's 8 widest collapse variants (``wide``) or 8
    plain copies of it, their caps, and the net (evidence applied)."""
    from grample_tpu_torch.pgm import discrete
    from grample_tpu_torch.pgm.encode import caps_for_variants, compute_caps
    from grample_tpu_torch.sampler.collapse import collapse_var
    from tests import torch_models

    m, evidence = torch_models.promedus_like(discrete, seed=1)
    m.apply_evidence(evidence)
    if not wide:
        return [m] * WIDE_SLOTS, compute_caps(m, headroom_factors=0), m
    picks = torch_models.widest_collapsible(discrete, m, WIDE_SLOTS)
    variants = [collapse_var(m, v)[0] for v in picks]
    return variants, caps_for_variants(variants, slot_hint=WIDE_SLOTS), m


def compare_window(torch, kernel, plain, args, state0, free_rows, n_free, nslot,
                   chains, cb, label):
    """One counted and one uncounted sweep through the kernel and the plain
    version from the same state; returns the largest state difference."""
    max_err = 0
    for count in (True, False):
        sk, ck = kernel(*args, state0.clone(), SEED, 1, 0, count, cb)
        sp, cp = plain(*args, state0.clone(), SEED, 1, 0, count, cb)
        torch.cuda.synchronize()
        diff = (sk[:, :nslot] != sp[:, :nslot]) & free_rows[:, :, None]
        frac = diff.sum().item() / (free_rows.sum().item() * chains)
        max_err = max(max_err, int((sk - sp).abs().max().item()))
        check(frac <= MAX_MISMATCH, f"{label} count={count}: {frac:.2e} of free sites differ")
        check(torch.equal(sk[:, nslot:], state0[:, nslot:]),
              f"{label}: kernel wrote a tail (evidence/sentinel) row")
        check(torch.equal(sp[:, nslot:], state0[:, nslot:]),
              f"{label}: plain version wrote a tail (evidence/sentinel) row")
        if count:
            want = chains * n_free  # one sweep: every free site of every chain
            for name, cn in (("kernel", ck), ("plain", cp)):
                got = int((cn.sum(dim=(1, 2, 4)) * free_rows).sum().item())
                check(got == want, f"{label}: {name} count total {got} != {want}")
            agree = (sk[:, :nslot] == sp[:, :nslot]).all(dim=0)  # [NSLOT, C]
            check(torch.equal(ck[:, :, :, agree], cp[:, :, :, agree]),
                  f"{label}: counts differ where states agree")
        print(f"{label}: kernel vs plain (count={count}): {frac:.3e} of free sites "
              f"differ (bound {MAX_MISMATCH}), tail rows intact", flush=True)
    return max_err


def write_net(td, name, model, evidence, truth=None):
    """``<name>.uai``, ``.evid`` and (given ``truth``) an exact ``.MAR``."""
    from grample_tpu_torch.uai.writer import write_mar, write_model

    path = os.path.join(td, f"{name}.uai")
    with open(path, "w") as fh:
        fh.write(write_model(model))
    with open(path + ".evid", "w") as fh:
        fh.write(f"{len(evidence)} " + " ".join(f"{k} {v}" for k, v in evidence.items()))
    if truth is not None:
        with open(path + ".MAR", "w") as fh:
            fh.write(write_mar([truth[i, : model.cards[i]] for i in range(model.num_vars)]))
    return path


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
    from grample_tpu_torch.pgm import discrete
    from grample_tpu_torch.pgm.encode import COLLAPSE_OA_DENSE_CAP, caps_for_variants
    from grample_tpu_torch.pgm.exact import exact_marginals
    from grample_tpu_torch.sampler.collapse import collapse_var, pick_random_collapsible
    from grample_tpu_torch.sampler.engine import Engine, EngineConfig
    from grample_tpu_torch.uai import read_mar_file
    from tests import torch_models

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
    models, caps = grid_variants()
    kst, state0, free_rows, n_free = window_inputs(torch, dev, models, caps, GRID_CHAINS)
    args = [kst[k] for k in KERNEL_KEYS]
    cb = hash_block(GRID_CHAINS)
    max_err = compare_window(torch, gibbs_cuda.gibbs_window, window_plain, args, state0,
                             free_rows, n_free, caps.num_slots, GRID_CHAINS, cb,
                             "10x10 grid")

    # ---- 3b. the wide-table form against the plain version -------------------
    t0 = time.perf_counter()
    wvariants, wcaps, promedus = promedus_variants(True)
    wkst, wstate0, wfree, wn_free = window_inputs(torch, dev, wvariants, wcaps, WIDE_CHAINS)
    wargs = [wkst[k] for k in KERNEL_KEYS]
    check(32 < wcaps.oa_cap <= 256, f"collapse variants' oa_cap {wcaps.oa_cap} not in (32, 256]")
    collapsed = [int(np.nonzero(v.collapsed)[0][0]) for v in wvariants]
    print(f"Promedus-shaped net: {promedus.num_vars} vars, "
          f"{int((promedus.fixed >= 0).sum())} evidence, collapse variants of vars "
          f"{collapsed}: oa_cap {wcaps.oa_cap}, scope_cap {wcaps.scope_cap}, "
          f"adj_cap {wcaps.adj_cap}, NVp {wcaps.num_rows} (host set-up "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    wide_err = compare_window(torch, gibbs_cuda.gibbs_window, window_plain, wargs, wstate0,
                              wfree, wn_free, wcaps.num_slots, WIDE_CHAINS,
                              hash_block(WIDE_CHAINS), f"{WIDE_SLOTS} collapse variants")

    # ---- 4. the main path through the CLI ------------------------------------
    model = grid_model(4, 7)
    evidence = {5: 1, 10: 0}
    with tempfile.TemporaryDirectory() as td:
        model_ev = grid_model(4, 7)
        model_ev.apply_evidence(evidence)
        truth = exact_marginals(model_ev)
        path = write_net(td, "grid4", model, evidence, truth)
        model = model_ev
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

    # ---- 4b. the collapsed path through the CLI ------------------------------
    make, evidence = torch_models.MODELS["full8_evid"]
    model = make(discrete)
    model_ev = make(discrete)
    model_ev.apply_evidence(evidence)
    truth = exact_marginals(model_ev)
    rng = np.random.default_rng(SEED)  # the engine's prebuild draws
    picks = [pick_random_collapsible(model_ev, rng, oa_cap=COLLAPSE_OA_DENSE_CAP)
             for _ in range(8)]
    ccaps = caps_for_variants([collapse_var(model_ev, p)[0] for p in picks], slot_hint=8)
    check(ccaps.oa_cap == 64, f"collapsed CLI variants' oa_cap {ccaps.oa_cap} != 64")
    with tempfile.TemporaryDirectory() as td:
        path = write_net(td, "full8", model, evidence, truth)
        mar_out = os.path.join(td, "out.MAR")
        v = model.num_vars
        out = io.StringIO()
        gibbs_cuda.gibbs_window.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([
                "sample", "-m", path, "-d", "-o", "-s", "collapsed", "-c", "8",
                "--vchains", str(COLLAPSED_CHAINS), "-b", str(200 * v), "-w", str(100 * v),
                "-x", "20", "-e", str(SEED), "--mar-out", mar_out,
            ])
        torch.cuda.synchronize()
        col_secs = time.perf_counter() - t0
        col_launches = gibbs_cuda.gibbs_window.launches
        log = out.getvalue()
        check(rc == 0, f"collapsed cli returned {rc}")
        check(col_launches > 0, "the collapsed CLI run did not launch the sweep kernel")
        logged = sorted({int(ln.split("collapsed var ")[1].split()[0])
                         for ln in log.splitlines() if "collapsed var" in ln})
        check(logged == sorted(set(picks)),
              f"log shows collapsed vars {logged}, the seed picks {sorted(set(picks))}")
        est = pad_marginals(read_mar_file(mar_out), model.cards)
        check(np.isfinite(est).all() and est.shape == (v, 2), "bad MAR output")
        col_score = error_suite(est, truth, model_ev.cards, model_ev.fixed, None)
    print("\n".join(ln for ln in log.splitlines() if "collapsed var" in ln or "FINAL" in ln),
          flush=True)
    check(col_score.max_hellinger < HELL_BOUND,
          f"collapsed: max Hellinger {col_score.max_hellinger:.5f} >= {HELL_BOUND}")
    print(f"cli sample -s collapsed -c 8 --vchains {COLLAPSED_CHAINS}: {col_secs:.1f} s, "
          f"{col_launches} kernel launches, collapsed vars {logged} (local tables of "
          f"{ccaps.oa_cap} rows), max Hellinger {col_score.max_hellinger:.6f} "
          f"(bound {HELL_BOUND})", flush=True)

    # ---- 5. timing ---------------------------------------------------------
    def timed(fn, a, st0, sweeps, count=True) -> float:
        st = st0.clone()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*a, st, SEED, sweeps, sweeps // 2, count, cb)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    def rate_line(label, sites, kernel_ms, plain_ms=None):
        text = (f"timing ({card}): {label}: kernel {kernel_ms:.3f} ms = "
                f"{sites / (kernel_ms / 1e3):.4e} site-samples/s")
        if plain_ms is not None:
            text += (f", plain {plain_ms:.3f} ms = {sites / (plain_ms / 1e3):.4e} "
                     f"site-samples/s, kernel/plain speed {plain_ms / kernel_ms:.2f}x")
            if kernel_ms >= plain_ms:
                text += " (the kernel is SLOWER)"
        print(text, flush=True)

    sites = TIMED_SWEEPS * GRID_CHAINS * n_free
    gibbs_cuda.gibbs_window(*args, state0.clone(), SEED, 1, 0, True, cb)  # warm
    kernel_ms = min(timed(gibbs_cuda.gibbs_window, args, state0, TIMED_SWEEPS),
                    timed(gibbs_cuda.gibbs_window, args, state0, TIMED_SWEEPS))
    plain_ms = timed(window_plain, args, state0, TIMED_SWEEPS)
    uncounted_ms = min(timed(gibbs_cuda.gibbs_window, args, state0, TIMED_SWEEPS, False),
                       timed(gibbs_cuda.gibbs_window, args, state0, TIMED_SWEEPS, False))
    rate_line(f"10x10 grid, 262144 chains, {TIMED_SWEEPS}-sweep counted window", sites,
              kernel_ms, plain_ms)
    print(f"timing: the same window uncounted: kernel {uncounted_ms:.3f} ms "
          f"({uncounted_ms / kernel_ms:.3f} of the counted window)", flush=True)

    threads, blocks = gibbs_cuda.occupancy(wcaps.max_card, True, wcaps.num_rows)
    table_mb = wkst["k_tables"][0].numel() * 4 / 1e6
    print(f"collapse variants: {threads} threads per block, {blocks} block(s) per SM "
          f"({wcaps.num_rows * threads} bytes of state per block), k_tables "
          f"{table_mb:.1f} MB per variant, {WIDE_SLOTS * table_mb:.1f} MB in all", flush=True)
    wsites = WIDE_CHAINS * wn_free
    # one run: it takes about 80 s on an H100 (see PERF.md)
    wide_full_ms = timed(gibbs_cuda.gibbs_window, wargs, wstate0, TIMED_SWEEPS)
    rate_line(f"{WIDE_SLOTS} collapse variants x {WIDE_CHAINS} chains, {TIMED_SWEEPS}-sweep "
              "counted window", TIMED_SWEEPS * wsites, wide_full_ms)
    wide_ms = min(timed(gibbs_cuda.gibbs_window, wargs, wstate0, WIDE_PAIR_SWEEPS),
                  timed(gibbs_cuda.gibbs_window, wargs, wstate0, WIDE_PAIR_SWEEPS))
    wide_plain_ms = timed(window_plain, wargs, wstate0, WIDE_PAIR_SWEEPS)
    rate_line(f"the same variants, {WIDE_PAIR_SWEEPS}-sweep counted window",
              WIDE_PAIR_SWEEPS * wsites, wide_ms, wide_plain_ms)
    del wkst, wargs, wstate0

    pvariants, pcaps, _ = promedus_variants(False)
    pkst, pstate0, _, pn_free = window_inputs(torch, dev, pvariants, pcaps, WIDE_CHAINS)
    pargs = [pkst[k] for k in KERNEL_KEYS]
    pthreads, pblocks = gibbs_cuda.occupancy(pcaps.max_card, True, pcaps.num_rows)
    plain_copy_ms = min(timed(gibbs_cuda.gibbs_window, pargs, pstate0, TIMED_SWEEPS),
                        timed(gibbs_cuda.gibbs_window, pargs, pstate0, TIMED_SWEEPS))
    rate_line(f"{WIDE_SLOTS} plain copies (oa_cap {pcaps.oa_cap}, NVp {pcaps.num_rows}, "
              f"{pthreads} threads, {pblocks} block(s) per SM) x {WIDE_CHAINS} chains, "
              f"{TIMED_SWEEPS}-sweep counted window", TIMED_SWEEPS * WIDE_CHAINS * pn_free,
              plain_copy_ms)
    print(f"timing: collapse variants / plain copies, time per counted site: "
          f"{(wide_full_ms / wsites) / (plain_copy_ms / (WIDE_CHAINS * pn_free)):.3f}",
          flush=True)
    del pkst, pargs, pstate0

    with tempfile.TemporaryDirectory() as td:
        m_plain, p_evidence = torch_models.promedus_like(discrete, seed=1)
        path = write_net(td, "promedus", m_plain, p_evidence)
        v = m_plain.num_vars
        cfg = EngineConfig(
            model_path=path, device="cuda", use_evidence=True, sampler="collapsed",
            chains=WIDE_SLOTS, chains_per_variant=WIDE_CHAINS, burnin=50 * v,
            converge_window=100 * v, max_secs=10.0, seed=SEED)
        lines = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = Engine(cfg, log=lines.append).run()
        torch.cuda.synchronize()
        eng_secs = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(res.samples > 0 and np.isfinite(res.marginals).all(), "engine run produced nothing")
    print(f"timing ({card}): engine -s collapsed -c {WIDE_SLOTS} --vchains {WIDE_CHAINS} on "
          f"the Promedus-shaped net: {res.samples_per_sec:.4e} counted site-samples/s over "
          f"{res.runtime:.2f} s of sampling clock ({eng_secs:.2f} s wall, {res.sweeps} "
          f"sweeps), collapsed vars {res.collapsed}, peak device memory {peak_gb:.2f} GB",
          flush=True)

    # ---- 6. results --------------------------------------------------------
    source = "grample_tpu_torch/csrc/gibbs_window.cu"
    kernels = [{
        "name": "gibbs_window",
        "route": "cuda",
        "source": source,
        "replaces": "grample_tpu/ops/gibbs_pallas.py:297",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }, {
        "name": "gibbs_window (wide-OA form)",
        "route": "cuda",
        "source": source,
        "replaces": "grample_tpu/ops/gibbs_pallas.py:355-367",
        "launches": col_launches,
        "max_abs_err": wide_err,
        "ms": wide_ms,
        "plain_ms": wide_plain_ms,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
