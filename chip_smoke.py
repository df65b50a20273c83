#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``grample_tpu_torch``) on one NVIDIA GPU,
and on several where the machine has them (phase 8).

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 8    # the build and phase 8 alone, no result line

Phases, each printed on its own line; any failure raises and exits
non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the sweep kernel from ``grample_tpu_torch/csrc`` with nvcc
     (and print what ``-Xptxas -v`` said of each instance: card bound,
     counted or not, dense bank only or with the gather walk);
  3. the kernel against its plain PyTorch version on the card: a 10x10
     binary grid (100 vars, 280 factors, 3 evidence vars), 2 variants x
     131072 chains, the same seed and hash width, one sweep: every form
     the kernel has (thread per chain and site-parallel, each counted and
     uncounted, and whichever the wrapper's rule picks).  At most 0.1 %
     of free sites may differ (a draw that sits on a CDF boundary can
     flip with expf's last bit); count totals
     on free rows must equal sweeps x chains x free vars exactly and be 0
     elsewhere; evidence rows must stay;
  3b. the same for the kernel's wide-table form: 8 collapse variants of a
     Promedus-shaped Bayes net (916 binary vars, CPTs of 0-2 parents, 5 %
     evidence; ``tests/torch_models.py::promedus_like``), its 8 widest
     collapsible vars, whose stacked local tables have 33-256 rows
     (asserted), 8 x 16384 chains, one sweep, counted and uncounted;
  3c. the same on the collapse-headroom encodings adaptive runs use:
     (a) the 10x10 grid at the single adaptive group's caps (headroom for
     128 slots, two spare factor slots per var), 2 plain slots + 2
     collapse variants, 4 x 32768 chains; (b) the Promedus-shaped net at
     the split group's narrow-tier ``aux_caps`` (local tables of 256 rows,
     4200 padded state rows), 8 collapse variants picked by ``SEED``, 8 x
     256 chains;
  3f. the split group's wide aux tier: the Promedus-shaped net's pooled
     caps (``sampler.split.wide_aux_spec``: the union caps of every
     collapse candidate within 8 outcomes), computed from a cold disk
     cache and read back from a warm one, each timed on the host; 8
     collapse variants of that pool picked by ``SEED`` x ``POOLED_CHAINS``
     chains at those caps, every kernel form against the plain version
     (phase 3's rules), then an 8-sweep counted window both ways from one
     state and seed, the free sites that differ counted (within 3's
     bound) and the count totals held exact;
  3d. the kernel under a device mesh: the 10x10 grid, 2 variants x 131072
     chains, a ``ShardedChainGroup`` on a 2x2 virtual mesh of the one card
     (every shard on ``cuda:0``, launched one after the other) beside a
     ``ChainGroup`` with the same hash width: after a burn and two counted
     windows state, halves and totals must be equal; each shard's launch
     plan, and its window against the plain version on that shard's own
     tensors and seed; the group saved, resumed onto a 1x4 mesh, advanced,
     and held against the group that was never saved; host seconds of a
     flush and of the PSRF moment sum.  A virtual mesh's times say nothing
     about scaling;
  3e. the kernel's gather form (the flat-table gather bank, the
     reference's XLA code ``gibbs_xla.py:129-141``) and the torch-ops
     sweep (``ops.gibbs_bank.window_ops``, its plain version): the 8
     collapse variants of 3b encoded twice, dense and all-gather (every
     incidence in the gather bank); every form of the gather kernel
     against ``window_ops`` (phase 3's rules), then one counted sweep from
     one state and seed three ways: the gather form against
     ``window_ops``, against the dense kernel, and the dense kernel
     against ``window_ops``; each within 3's bound (both banks are summed
     in factor order: only a draw on a CDF boundary can flip between the
     kernel's ``expf`` and ``torch.exp``), the number that differ printed,
     count totals exact and counts equal where the states agree; on the
     dense encoding ``window_ops`` must equal the plain version exactly;
     the gather form, ``window_ops`` on both encodings and the dense
     kernel timed on an 8-sweep counted window (printed with phase 5's
     rows);
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
  4c. the adaptive path through the CLI: ``sample -s adaptive -c 2
     --vchains 131072 -a 2 -x 30`` on the 4x4 grid of phase 4: one group
     (no split group in the log), at least 2 adapt steps and 2 collapsed
     vars, the same Hellinger bound, the launch counter grown;
  4d. the same with ``--split-group on``: the split group in the log and
     aux seconds above 0, the same bounds; its aux group on the wide tier
     (131072 chains per collapse variant, candidate bound 8);
  4e. kill and resume on the card: a group on the 10x10 grid (2 x 131072
     chains) equals, bit for bit, itself saved, loaded and advanced; and
     the run of 4d with ``--checkpoint``, stopped by its budget, then
     ``--resume``d: it continues the sample count and the RB weights, its
     snapshot reloads on the wide tier (the spec's caps, full width);
  4f. ``-s adaptive`` through the engine under a 2x2 virtual mesh of the
     card (``Engine(cfg, devices=[card] * 4)``) on the 4x4 grid of phase 4:
     the ``device mesh:`` line and an ``ADAPT:`` line in the log, the same
     Hellinger bound; and ``--mesh auto`` through the CLI, which on one
     card must run unsharded and say nothing of a mesh (on several it
     shards over them all, as 8c holds);
  4g. tooling: ``dot`` on the 4x4 grid (as many edges as the moral graph
     has); the native anchor sampler (host C++, built with g++) on that
     grid, 2e6 single-site samples, within 0.02 max Hellinger of exact,
     its samples/s printed with the host CPU's name; the UAI parser's
     native tokenizer against the portable one;
  4h. the Promedus-shaped net at the single adaptive group's headroom caps,
     which are all-gather (the kernel's gather form): its window at 2 x
     8192 chains in every form against ``window_ops`` and timed beside
     it; then ``sample -s adaptive -c 2 --vchains 8192 -a 4 --split-group
     off`` through the CLI, and the same under a 2x2 virtual mesh through
     the engine, 20 s each (burn-in 10·V, window 5·V): no raise, the
     ``sweep route: kernel, gather form`` line, kernel launches and no
     torch-ops window, at least one adapt step and one collapsed var, max
     Hellinger against 5b's 30 s ``-s simple`` marginals within
     ``HEAD_HELL_BOUND``; counted site-samples/s of both runs, launches by
     form, peak memory (run after 5b, whose marginals it is held against);
  4i. ``sample -s simple`` on one 12-var binary factor plus unaries (a
     mixed encoding: the wide factor in the gather bank, the unaries
     dense; the kernel's gather form) against exact marginals, the bound
     of phase 4, kernel launches and no torch-ops window;
  4k. the narrow aux tier on the card: ``sample -s adaptive -c 2
     --vchains 131072 -a 2 --split-group on`` on a 2x2 grid at card 9,
     whose candidates all have 9 outcomes or more (no wide spec): the
     ``aux group: narrow tier`` line, at least one adapt step and
     collapsed var, kernel launches, the bound of phase 4 against exact
     marginals;
  4j. ``sample --distributed`` as two rank processes on the one card
     (torchrun's variables: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
     127.0.0.1, a free ``MASTER_PORT``; both see only the first card, as
     ``cuda:0``; each under a timeout): (a) ``-s simple`` on the 10x10 grid, 2 x 131072 chains,
     over a 1x2 world mesh, stopped by ``-i`` after its first window:
     rank 0's MAR must equal, byte for byte, a one-process unsharded run's
     with the same seed; (b) ``-s adaptive -c 2 --vchains 131072 -a 2``
     for ``RANKS_ADAPT_SECS`` on the 4x4 grid of phase 4 over a 2x1 world
     mesh: both ranks exit 0 and log the same adapt steps, the same
     Hellinger bound, its counted site-samples/s beside 4f's; (c) the
     same for ``RANKS_CKPT_SECS`` with a checkpoint, which one unsharded
     process resumes.  Each rank prints its kernel launches and the host
     milliseconds of its collectives (the all-reduce of a flush, of the
     PSRF moments, of the RB blanket indices and of the gathers, rank 0's
     broadcasts) and of its checkpoint saves;
  5. timing (CUDA events; each line names the card and its power limit):
     the 10x10 grid at 262144 chains, one 256-sweep window, each kernel
     form and plain; the headroom encodings of 3c; the 8 Promedus-shaped
     collapse variants at 8 x 16384 chains, a 32-sweep counted window on
     the kernel and a shorter one on both kernel and plain; a 256-sweep
     window on 8 plain copies of the net; for every row its live work
     (sites, incidences, scope entries, table bytes per variant), the
     launch's threads, staging, shared-memory bytes, registers, spills
     and resident blocks per SM, its bound (``bound_ms``: bytes moved
     once, or the arithmetic of its live work, ``window_bound``); the
     grid at card 8 and the Promedus-shaped windows again at other block
     widths and stagings than the wrapper's rule picks; and an engine run
     ``-s collapsed -c 8 --vchains 16384`` on that net, about 10 s of
     sampling, with its counted site-samples/s and peak device memory;
  5b. the adaptive engine on the Promedus-shaped net (the reference's
     bench shape): ``-s adaptive -c 2 --vchains 8192 -a 4``, burn-in
     50·V, window 100·V, 30 s; the gate must pick the split group, and
     its aux group the wide tier (8192 chains per collapse variant,
     candidate bound 8; its spec read from the cache 3f filled).  Its
     adapt steps, collapsed vars, counted site-samples/s, aux share of
     the sampling clock, aux sweeps per tick, host seconds per adapt
     step, the spec's host seconds cold and warm (3f), set-up seconds and
     peak device memory, beside ``-s simple -c 2 --vchains 8192`` at the
     same budget; the 3f window timed with its launch and bound;
  7. the port's bench (``python -m grample_tpu_torch.bench``) on the 4x4
     grid of phase 4 with its exact ``.MAR``, ``BENCH_WALL`` and
     ``BENCH_SECS`` cut to fit: exactly one JSON line, with ``value`` and
     ``vs_baseline`` set, no error and no skipped leg, the throughput
     leg on the kernel route with launches, the engine leg's max Hellinger
     within the bound of phase 4; then the throughput leg in this process
     on the 10x10 grid and the Promedus-shaped net, each rate beside phase
     5's for the same shape, the anchor leg on the latter, and an engine
     leg on it, scored against 5b's ``-s simple`` marginals written as its
     ``.MAR`` (within ``HEAD_HELL_BOUND``), whose wall is printed beside
     its budget, with and without the spec's cold seconds of 3f;
  8. the chain mesh on real cards, where the machine has two or more (N =
     4 with four or more, else 2; with one card it prints ``8: not run: 1
     card``); every line names each card and its power limit: (a) the
     10x10 grid, 2 x (N x 131072) chains, a ``ShardedChainGroup`` on the
     engine's default grid (``chain_mesh()``: 1x2 or 2x2) beside one
     card's ``ChainGroup`` with the same hash width: state, halves and
     totals equal after a burn and two counted windows, each shard's
     tensors on its own card, every card's kernel launches counted
     (``gibbs_window.launches_by_device``); (b) one 256-sweep counted
     window on 1, 2 and N cards, weak (262144 chains a card) and strong
     (2 x 131072 in all), CUDA events on every card and a host clock
     around the window ending in a synchronize on every card, with the
     efficiencies; (c) ``sample -s simple --mesh auto`` on the 4x4 grid of
     phase 4 over the N cards within ``HELL_BOUND``, and the same stopped
     by ``-i 1`` whose MAR equals a one-card ``--mesh off`` run's byte for
     byte; (d) 4h's adaptive run under ``--mesh 2x2`` (1x2 on two cards)
     through the CLI, 20 s, under ``torch.profiler`` (device activity by
     card over the sampling clock): the gather-form route line, an adapt
     step, the bound of 4h against 5b's ``-s simple`` marginals, windows
     launched by card and the active slots of each grid row at every
     tick; (e) ``--distributed`` as N rank processes, rank i seeing card i
     alone (``CUDA_VISIBLE_DEVICES``): 8c's ``-i 1`` run, rank 0's MAR
     equal to 8c's one-card run's, and 4j (b)'s adaptive run on the 4x4
     grid, the same adapt steps on every rank and the bound of phase
     4, with each rank's collectives; (f) a group on the N-card mesh (2 x
     N x 8192 chains) saved, resumed on one card and on a 1xN mesh,
     advanced, equal to the group that was never saved; (g)
     ``python -m grample_tpu_torch.tools.scaling`` on the 10x10 grid at 1,
     2 and N cards: every row on real cards, none in error;
  6. a JSON line describing each kernel form and shape (the gather form's
     rows replace ``gibbs_xla.py:129-141``), then, last,
     ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository beside it; without either it
exits non-zero before printing any result.  Phase 8 runs last, after 7,
and its launches join the sharded launch's entry of the JSON line.  ``HOME`` is pointed at a
temporary directory for the run, so the wide aux spec's disk cache
(``~/.cache/grample_tpu_torch``) starts cold and is removed at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import platform
import re
import socket
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

SEED = 1234
GRID_CHAINS = 131072  # per variant; 2 variants = 262144 chains
TIMED_SWEEPS = 256
#: counted sweeps of the timed windows on the 10x10 grid at card 8
K8_SWEEPS = 64
MAX_MISMATCH = 1e-3
#: collapse variants x chains per variant of the wide-table phases
WIDE_SLOTS, WIDE_CHAINS = 8, 16384
#: counted sweeps of the window timed on both the kernel and the plain
#: version (the plain version takes about 0.7 s per sweep there on an NVIDIA
#: H100 80GB HBM3 at 700.00 W)
WIDE_PAIR_SWEEPS = 8
#: counted sweeps of the longer kernel-only window on the collapse
#: variants
WIDE_FULL_SWEEPS = 32
#: chains per variant of the headroom-encoding comparison on the grid
HEADROOM_CHAINS = 32768
#: chains per collapse variant at the wide aux tier's pooled caps (3f):
#: 5b's full width, ``--vchains 8192``
POOLED_CHAINS = 8192
#: chains per collapse variant of the collapsed CLI run (8 x 32768)
COLLAPSED_CHAINS = 32768
#: 5 sigma of the max Hellinger error for >= 262144 independent draws per
#: var: sigma_H ~ 1/sqrt(8 N) = 6.9e-4 -> 5 sigma = 3.5e-3, plus at most
#: 7e-4 bias from each chain's uniform 1/card seed over >= 500 counted
#: sweeps
HELL_BOUND = 0.005
#: sampling-clock budget (s) of the 5b runs
ADAPT_SECS = 30
#: the same of the adaptive CLI runs 4c, 4d (and 4e: a third, then two)
CLI_ADAPT_SECS = 21
#: budget (s) and chains per variant of each 4h run (the reference's
#: bench shape, ``-c 2 --vchains 8192``)
HEAD_SECS, HEAD_CHAINS = 20, 8192
#: max Hellinger of a 4h run against the 30 s ``-s simple`` run: a burn-in
#: of 10 sweeps, and vars collapsed late hold few RB snapshots (on the
#: torch-ops route, which counted about 1e3 times fewer samples, some 1e5
#: effective draws per var: 5 sigma about 0.006); a wrong table lookup
#: shows as 0.1 and more
HEAD_HELL_BOUND = 0.02
#: sampling-clock budget (s) of the narrow-tier run 4k
NARROW_SECS = 10
#: sampling-clock budgets (s) of phase 4j: the adaptive run over two ranks,
#: the same with a checkpoint, and what the one-process run that resumes
#: it adds to the snapshot's clock
RANKS_ADAPT_SECS, RANKS_CKPT_SECS, RESUME_SECS = 15, 3, 4
#: seconds a 4j rank process may take before the script fails
RANK_TIMEOUT = 240
#: phase 8: chains per card of the weak-scaling window (2 variants x half
#: that) and timed repeats of each shape after one warm window; chains per
#: variant per card of the checkpoint groups (8f); seconds a rank process
#: of 8e, or the scaling tool (8g), may take before the script fails
SCALE_CHAINS, SCALE_REPS = 2 * GRID_CHAINS, 3
CKPT_CHAINS = 8192
MESH_RANK_TIMEOUT = 300
#: phase 7: the bench's wall budget and engine budget (s)
BENCH_WALL, BENCH_SECS = 240, 20
#: one rank of phases 4j and 8e: the CLI under torchrun's variables, then
#: one line with this rank's kernel launches by form and by card and, for
#: each caller of a
#: collective (a group method for the all-reduces, the engine's ``_run``
#: for rank 0's broadcasts, ``save_checkpoint`` for the saves), its calls,
#: host milliseconds in all and the least of one call: a call's time
#: includes its wait for the other rank
RANK_CHILD = r"""
import collections, json, os, sys, time
from grample_tpu_torch import cli
from grample_tpu_torch.ops import gibbs_cuda
from grample_tpu_torch.parallel import distributed
from grample_tpu_torch.sampler import checkpoint

held = collections.defaultdict(lambda: [0, 0.0, float("inf")])

def timed(fn, depth):
    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        entry = held[sys._getframe(depth).f_code.co_name]
        entry[0] += 1
        entry[1] += ms
        entry[2] = min(entry[2], ms)
        return out
    return call

distributed.allreduce_sum = timed(distributed.allreduce_sum, 2)
distributed.from_main = timed(distributed.from_main, 1)
checkpoint.save_checkpoint = timed(checkpoint.save_checkpoint, 1)
rc = cli.main(sys.argv[1:])
print("rank " + json.dumps({"rank": int(os.environ["RANK"]),
                            "launches": dict(gibbs_cuda.gibbs_window.launches_by_form),
                            "by_card": dict(gibbs_cuda.gibbs_window.launches_by_device),
                            "collectives": held}), flush=True)
sys.exit(rc)
"""
REPO = os.path.dirname(os.path.abspath(__file__))


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def window_inputs(torch, dev, variants, caps, chains):
    """Kernel-order sweep tensors of ``variants`` encoded against ``caps``,
    a random kernel-order state of ``chains`` chains per variant with
    evidence pinned, its free-row mask [N, NSLOT], and the free sites of
    one chain summed over the variants."""
    from grample_tpu_torch.ops.sweep import kernel_refusal, sweep_tensors
    from grample_tpu_torch.pgm.encode import encode_model, stack_variants

    assert kernel_refusal(caps) is None, kernel_refusal(caps)
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


def grid_model(side: int, seed: int):
    """Binary grid Markov net: one unary factor per var, one pairwise per
    edge (the Grids_* family shape)."""
    from grample_tpu_torch.pgm import discrete
    from tests import torch_models

    return torch_models.grid(discrete, side, seed)


def grid_variants(card: int = 2):
    """The 10x10 grid's 2 variants (tables from seeds 1 and 2, 3 evidence
    vars) and their caps."""
    from grample_tpu_torch.pgm import discrete
    from tests import torch_models

    return torch_models.grid10_variants(discrete, card)


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


def headroom_grid_variants():
    """The 10x10 grid (phase 3's first model) at the single adaptive
    group's caps, 2 plain slots + 2 collapse variants picked by ``SEED``."""
    from grample_tpu_torch.pgm.encode import compute_caps
    from grample_tpu_torch.sampler.collapse import collapse_var

    m = grid_variants()[0][0]
    caps = compute_caps(m, collapse_headroom=True, slot_hint=128, headroom_factors=2)
    picks = distinct_picks(m, 2, caps.oa_dense_cap)
    return [m, m] + [collapse_var(m, v)[0] for v in picks], caps, picks


def distinct_picks(m, n, oa_cap):
    """``n`` distinct random collapsible vars of ``m``, drawn from ``SEED``."""
    from grample_tpu_torch.sampler.collapse import pick_random_collapsible

    rng = np.random.default_rng(SEED)
    picks = []
    while len(picks) < n:
        v = pick_random_collapsible(m, rng, oa_cap=oa_cap)
        if v not in picks:
            picks.append(v)
    return picks


def aux_variants():
    """8 collapse variants of the Promedus-shaped net picked by ``SEED``, at
    the split group's ``aux_caps``."""
    from grample_tpu_torch.pgm import discrete
    from grample_tpu_torch.pgm.encode import COLLAPSE_OA_DENSE_CAP
    from grample_tpu_torch.sampler.collapse import collapse_var
    from grample_tpu_torch.sampler.split import aux_caps
    from tests import torch_models

    m, evidence = torch_models.promedus_like(discrete, seed=1)
    m.apply_evidence(evidence)
    picks = distinct_picks(m, WIDE_SLOTS, COLLAPSE_OA_DENSE_CAP)
    return [collapse_var(m, v)[0] for v in picks], aux_caps(m), picks


#: (label, counted, site-parallel) of every form the kernel has: the
#: wrapper's own pick, then thread per chain and site-parallel by name
KERNEL_FORMS = (
    ("rule", True, None), ("rule, uncounted", False, None),
    ("thread per chain", True, False), ("thread per chain, uncounted", False, False),
    ("site-parallel", True, True), ("site-parallel, uncounted", False, True))


def form_plan(torch, kst, chains, count, sites):
    """The launch plan of the named kernel form (``sites`` True or False),
    or None for the wrapper's own pick."""
    from grample_tpu_torch.ops import gibbs_cuda

    if sites is None:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return gibbs_cuda.plan_launch(kst, chains, count, sms, sites)


def plain_window(kst):
    """The plain version of the kernel form ``kst`` takes, with the
    kernel's call signature (state, seed, sweeps, half, count, cb):
    ``window_plain``, or ``window_ops`` where the encoding has a gather
    bank."""
    from grample_tpu_torch.ops import gibbs_cuda
    from grample_tpu_torch.ops.gibbs_bank import window_ops
    from grample_tpu_torch.ops.gibbs_torch import window_plain
    from grample_tpu_torch.ops.sweep import KERNEL_KEYS

    if gibbs_cuda.uses_gather(kst):
        return lambda *a: window_ops(kst, *a)
    return lambda *a: window_plain(*[kst[k] for k in KERNEL_KEYS], *a)


def compare_window(torch, kst, state0, free_rows, n_free, nslot, chains, cb, label,
                   seed=SEED, forms=None):
    """One sweep through every form of the kernel (or ``forms`` of
    ``KERNEL_FORMS``) and through the plain version (``plain_window``)
    from the same state and ``seed``; returns {form label: largest state
    difference}."""
    from grample_tpu_torch.ops import gibbs_cuda

    plain = plain_window(kst)
    free = free_rows.bool()
    errs = {}
    plain_out = {}
    for form, count, by_site in forms or KERNEL_FORMS:
        if count not in plain_out:
            plain_out[count] = plain(state0.clone(), seed, 1, 0, count, cb)
        sp, cp = plain_out[count]
        sk, ck = gibbs_cuda.gibbs_window(kst, state0.clone(), seed, 1, 0, count, cb,
                                         form_plan(torch, kst, chains, count, by_site))
        torch.cuda.synchronize()
        diff = (sk[:, :nslot] != sp[:, :nslot]) & free[:, :, None]
        frac = diff.sum().item() / (free.sum().item() * chains)
        errs[form] = int((sk - sp).abs().max().item())
        check(frac <= MAX_MISMATCH, f"{label}, {form}: {frac:.2e} of free sites differ")
        check(torch.equal(sk[:, nslot:], state0[:, nslot:]),
              f"{label}, {form}: kernel wrote a tail (evidence/sentinel) row")
        check(torch.equal(sp[:, nslot:], state0[:, nslot:]),
              f"{label}: plain version wrote a tail (evidence/sentinel) row")
        if count:
            want = chains * n_free  # one sweep: every free site of every chain
            for name, cn in (("kernel", ck), ("plain", cp)):
                per_row = cn.sum(dim=(1, 2, 4))  # [N, NSLOT]
                got = int((per_row * free).sum().item())
                check(got == want, f"{label}, {form}: {name} count total {got} != {want}")
                check(int((per_row * ~free).sum().item()) == 0,
                      f"{label}, {form}: {name} counted a row that is not free")
            agree = (sk[:, :nslot] == sp[:, :nslot]).all(dim=0)[None] & free[:, :, None]
            differ = (ck != cp).any(dim=1).any(dim=1)  # [N, NSLOT, C]
            check(not bool((differ & agree).any().item()),
                  f"{label}, {form}: counts differ on free rows where states agree")
        print(f"{label}: kernel ({form}) vs plain: {frac:.3e} of free sites differ "
              f"(bound {MAX_MISMATCH}), tail rows intact", flush=True)
    return errs


def reshaped(kst, plan, threads, stage_lists, stage_tables):
    """``plan`` (thread per chain) at another block width and staging, or
    None where that does not fit a block's shared memory."""
    from grample_tpu_torch.ops import gibbs_cuda

    sbytes = gibbs_cuda.state_bytes(kst["c_rows"].shape[1], kst["k_kmask"].shape[3], threads)
    plan = dataclasses.replace(plan, threads=threads, state_bytes=sbytes,
                               stage_lists=stage_lists, stage_tables=stage_tables)
    return plan if plan.smem <= gibbs_cuda.MAX_SMEM_BYTES else None


def describe_launch(torch, kst, chains, count, label, sites=None, plan=None):
    """Print the live work of ``kst`` per variant and the launch shape the
    wrapper gives ``chains`` chains of it (or ``plan``); returns the plan."""
    from grample_tpu_torch.ops import gibbs_cuda
    from grample_tpu_torch.ops.layout import compact_counts, walk_counts

    live = compact_counts(kst["c_lists"].cpu().numpy())
    walk = walk_counts(kst["c_lists"].cpu().numpy())
    n, nc, g, k = kst["k_kmask"].shape
    f, s = kst["k_scope"].shape[3:]
    fg = kst["gb_offset"].shape[3]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = plan or gibbs_cuda.plan_launch(kst, chains, count, sms, sites)
    occ = gibbs_cuda.occupancy(k, plan)
    per = lambda col: f"{live[:, col].min()}-{live[:, col].max()}"  # noqa: E731
    wper = lambda col: f"{walk[:, col].min()}-{walk[:, col].max()}"  # noqa: E731
    bank = (f", live gather incidences {per(5)} of {nc * g * fg}, live gather scope entries "
            f"{per(6)} of {nc * g * fg * s} (flat table {kst['tables'][0].numel() * 4} bytes)"
            if fg else "")
    print(f"launch, {label}: per variant live rows {per(0)} of {nc * g} slots, state rows "
          f"kept {per(1)} of {kst['pal_oon'].shape[1]}, live incidences {per(2)} of "
          f"{nc * g * f}, live scope entries {per(3)} of {nc * g * f * s}{bank}; walked "
          f"incidences {wper(0)}, scope entries {wper(1)}, sites on merged tables {wper(3)}; "
          f"compact tables {walk[:, 2].min() * 4}-{walk[:, 2].max() * 4} bytes (unmerged "
          f"{live[:, 4].min() * 4}-{live[:, 4].max() * 4}, dense "
          f"{kst['k_tables'][0].numel() * 4}); {gibbs_cuda.form_name(plan)}, "
          f"{plan.threads} threads "
          f"per block, {n * -(-chains // (plan.threads // 32 if plan.sites else plan.threads))} "
          f"blocks, {occ['blocks_per_sm']} resident per SM, "
          f"{occ['registers']} registers, {occ['local_bytes']} bytes of local memory "
          f"(spills); shared memory per block {plan.smem} bytes: lists "
          f"{plan.list_bytes} ({'staged' if plan.stage_lists else 'in device memory'}), "
          f"tables {plan.table_bytes} ({'staged' if plan.stage_tables else 'in device memory'}), "
          f"state {plan.state_bytes}", flush=True)
    return plan


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


def run_cli(cli, argv):
    """``cli.main(argv)`` with its standard output captured: (rc, log)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def summary(trace_path):
    """The RESULT SUMMARY record of an engine trace."""
    text = open(trace_path).read().split("// RESULT SUMMARY\n")[1]
    return json.loads(text.splitlines()[0])


def adapt_secs(log):
    """Host seconds of each adapt step, from the engine's ADAPT lines."""
    return [float(ln.rsplit(" in ", 1)[1].split()[0])
            for ln in log.splitlines() if ln.startswith("ADAPT: ")]


def cpu_name() -> str:
    """The host CPU's model, from ``/proc/cpuinfo`` or ``lscpu``."""
    with open("/proc/cpuinfo") as fh:
        for ln in fh:
            if ln.lower().startswith("model name"):
                return ln.split(":", 1)[1].strip()
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    except OSError:
        out = ""
    for ln in out.splitlines():
        if ln.startswith(("Model name", "Vendor ID")):
            return ln.split(":", 1)[1].strip()
    return f"{platform.machine()} CPU, model not reported"


def visible_cards(torch):
    """The ``CUDA_VISIBLE_DEVICES`` entry of each card this process sees:
    what a rank process is given to see that card alone."""
    vis = [x.strip() for x in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
           if x.strip()]
    return vis[:torch.cuda.device_count()] or [str(i) for i in range(torch.cuda.device_count())]


def run_ranks(argv, label, cards, timeout=RANK_TIMEOUT):
    """``sample ... argv`` as one rank process of one world per entry of
    ``cards``, rank i seeing card ``cards[i]`` alone (``RANK_CHILD``);
    returns each rank's output and its record line.  A rank that fails or
    outlives ``timeout`` fails the script, and no rank outlives this
    call."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CHILD, *argv], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(len(cards)), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES=card))
        for r, card in enumerate(cards)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    records = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{label}: rank {r} exited {p.returncode}:\n{out[-4000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("rank {")]
        check(len(line) == 1, f"{label}: rank {r} printed no launch record")
        records.append(json.loads(line[0][len("rank "):]))
        print(f"{label.split()[0]} {line[0]}", flush=True)
    return outs, records


def collective_ms(records):
    """Each rank's collectives from its record line: calls, mean and
    least host ms of a call."""
    return "; ".join(
        f"rank {rec['rank']}: " + ", ".join(
            f"{who} {n} calls, {ms / n:.3f} ms a call (least {least:.3f})"
            for who, (n, ms, least) in sorted(rec["collectives"].items()))
        for rec in records)


def card_lines() -> list:
    """Every card's name and power limit, one ``nvidia-smi`` line each."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def adapt_picks(log):
    """Each ADAPT line of a log without its host seconds."""
    return [ln.split(" in ")[0] for ln in log.splitlines() if ln.startswith("ADAPT: ")]


def kernel_order(torch, kst, state):
    """Chain state [N, C, V+1] in the kernel's row order [N, NVp, C], as
    ``ops.sweep.advance_chains`` hands it to the kernel."""
    n, c, _ = state.shape
    oon = kst["pal_oon"].long()
    return torch.gather(state, 2, oon[:, None, :].expand(n, c, oon.shape[1])) \
        .transpose(1, 2).contiguous()


def cards_window(torch, group, sweeps):
    """One counted window of ``group`` (any mesh): CUDA events on every
    card it launches on and a host clock around the whole window, which
    ends in a synchronize on every card.  Returns (wall ms, {device: ms})."""
    devs = group.mesh.local_devices()
    for d in devs:
        torch.cuda.synchronize(d)
    ev = {d: (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for d in devs}
    t0 = time.perf_counter()
    for d in devs:
        ev[d][0].record(torch.cuda.current_stream(d))
    group.advance(sweeps, defer=True)
    for d in devs:
        ev[d][1].record(torch.cuda.current_stream(d))
    for d in devs:
        torch.cuda.synchronize(d)
    wall = (time.perf_counter() - t0) * 1e3
    group.flush()
    return wall, {str(d): ev[d][0].elapsed_time(ev[d][1]) for d in devs}


def busy_by_card(torch, prof):
    """{card index: ms} of device activity in a ``torch.profiler`` trace
    (kernels and copies), or {} where the profiler gave no device time."""
    busy = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.device_index] = busy.get(e.device_index, 0.0) + e.time_range.elapsed_us() / 1e3
    return busy


def mesh_on_cards(ctx):
    """Phase 8, the chain mesh on N real cards (N = 2, or 4 where the
    machine has four or more); see the module doc."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from grample_tpu_torch import cli
    from grample_tpu_torch.metrics import error_suite
    from grample_tpu_torch.metrics.divergences import pad_marginals
    from grample_tpu_torch.ops import gibbs_cuda
    from grample_tpu_torch.parallel.mesh import ShardedChainGroup, chain_mesh
    from grample_tpu_torch.pgm import discrete
    from grample_tpu_torch.pgm.encode import compute_caps
    from grample_tpu_torch.pgm.exact import exact_marginals
    from grample_tpu_torch.sampler.chains import ChainGroup
    from grample_tpu_torch.sampler.checkpoint import load_checkpoint, save_checkpoint
    from grample_tpu_torch.uai import read_mar_file
    from tests import torch_models

    n = 4 if torch.cuda.device_count() >= 4 else 2
    cards = ctx.card_lines[:n]
    card = "; ".join(f"cuda:{i} {c}" for i, c in enumerate(cards))
    dev = ctx.dev
    t8 = time.perf_counter()
    counts = ctx.counts

    def same_as(group, plain_group, what):
        """Every shard of ``group`` equals its block of ``plain_group``
        (on the host: the shards live on other cards), and so do the
        totals."""
        nl, cl = group.local_slots, group.local_chains
        pst, phv = plain_group.state.cpu(), plain_group.halves.cpu()
        for sh in group.shards:
            rows, cols = slice(sh.v0, sh.v0 + nl), slice(sh.c0, sh.c0 + cl)
            check(torch.equal(sh.state.cpu(), pst[rows, cols]),
                  f"8, {what}: shard ({sh.vi}, {sh.ci}) on {sh.device} state differs")
            check(torch.equal(sh.halves.cpu(), phv[rows, :, cols]),
                  f"8, {what}: shard ({sh.vi}, {sh.ci}) on {sh.device} halves differ")
        check(np.array_equal(group.totals[: plain_group.slot_cap], plain_group.totals),
              f"8, {what}: totals differ")

    def on_own_cards(group, what):
        """Each shard's tensors, and its row's sweep tensors, on its own
        card, and N distinct cards in all."""
        for sh in group.shards:
            check(sh.state.device == sh.device == sh.halves.device
                  and group.mesh.devices[sh.vi][sh.ci] == sh.device,
                  f"8, {what}: shard ({sh.vi}, {sh.ci}) tensors on {sh.state.device}, "
                  f"{sh.halves.device}, not {sh.device}")
            row = group.kstack[sh.vi].tensors[sh.device]
            check(all(t.device == sh.device for t in row.values()),
                  f"8, {what}: a sweep tensor of row {sh.vi} is not on {sh.device}")
        names = sorted(str(sh.device) for sh in group.shards)
        check(names == [f"cuda:{i}" for i in range(group.mesh.size)],
              f"8, {what}: shards on {names}")

    # ---- 8a. sharded equals unsharded, on real cards ------------------------
    models, caps = grid_variants()
    cpv = n * GRID_CHAINS
    t0 = time.perf_counter()
    sharded = ShardedChainGroup(models[0], cpv, 20, seed=SEED, caps=caps, mesh=chain_mesh())
    unsharded = ChainGroup(models[0], cpv, 20, dev, seed=SEED, caps=caps)
    unsharded.cb = sharded.cb
    counts.reset()
    for g in (sharded, unsharded):
        if g is sharded:
            gibbs_cuda.gibbs_window.launches_by_device = {}
        g.add_variants(models)
        g.burn(10)
        g.advance(defer=True)
        g.advance(defer=True)
        g.flush()
        if g is sharded:
            by_card = dict(gibbs_cuda.gibbs_window.launches_by_device)
            counts.read("8a")
    on_own_cards(sharded, "8a")
    check(sorted(by_card) == [f"cuda:{i}" for i in range(n)] and min(by_card.values()) > 0,
          f"8a: kernel launches by card {by_card}")
    same_as(sharded, unsharded, "8a, a burn and two counted windows")
    merged = sharded.merged_marginals()
    check(np.allclose(sharded.convergence(merged=merged), unsharded.convergence(merged=merged),
                      rtol=1e-5), "8a: PSRF of the shards' moments differs from one card's")
    print(f"8a ({card}): the 10x10 grid, 2 x {cpv} chains, a {sharded.mesh.shape} mesh of "
          f"chain_mesh() (shards on {[str(sh.device) for sh in sharded.shards]}) beside one "
          f"card's ChainGroup: state, halves and totals equal bit for bit after a burn and two "
          f"counted windows, PSRF within 1e-5; kernel launches by card {by_card} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del sharded, unsharded

    # ---- 8b. scaling of one window ------------------------------------------
    def timed_group(n_cards, chains_per_variant):
        g = ShardedChainGroup(models[0], chains_per_variant, TIMED_SWEEPS, seed=SEED,
                              caps=caps, mesh=chain_mesh(n_devices=n_cards))
        g.add_variants(models)
        g.warmup()
        cards_window(torch, g, TIMED_SWEEPS)  # warm
        runs = [cards_window(torch, g, TIMED_SWEEPS) for _ in range(SCALE_REPS)]
        wall, per = min(runs, key=lambda r: r[0])
        del g
        return wall, per

    counts_8b = sorted({1, 2, n})
    scaling = {}
    counts.reset()
    for kind, per_variant in (("weak", lambda k: k * SCALE_CHAINS // 2),
                              ("strong", lambda k: GRID_CHAINS)):
        for k in counts_8b:
            wall, per = timed_group(k, per_variant(k))
            scaling[kind, k] = wall
            t1 = scaling[kind, 1]
            eff = t1 / wall if kind == "weak" else t1 / (k * wall)
            extra = (f", scaled speed-up N*t1/tN {k * t1 / wall:.3f}" if kind == "weak"
                     else f", speed-up {t1 / wall:.3f}")
            print(f"8b ({card}): {kind} scaling, 2 x {per_variant(k)} chains on {k} card(s) "
                  f"({chain_mesh(n_devices=k).shape}), one {TIMED_SWEEPS}-sweep counted window, "
                  f"best wall of {SCALE_REPS}: {wall:.3f} ms; per card "
                  + ", ".join(f"{d} {ms:.3f} ms" for d, ms in per.items())
                  + f"; efficiency {eff:.3f}{extra}", flush=True)
    counts.read("8b")

    with tempfile.TemporaryDirectory() as td:
        # ---- 8c. the CLI on every card ---------------------------------------
        model = grid_model(4, 7)
        evidence = {5: 1, 10: 0}
        model_ev = grid_model(4, 7)
        model_ev.apply_evidence(evidence)
        truth = exact_marginals(model_ev)
        path = write_net(td, "grid4", model, evidence, truth)
        v = model.num_vars
        grid_shape = chain_mesh(n_devices=n).shape
        mesh_arg = "auto" if torch.cuda.device_count() == n else \
            f"{grid_shape['variants']}x{grid_shape['chains']}"
        mesh_line = (f"device mesh: {grid_shape} over {n} devices; this process: "
                     + ", ".join(f"cuda:{i}" for i in range(n)))
        mar_out = os.path.join(td, "8c.MAR")
        counts.reset()
        gibbs_cuda.gibbs_window.launches_by_device = {}
        t0 = time.perf_counter()
        rc, log = run_cli(cli, [
            "sample", "-m", path, "-d", "-o", "-s", "simple", "--mesh", mesh_arg,
            "--vchains", str(GRID_CHAINS), "-b", str(200 * v), "-w", str(100 * v),
            "-i", str(4 * 100 * 2 * GRID_CHAINS * (v - len(evidence))),
            "-x", "60", "-e", str(SEED), "--mar-out", mar_out])
        secs = time.perf_counter() - t0
        by_card = dict(gibbs_cuda.gibbs_window.launches_by_device)
        counts.read("8c")
        check(rc == 0 and mesh_line in log.splitlines(), f"8c: rc {rc}, mesh line "
              f"{[ln for ln in log.splitlines() if ln.startswith('device mesh')]}")
        check(len(by_card) == n and min(by_card.values()) > 0, f"8c: launches by card {by_card}")
        est = pad_marginals(read_mar_file(mar_out), model_ev.cards)
        score = error_suite(est, truth, model_ev.cards, model_ev.fixed, None)
        check(np.isfinite(est).all() and score.max_hellinger < HELL_BOUND,
              f"8c: max Hellinger {score.max_hellinger:.5f} >= {HELL_BOUND}")
        print(f"8c ({card}): cli sample -s simple --mesh {mesh_arg} on the 4x4 grid, 2 x "
              f"{GRID_CHAINS} chains: {mesh_line!r}; {secs:.1f} s, launches by card {by_card}, "
              f"max Hellinger {score.max_hellinger:.6f} (bound {HELL_BOUND})", flush=True)
        argv_one = ["sample", "-m", path, "-d", "-s", "simple", "--vchains", str(GRID_CHAINS),
                    "-b", str(200 * v), "-w", str(100 * v), "-i", "1", "-e", str(SEED)]
        mar_mesh, mar_one = os.path.join(td, "8c_mesh.MAR"), os.path.join(td, "8c_one.MAR")
        counts.reset()
        rc_m, _ = run_cli(cli, argv_one + ["--mesh", mesh_arg, "--mar-out", mar_mesh])
        counts.read("8c -i 1")
        rc_o, _ = run_cli(cli, argv_one + ["--mesh", "off", "--mar-out", mar_one])
        with open(mar_mesh) as fh_m, open(mar_one) as fh_o:
            mar_one_text = fh_o.read()
            check(rc_m == rc_o == 0 and fh_m.read() == mar_one_text,
                  "8c: the -i 1 MAR on the mesh differs from one card's")
        print(f"8c ({card}): the same stopped by -i 1 after its first window: the MAR on "
              f"{n} cards equals the one-card --mesh off run's byte for byte", flush=True)

        # ---- 8d. the adaptive engine on real cards (A11c) --------------------
        hmodel, hevidence = torch_models.promedus_like(discrete, seed=1)
        hmodel_ev, _ = torch_models.promedus_like(discrete, seed=1)
        hmodel_ev.apply_evidence(hevidence)
        hv = hmodel.num_vars
        head_caps = compute_caps(hmodel_ev, collapse_headroom=True, slot_hint=128,
                                 headroom_factors=2)
        hpath = write_net(td, "promedus", hmodel, hevidence)
        hmesh = f"{grid_shape['variants']}x{grid_shape['chains']}"
        mar_h, trace_h = os.path.join(td, "8d.MAR"), os.path.join(td, "8d.t")
        rows_by_tick = []  # active slots of each grid row, and the slot capacity

        def rb_accumulate(self):  # once a tick
            rows_by_tick.append(([min(max(self.num_variants - vi * self.local_slots, 0),
                                      self.local_slots)
                                  for vi in range(self.mesh.shape["variants"])], self.slot_cap))
            return ChainGroup.rb_accumulate(self)

        ShardedChainGroup.rb_accumulate = rb_accumulate
        counts.reset()
        gibbs_cuda.gibbs_window.launches_by_device = {}
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rc, log = run_cli(cli, [
                "sample", "-m", hpath, "-d", "-s", "adaptive", "-c", "2", "--vchains",
                str(HEAD_CHAINS), "-a", "4", "-b", str(10 * hv), "-w", str(5 * hv), "-x",
                str(HEAD_SECS), "-e", str(SEED), "--mesh", hmesh, "-t", trace_h,
                "--mar-out", mar_h])
        secs = time.perf_counter() - t0
        del ShardedChainGroup.rb_accumulate
        by_card = dict(gibbs_cuda.gibbs_window.launches_by_device)
        counts.read("8d")
        check(rc == 0, f"8d: cli returned {rc}")
        out = summary(trace_h)
        busy = busy_by_card(torch, prof)
        del prof
        route_line = [ln for ln in log.splitlines() if ln.startswith("sweep route:")]
        steps = adapt_secs(log)
        check(len(route_line) == 1 and route_line[0].startswith(
            f"sweep route: kernel, gather form (gfac_cap={head_caps.gfac_cap})"),
            f"8d: route line {route_line}")
        check(len(steps) >= 1 and out["kernel"], f"8d: {len(steps)} adapt steps, kernel "
              f"{out['kernel']}")
        marg = pad_marginals(read_mar_file(mar_h), hmodel.cards)
        h_score = error_suite(marg, ctx.simple_marginals, hmodel_ev.cards, hmodel_ev.fixed, None)
        check(np.isfinite(marg).all() and h_score.max_hellinger < HEAD_HELL_BOUND,
              f"8d: max Hellinger {h_score.max_hellinger:.5f} against -s simple >= "
              f"{HEAD_HELL_BOUND}")
        idle = sum(min(rows) == 0 for rows, _ in rows_by_tick)
        busy_text = ("busy ms over the sampling clock by card: " + ", ".join(
            f"cuda:{i} {ms:.1f} ({ms / 1e3 / out['runtime']:.3f})" for i, ms in sorted(busy.items()))
            if busy else "busy: not measured (the profiler gave no device time)")
        print(f"8d ({card}): sample -s adaptive -c 2 --vchains {HEAD_CHAINS} -a 4 -x {HEAD_SECS} "
              f"--mesh {hmesh} on the Promedus-shaped net at all-gather headroom caps: "
              f"{route_line[0]!r}; {secs:.1f} s wall, {len(steps)} adapt steps "
              f"({sum(steps):.3f} s of host time), {len(out['collapsed'])} collapsed vars, "
              f"{out['variants']} variants, {out['samples_per_sec']:.4e} counted "
              f"site-samples/s under the profiler (4h's 2x2 virtual mesh: "
              f"{ctx.rate_4h_mesh if ctx.rate_4h_mesh is None else f'{ctx.rate_4h_mesh:.4e}'}); "
              f"windows launched by card {by_card}; {busy_text}; ticks with a grid row holding "
              f"no active slot {idle} of {len(rows_by_tick)} (active slots by row, and the "
              f"slot capacity, by tick {rows_by_tick}); max Hellinger against the -s simple run "
              f"{h_score.max_hellinger:.6f} (bound {HEAD_HELL_BOUND})", flush=True)

        # ---- 8e. ranks, one card each ----------------------------------------
        vis = visible_cards(torch)[:n]
        mar_ranks = os.path.join(td, "8e.MAR")
        t0 = time.perf_counter()
        outs, records = run_ranks(argv_one + ["--distributed", "--mesh", "auto",
                                              "--mar-out", mar_ranks], "8e (a)", vis,
                                  MESH_RANK_TIMEOUT)
        secs_a = time.perf_counter() - t0
        counts.add_ranks("8e", records)
        rank_line = f"device mesh: {grid_shape} over {n} devices of {n} ranks; this process: cuda:0"
        check(rank_line in outs[0].splitlines(), f"8e (a): no world mesh line {rank_line!r}")
        with open(mar_ranks) as fh:
            check(fh.read() == mar_one_text, "8e (a): rank 0's MAR differs from 8c's one card's")
        print(f"8e (a) ({card}): sample -s simple -i 1 on the 4x4 grid over {n} rank processes, "
              f"rank i seeing card i (CUDA_VISIBLE_DEVICES={vis}): rank 0's MAR equals 8c's "
              f"one-card run byte for byte; {secs_a:.1f} s wall with process start; launches "
              f"{[rec['launches'] for rec in records]}; collectives "
              f"{collective_ms(records)}", flush=True)
        mar_b, trace_b = os.path.join(td, "8e.MAR"), os.path.join(td, "8e.t")
        t0 = time.perf_counter()
        outs, records = run_ranks([
            "sample", "-m", path, "-d", "-o", "-s", "adaptive", "-c", "2", "--vchains",
            str(GRID_CHAINS), "-a", "2", "-b", str(200 * v), "-w", str(100 * v), "-e", str(SEED),
            "-x", str(RANKS_ADAPT_SECS), "--distributed", "--mesh", "auto", "--mar-out", mar_b,
            "-t", trace_b], "8e (b)", vis, MESH_RANK_TIMEOUT)
        secs_b = time.perf_counter() - t0
        counts.add_ranks("8e", records)
        picks = [adapt_picks(out) for out in outs]
        res_b = summary(trace_b)
        check(picks[0] and all(p == picks[0] for p in picks),
              f"8e (b): the ranks' adapt steps differ: {picks}")
        est = pad_marginals(read_mar_file(mar_b), model_ev.cards)
        b_score = error_suite(est, truth, model_ev.cards, model_ev.fixed, None)
        check(np.isfinite(est).all() and b_score.max_hellinger < HELL_BOUND,
              f"8e (b): max Hellinger {b_score.max_hellinger:.5f} >= {HELL_BOUND}")
        print(f"8e (b) ({card}): sample -s adaptive -c 2 --vchains {GRID_CHAINS} -a 2 -x "
              f"{RANKS_ADAPT_SECS} over a {grid_shape} world mesh of {n} rank processes, one "
              f"card each: {secs_b:.1f} s wall with process start; every rank: {picks[0]}; "
              f"collapsed vars {res_b['collapsed']}, {res_b['variants']} variants; "
              f"{res_b['samples_per_sec']:.4e} counted site-samples/s over {res_b['runtime']:.2f} "
              f"s of sampling clock (4j (b), two ranks on one card: "
              f"{ctx.rate_4j if ctx.rate_4j is None else f'{ctx.rate_4j:.4e}'}); max Hellinger "
              f"{b_score.max_hellinger:.6f} (bound {HELL_BOUND}); launches "
              f"{[rec['launches'] for rec in records]}; collectives {collective_ms(records)}",
              flush=True)

        # ---- 8f. checkpoints across cards ------------------------------------
        ck_cpv = n * CKPT_CHAINS
        counts.reset()
        g = ShardedChainGroup(models[0], ck_cpv, 20, seed=SEED, caps=caps, mesh=chain_mesh())
        p = ChainGroup(models[0], ck_cpv, 20, dev, seed=SEED, caps=caps)
        p.cb = g.cb
        for x in (g, p):
            x.add_variants(models)
            x.burn(10)
            x.advance()
        ck = os.path.join(td, "8f.npz")
        t0 = time.perf_counter()
        save_checkpoint(ck, g)
        save_secs = time.perf_counter() - t0
        one, _ = load_checkpoint(ck, models[0], device=dev)
        row, _ = load_checkpoint(ck, models[0], device=dev, make_group=lambda m, **kw:
                                 ShardedChainGroup(m, mesh=chain_mesh(n_devices=n, variant_ways=1),
                                                   caps=caps, **kw))
        check(not isinstance(one, ShardedChainGroup) and one.cb == g.cb
              and row.mesh.shape == {"variants": 1, "chains": n} and row.cb == g.cb,
              f"8f: resumed as {type(one).__name__} cb {one.cb}, {row.mesh.shape} cb {row.cb}")
        on_own_cards(row, "8f")
        for x in (g, p, one, row):
            x.advance()
        same_as(g, p, "8f, the group that was never saved")
        same_as(row, p, f"8f, saved on {g.mesh.shape}, resumed on 1x{n}, advanced")
        check(torch.equal(one.state, p.state) and torch.equal(one.halves, p.halves)
              and np.array_equal(one.totals, p.totals),
              f"8f: saved on {g.mesh.shape}, resumed on one card: differs")
        counts.read("8f")
        print(f"8f ({card}): 2 x {ck_cpv} chains saved on the {g.mesh.shape} mesh "
              f"({save_secs:.3f} s), resumed on one card and on a 1x{n} mesh, advanced: both "
              f"equal to the group that was never saved", flush=True)
        del g, p, one, row

        # ---- 8g. the scaling tool --------------------------------------------
        write_net(td, "grid10", grid_model(10, 1), {0: 1, 55: 0, 99: 1})
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "grample_tpu_torch.tools.scaling", "--res", td, "--net",
             "grid10", "--counts", ",".join(map(str, counts_8b)), "--cpv", str(GRID_CHAINS)],
            cwd=REPO, capture_output=True, text=True, timeout=MESH_RANK_TIMEOUT)
        rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        check(proc.returncode == 0 and len(rows) == len(counts_8b)
              and all(not r.get("virtual", True) and "error" not in r for r in rows),
              f"8g: the scaling tool exited {proc.returncode}: {proc.stdout[-3000:]}"
              f"{proc.stderr[-3000:]}")
        r1 = rows[0]
        for r in rows:
            print(f"8g ({card}): tools.scaling row {json.dumps(r)}; weak efficiency of the "
                  f"samples/s {r['samples_per_sec'] / (r['devices'] * r1['samples_per_sec']):.3f}",
                  flush=True)
        print(f"8g: {time.perf_counter() - t0:.1f} s with process start", flush=True)
    print(f"8 ({card}): phase 8 {time.perf_counter() - t8:.1f} s", flush=True)


def main() -> int:
    import torch

    only8 = sys.argv[1:] == ["--phase", "8"]
    if sys.argv[1:] and not only8:
        print("usage: chip_smoke.py [--phase 8]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from grample_tpu_torch import cli
    from grample_tpu_torch.metrics import error_suite
    from grample_tpu_torch.metrics.divergences import pad_marginals
    from grample_tpu_torch.ops import _build, gibbs_cuda
    from grample_tpu_torch.ops.bound import card_line, window_bound
    from grample_tpu_torch.ops.gibbs_bank import chain_block, window_ops
    from grample_tpu_torch.ops.gibbs_torch import window_plain
    from grample_tpu_torch.ops.sweep import (
        KERNEL_KEYS,
        advance_chains,
        hash_block,
        kernel_refusal,
        sweep_tensors,
    )
    from grample_tpu_torch.pgm import discrete
    from grample_tpu_torch.pgm.encode import (
        COLLAPSE_OA_DENSE_CAP,
        caps_for_variants,
        compute_caps,
        encode_model,
        stack_variants,
    )
    from grample_tpu_torch.parallel.mesh import ShardedChainGroup, chain_mesh, shard_seed
    from grample_tpu_torch.pgm.exact import exact_marginals
    from grample_tpu_torch.sampler.chains import ChainGroup, window_seed
    from grample_tpu_torch.sampler.checkpoint import load_checkpoint, read_meta, save_checkpoint
    from grample_tpu_torch.sampler.collapse import (
        collapse_var,
        is_collapsible,
        pick_random_collapsible,
    )
    from grample_tpu_torch.sampler.engine import Engine, EngineConfig
    from grample_tpu_torch.sampler.split import AUX_CHAINS, PAL_AUX_OA_LIM, wide_aux_spec
    from grample_tpu_torch.uai import read_mar_file
    from tests import torch_models

    # the wide aux spec's disk cache lives under HOME: this run's own
    # directory, removed when the run ends
    home = tempfile.TemporaryDirectory()
    os.environ["HOME"] = home.name
    dev = torch.device("cuda:0")
    path_launches = {}  # phase -> kernel launches by form on that path
    ops_windows = {}  # phase -> windows of the torch-ops route, by form

    def reset_counts():
        gibbs_cuda.gibbs_window.launches = 0
        gibbs_cuda.gibbs_window.launches_by_form = {}
        gibbs_cuda.gibbs_window.launches_by_device = {}
        window_ops.launches = 0
        window_ops.launches_by_form = {}

    def read_counts(phase):
        path_launches[phase] = dict(gibbs_cuda.gibbs_window.launches_by_form)
        ops_windows[phase] = dict(window_ops.launches_by_form)
        return gibbs_cuda.gibbs_window.launches

    def add_rank_launches(phase, records):
        by_form = path_launches.setdefault(phase, {})
        ops_windows.setdefault(phase, {})
        for rec in records:
            for form, k in rec["launches"].items():
                by_form[form] = by_form.get(form, 0) + k

    ctx = types.SimpleNamespace(  # what phase 8 reads of the phases before it
        dev=dev, card_lines=card_lines(), simple_marginals=None, rate_4h_mesh=None,
        rate_4j=None,
        counts=types.SimpleNamespace(reset=reset_counts, read=read_counts,
                                     add_ranks=add_rank_launches))

    # ---- 1. the card -----------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    gibbs_cuda._lib()
    print(f"build ({card}): {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(_build.library_path())}", flush=True)
    with open(_build.library_path() + ".log") as fh:
        ptxas = [ln.strip() for ln in fh if "Compiling" in ln or "registers" in ln
                 or "spill" in ln]
    for entry, spills, regs in zip(ptxas[0::3], ptxas[1::3], ptxas[2::3]):
        name, kmax, form, gather = re.search(
            r"(gibbs_window(?:_sites)?_kernel)IL\w(\d+)EL\w(\d+)EL\w(\d+)E", entry).groups()
        print(f"ptxas, {name}<{kmax}, {form}, {gather}> (card bound, counts form, gather "
              f"form): {regs.split(': ')[1]}; {spills}", flush=True)
    clock_hz = max_sm_clock_hz()
    if only8:  # phase 8 alone, against its own -s simple run of 5b
        if torch.cuda.device_count() < 2:
            print("8: not run: 1 card", flush=True)
            return 0
        with tempfile.TemporaryDirectory() as td:
            m_plain, p_evidence = torch_models.promedus_like(discrete, seed=1)
            v = m_plain.num_vars
            ctx.simple_marginals = Engine(EngineConfig(
                model_path=write_net(td, "promedus", m_plain, p_evidence), device="cuda",
                use_evidence=True, sampler="simple", chains=2, chains_per_variant=8192,
                burnin=50 * v, converge_window=100 * v, max_secs=float(ADAPT_SECS), seed=SEED),
                log=lambda s: None).run().marginals
        mesh_on_cards(ctx)
        print("phase 8 alone: no result line", flush=True)
        return 0

    # ---- 3. kernel against the plain version --------------------------------
    models, caps = grid_variants()
    kst, state0, free_rows, n_free = window_inputs(torch, dev, models, caps, GRID_CHAINS)
    cb = hash_block(GRID_CHAINS)
    grid_errs = compare_window(torch, kst, state0, free_rows, n_free, caps.num_slots,
                               GRID_CHAINS, cb, "10x10 grid")

    # ---- 3b. the wide-table form against the plain version -------------------
    t0 = time.perf_counter()
    wvariants, wcaps, promedus = promedus_variants(True)
    wkst, wstate0, wfree, wn_free = window_inputs(torch, dev, wvariants, wcaps, WIDE_CHAINS)
    check(32 < wcaps.oa_cap <= 256, f"collapse variants' oa_cap {wcaps.oa_cap} not in (32, 256]")
    collapsed = [int(np.nonzero(v.collapsed)[0][0]) for v in wvariants]
    print(f"Promedus-shaped net ({card}): {promedus.num_vars} vars, "
          f"{int((promedus.fixed >= 0).sum())} evidence, collapse variants of vars "
          f"{collapsed}: oa_cap {wcaps.oa_cap}, scope_cap {wcaps.scope_cap}, "
          f"adj_cap {wcaps.adj_cap}, NVp {wcaps.num_rows} (host set-up "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    wide_err = max(compare_window(
        torch, wkst, wstate0, wfree, wn_free, wcaps.num_slots, WIDE_CHAINS,
        hash_block(WIDE_CHAINS), f"{WIDE_SLOTS} collapse variants").values())

    # ---- 3e. the kernel's gather form, the torch-ops route, the dense kernel ----
    gcaps = dataclasses.replace(wcaps, base_mode="gather", adj_cap=0, oa_cap=1,
                                gfac_cap=wcaps.adj_cap + wcaps.gfac_cap)
    check(kernel_refusal(gcaps) is None, f"3e: the gate refused all-gather caps: "
          f"{kernel_refusal(gcaps)}")
    gkst = sweep_tensors(stack_variants([encode_model(v, gcaps) for v in wvariants]), dev)
    check(gibbs_cuda.uses_gather(gkst) and torch.equal(gkst["pal_oon"], wkst["pal_oon"])
          and torch.equal(gkst["k_kmask"], wkst["k_kmask"]),
          "3e: the dense and the all-gather encoding differ in kernel order")
    wcb, wslot, wlive = hash_block(WIDE_CHAINS), wcaps.num_slots, wfree.bool()
    gather_errs = compare_window(torch, gkst, wstate0, wfree, wn_free, wslot, WIDE_CHAINS, wcb,
                                 f"3e, {WIDE_SLOTS} collapse variants all-gather, gather form")
    sk, ck = gibbs_cuda.gibbs_window(wkst, wstate0.clone(), SEED, 1, 0, True, wcb)
    sg, cg = gibbs_cuda.gibbs_window(gkst, wstate0.clone(), SEED, 1, 0, True, wcb)
    so, co = window_ops(gkst, wstate0.clone(), SEED, 1, 0, True, wcb)
    torch.cuda.synchronize()
    for what, out in (("the dense kernel", (sk, ck)), ("the gather form", (sg, cg)),
                      ("the ops route", (so, co))):
        check(torch.equal(out[0][:, wslot:], wstate0[:, wslot:]), f"3e: {what} wrote a tail row")
        per_row = out[1].sum(dim=(1, 2, 4))
        check(int((per_row * wlive).sum().item()) == WIDE_CHAINS * wn_free
              and int((per_row * ~wlive).sum().item()) == 0, f"3e: {what}'s count totals")
    differ_3e = {}
    for what, (sa, ca), (sb, cb_) in (
            ("gather form vs window_ops", (sg, cg), (so, co)),
            ("gather form vs dense kernel", (sg, cg), (sk, ck)),
            ("dense kernel vs window_ops", (sk, ck), (so, co))):
        differ_3e[what] = int(((sa[:, :wslot] != sb[:, :wslot]) & wlive[:, :, None]).sum().item())
        frac = differ_3e[what] / (int(wlive.sum().item()) * WIDE_CHAINS)
        check(frac <= MAX_MISMATCH, f"3e, {what}: {frac:.2e} of free sites differ")
        agree = (sa[:, :wslot] == sb[:, :wslot]).all(dim=0)[None] & wlive[:, :, None]
        check(not bool(((ca != cb_).any(dim=1).any(dim=1) & agree).any().item()),
              f"3e, {what}: counts differ on free rows where states agree")
    sp, cp = window_plain(*[wkst[k] for k in KERNEL_KEYS], wstate0.clone(), SEED, 1, 0, True, wcb)
    sd, cd = window_ops(wkst, wstate0.clone(), SEED, 1, 0, True, wcb)
    check(torch.equal(sd, sp) and torch.equal(cd, cp),
          "3e: on the dense encoding the ops route differs from the plain version")
    print(f"3e: {WIDE_SLOTS} collapse variants x {WIDE_CHAINS} chains, dense through the kernel, "
          f"all-gather (gfac_cap {gcaps.gfac_cap}, scope_cap {gcaps.scope_cap}) through the "
          f"kernel's gather form and through window_ops on the card, one counted sweep from one "
          f"state and seed: free sites that differ of "
          f"{int(wlive.sum().item()) * WIDE_CHAINS} {differ_3e} (bound {MAX_MISMATCH}), count "
          f"totals exact, counts equal where states agree; window_ops on the dense encoding "
          f"equals the plain version exactly; window_ops in blocks of "
          f"{chain_block(gkst, WIDE_CHAINS)} chains", flush=True)
    del sk, ck, sg, cg, so, co, sp, cp, sd, cd, agree, per_row

    # ---- 3c. the kernel on collapse-headroom encodings -----------------------
    hvariants, hcaps, hpicks = headroom_grid_variants()
    hkst, hstate0, hfree, hn_free = window_inputs(torch, dev, hvariants, hcaps,
                                                  HEADROOM_CHAINS)
    print(f"10x10 grid at headroom caps: collapse variants of vars {hpicks}: "
          f"color_cap {hcaps.color_cap}, adj_cap {hcaps.adj_cap}, oa_cap {hcaps.oa_cap}, "
          f"tail_cap {hcaps.tail_cap}, NVp {hcaps.num_rows}", flush=True)
    head_err = max(compare_window(
        torch, hkst, hstate0, hfree, hn_free, hcaps.num_slots, HEADROOM_CHAINS,
        hash_block(HEADROOM_CHAINS),
        "10x10 grid, headroom caps, 2 plain + 2 collapse").values())
    t0 = time.perf_counter()
    avariants, acaps, apicks = aux_variants()
    check((acaps.oa_cap, acaps.num_rows) == (256, 4200),
          f"aux caps oa_cap {acaps.oa_cap}, NVp {acaps.num_rows} != (256, 4200)")
    akst, astate0, afree, an_free = window_inputs(torch, dev, avariants, acaps, AUX_CHAINS)
    print(f"Promedus-shaped net at aux caps ({card}): collapse variants of vars {apicks}: "
          f"color_cap {acaps.color_cap}, oa_cap {acaps.oa_cap}, NVp {acaps.num_rows}, "
          f"k_tables {akst['k_tables'][0].numel() * 4 / 1e6:.1f} MB per variant (host "
          f"set-up {time.perf_counter() - t0:.1f} s)", flush=True)
    aux_err = max(compare_window(
        torch, akst, astate0, afree, an_free, acaps.num_slots, AUX_CHAINS,
        hash_block(AUX_CHAINS),
        f"{WIDE_SLOTS} aux collapse variants x {AUX_CHAINS} chains").values())

    # ---- 3f. the kernel at the wide aux tier's pooled caps -------------------
    t0 = time.perf_counter()
    spec = wide_aux_spec(promedus, dev)
    spec_cold_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(wide_aux_spec(promedus, dev) == spec, "3f: the cached spec differs from the computed one")
    spec_warm_secs = time.perf_counter() - t0
    check(spec is not None and spec.gfac_cap == 0 and spec.oa_cap <= PAL_AUX_OA_LIM
          and kernel_refusal(spec) is None, f"3f: no wide spec the kernel takes: {spec}")
    blankets = promedus.blankets()
    pool = sum(is_collapsible(promedus, u, blankets[u], oa_cap=PAL_AUX_OA_LIM)
               for u in range(promedus.num_vars))
    ppicks = distinct_picks(promedus, WIDE_SLOTS, PAL_AUX_OA_LIM)
    pvariants = [collapse_var(promedus, u)[0] for u in ppicks]
    pokst, postate0, pofree, pon_free = window_inputs(torch, dev, pvariants, spec,
                                                      POOLED_CHAINS)
    print(f"3f, the wide aux tier's pooled caps ({card}): {pool} candidates within "
          f"{PAL_AUX_OA_LIM} outcomes; spec {spec_cold_secs:.3f} s of host time from a cold "
          f"cache, {spec_warm_secs:.3f} s warm; color_cap {spec.color_cap}, group_cap "
          f"{spec.group_cap}, adj_cap {spec.adj_cap}, scope_cap {spec.scope_cap}, oa_cap "
          f"{spec.oa_cap}, NVp {spec.num_rows}; collapse variants of vars {ppicks}", flush=True)
    pcb = hash_block(POOLED_CHAINS)
    pooled_err = max(compare_window(
        torch, pokst, postate0, pofree, pon_free, spec.num_slots, POOLED_CHAINS, pcb,
        f"{WIDE_SLOTS} collapse variants at pooled caps x {POOLED_CHAINS} chains").values())
    # an 8-sweep counted window both ways from one state and seed
    sk, ck = gibbs_cuda.gibbs_window(pokst, postate0.clone(), SEED, WIDE_PAIR_SWEEPS,
                                     WIDE_PAIR_SWEEPS // 2, True, pcb)
    sp, cp = plain_window(pokst)(postate0.clone(), SEED, WIDE_PAIR_SWEEPS,
                                 WIDE_PAIR_SWEEPS // 2, True, pcb)
    torch.cuda.synchronize()
    nslot = spec.num_slots
    differ = int(((sk[:, :nslot] != sp[:, :nslot]) & pofree[:, :, None]).sum().item())
    sites_3f = int(pofree.sum().item()) * POOLED_CHAINS
    check(differ <= MAX_MISMATCH * sites_3f,
          f"3f: {differ} of {sites_3f} free sites differ after {WIDE_PAIR_SWEEPS} sweeps")
    for name, cn in (("kernel", ck), ("plain", cp)):
        got = int((cn.sum(dim=(1, 2, 4)) * pofree).sum().item())
        check(got == WIDE_PAIR_SWEEPS * POOLED_CHAINS * pon_free,
              f"3f: {name} count total {got} after {WIDE_PAIR_SWEEPS} sweeps")
    print(f"3f ({card}): {WIDE_PAIR_SWEEPS}-sweep counted window, kernel against the plain "
          f"version: {differ} of {sites_3f} free sites differ (bound {MAX_MISMATCH} of them), "
          f"count totals exact", flush=True)
    del sk, ck, sp, cp

    # ---- 3d. the kernel under a device mesh ----------------------------------
    def same_as(group, plain_group, what):
        """Every shard of ``group`` equals its block of ``plain_group``."""
        nl, cl = group.local_slots, group.local_chains
        for sh in group.shards:
            rows, cols = slice(sh.v0, sh.v0 + nl), slice(sh.c0, sh.c0 + cl)
            check(torch.equal(sh.state, plain_group.state[rows, cols]),
                  f"3d, {what}: shard ({sh.vi}, {sh.ci}) state differs from the unsharded group's")
            check(torch.equal(sh.halves, plain_group.halves[rows, :, cols]),
                  f"3d, {what}: shard ({sh.vi}, {sh.ci}) halves differ")
        check(np.array_equal(group.totals[: plain_group.slot_cap], plain_group.totals),
              f"3d, {what}: totals differ")

    t0 = time.perf_counter()
    mesh_cw = 20
    sharded = ShardedChainGroup(models[0], GRID_CHAINS, mesh_cw, seed=SEED, caps=caps,
                                mesh=chain_mesh(variant_ways=2, devices=[dev] * 4))
    unsharded = ChainGroup(models[0], GRID_CHAINS, mesh_cw, dev, seed=SEED, caps=caps)
    unsharded.cb = sharded.cb
    reset_counts()
    for g in (sharded, unsharded):
        g.add_variants(models)
        g.burn(10)
        g.advance(defer=True)
        g.advance(defer=True)
        torch.cuda.synchronize()
        t_flush = time.perf_counter()
        g.flush()
        flush_secs = time.perf_counter() - t_flush
        print(f"3d ({card}): {'sharded 2x2' if g is sharded else 'unsharded'} group, 2 x {GRID_CHAINS} "
              f"chains: flush of two windows' deltas {flush_secs * 1e3:.3f} ms of host time; "
              f"launches so far {dict(gibbs_cuda.gibbs_window.launches_by_form)}", flush=True)
    same_as(sharded, unsharded, "a burn and two counted windows")
    merged = sharded.merged_marginals()

    def psrf_secs(group):
        """(PSRF, host seconds of the call): the second of two calls, so
        that neither group pays for the first use of the torch ops."""
        group.convergence(merged=merged)
        torch.cuda.synchronize()
        t = time.perf_counter()
        return group.convergence(merged=merged), time.perf_counter() - t

    psrf_sharded, mom_secs = psrf_secs(sharded)
    psrf_unsharded, mom_plain_secs = psrf_secs(unsharded)
    check(np.allclose(psrf_sharded, psrf_unsharded, rtol=1e-5),
          "3d: PSRF from summed shard moments differs from the unsharded group's")
    print(f"3d ({card}; a virtual mesh on one card, no scaling figure): sharded equals "
          f"unsharded on state, halves and totals; PSRF by shard moments summed on the host "
          f"{mom_secs * 1e3:.3f} ms of host time, unsharded {mom_plain_secs * 1e3:.3f} ms",
          flush=True)
    shard_errs = []
    seed_3d = window_seed(SEED, sharded._step + 1)  # the next window's
    for sh, _, _, na, stack in sharded.launches():
        kst_sh = stack.cut(sh.device, na)
        name = f"3d shard ({sh.vi}, {sh.ci}): {na} x {sharded.local_chains} chains"
        describe_launch(torch, kst_sh, sharded.local_chains, True, name)
        st_sh = kernel_order(torch, kst_sh, sh.state[:na])
        shard_errs.append(max(compare_window(
            torch, kst_sh, st_sh, kst_sh["k_kmask"].reshape(na, -1, caps.max_card).any(dim=2),
            int(models[sh.v0].free_mask.sum()), caps.num_slots, sharded.local_chains, sharded.cb,
            name, seed=shard_seed(seed_3d, sh.v0, sh.c0 // sharded.cb),
            forms=KERNEL_FORMS[:2]).values()))
    # one shard's tensors, timed in phase 5
    sh0, _, _, na0, stack0 = next(iter(sharded.launches()))
    shard_kst = stack0.cut(sh0.device, na0)
    shard_state0 = kernel_order(torch, shard_kst, sh0.state[:na0])
    shard_n_free = int(models[0].free_mask.sum())
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "mesh.npz")
        save_checkpoint(ck, sharded)
        resumed, _ = load_checkpoint(
            ck, models[0], device=dev,
            make_group=lambda m, **kw: ShardedChainGroup(
                m, mesh=chain_mesh(variant_ways=1, devices=[dev] * 4), caps=caps, **kw))
    check(resumed.mesh.shape == {"variants": 1, "chains": 4} and resumed.cb == sharded.cb,
          f"3d: resumed onto {resumed.mesh.shape} with cb {resumed.cb}")
    for g in (sharded, unsharded, resumed):
        g.advance()
    same_as(sharded, unsharded, "a third window")
    same_as(resumed, unsharded, "saved on 2x2, resumed on 1x4, advanced")
    print(f"3d ({card}): saved on a 2x2 mesh, resumed on 1x4, advanced: equal to the group that was "
          f"never saved; launches by form {dict(gibbs_cuda.gibbs_window.launches_by_form)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del sharded, unsharded, resumed

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
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main([
            "sample", "-m", path, "-d", "-o", "-s", "simple",
            "--vchains", str(GRID_CHAINS), "-b", str(200 * v), "-w", str(100 * v),
            "-i", str(4 * 100 * 2 * GRID_CHAINS * (v - len(evidence))),
            "-x", "60", "-e", str(SEED), "--mar-out", mar_out,
        ])
        torch.cuda.synchronize()
        cli_secs = time.perf_counter() - t0
        launches = read_counts("4")
        check(rc == 0, f"cli returned {rc}")
        check(launches > 0, "the CLI run did not launch the sweep kernel")
        check(os.path.exists(mar_out), "--mar-out wrote no file")
        est = pad_marginals(read_mar_file(mar_out), model.cards)
        check(np.isfinite(est).all() and est.shape == (v, 2), "bad MAR output")
        score = error_suite(est, truth, model.cards, model.fixed, None)
    check(score.max_hellinger < HELL_BOUND,
          f"max Hellinger {score.max_hellinger:.5f} >= {HELL_BOUND}")
    print(f"cli sample -s simple ({card}): {cli_secs:.1f} s, {launches} kernel launches, "
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
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([
                "sample", "-m", path, "-d", "-o", "-s", "collapsed", "-c", "8",
                "--vchains", str(COLLAPSED_CHAINS), "-b", str(200 * v), "-w", str(100 * v),
                "-x", "20", "-e", str(SEED), "--mar-out", mar_out,
            ])
        torch.cuda.synchronize()
        col_secs = time.perf_counter() - t0
        col_launches = read_counts("4b")
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
    print(f"cli sample -s collapsed -c 8 --vchains {COLLAPSED_CHAINS} ({card}): {col_secs:.1f} s, "
          f"{col_launches} kernel launches, collapsed vars {logged} (local tables of "
          f"{ccaps.oa_cap} rows), max Hellinger {col_score.max_hellinger:.6f} "
          f"(bound {HELL_BOUND})", flush=True)

    # ---- 4c/4d. the adaptive path through the CLI: one group, then split -----
    model = grid_model(4, 7)
    evidence = {5: 1, 10: 0}
    model_ev = grid_model(4, 7)
    model_ev.apply_evidence(evidence)
    truth = exact_marginals(model_ev)
    v = model.num_vars
    with tempfile.TemporaryDirectory() as td:
        path = write_net(td, "grid4", model, evidence, truth)
        ck = os.path.join(td, "ck.npz")
        for phase, split in (("4c", "auto"), ("4d", "on")):
            mar_out, trace = os.path.join(td, f"{phase}.MAR"), os.path.join(td, f"{phase}.t")
            argv = ["sample", "-m", path, "-d", "-o", "-s", "adaptive", "-c", "2",
                    "--vchains", str(GRID_CHAINS), "-a", "2", "-b", str(200 * v),
                    "-w", str(100 * v), "-x", str(CLI_ADAPT_SECS), "-e", str(SEED),
                    "--split-group", split, "--mar-out", mar_out, "-t", trace]
            reset_counts()
            t0 = time.perf_counter()
            rc, log = run_cli(cli, argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches_a = read_counts(phase)
            res = summary(trace)
            steps = adapt_secs(log)
            check(rc == 0, f"{phase}: cli returned {rc}")
            check(launches_a > 0, f"{phase}: the adaptive CLI run did not launch the kernel")
            check(("split group" in log) == (split == "on"),
                  f"{phase}: split group {'missing from' if split == 'on' else 'in'} the log")
            check(len(steps) >= 2, f"{phase}: {len(steps)} adapt steps < 2")
            check(len(res["collapsed"]) >= 2, f"{phase}: collapsed vars {res['collapsed']}")
            check((res["aux_secs"] > 0) == (split == "on"), f"{phase}: aux_secs {res['aux_secs']}")
            est = pad_marginals(read_mar_file(mar_out), model.cards)
            check(np.isfinite(est).all() and est.shape == (v, 2), f"{phase}: bad MAR output")
            a_score = error_suite(est, truth, model_ev.cards, model_ev.fixed, None)
            check(a_score.max_hellinger < HELL_BOUND,
                  f"{phase}: max Hellinger {a_score.max_hellinger:.5f} >= {HELL_BOUND}")
            aux_line = [ln for ln in log.splitlines() if ln.startswith("aux group:")]
            if split == "on":
                check(aux_line and all(ln.startswith(
                    f"aux group: wide tier, {GRID_CHAINS} chains per variant, candidate bound "
                    f"{PAL_AUX_OA_LIM}") for ln in aux_line), f"{phase}: aux lines {aux_line}")
            print(f"cli sample -s adaptive -c 2 --vchains {GRID_CHAINS} -a 2 -x {CLI_ADAPT_SECS} "
                  f"--split-group {split} ({phase}; {card}): {secs:.1f} s, {launches_a} kernel "
                  f"launches, {len(steps)} adapt steps ({sum(steps):.3f} s of host time), "
                  f"collapsed vars {res['collapsed']}, {res['variants']} variants, aux "
                  f"{res['aux_secs']:.3f} s {aux_line}, max Hellinger "
                  f"{a_score.max_hellinger:.6f} (bound {HELL_BOUND})", flush=True)

        # ---- 4e. kill and resume on the card ---------------------------------
        gmodel = grid_variants()[0][0]

        def fresh():
            g = ChainGroup(gmodel, chains_per_variant=GRID_CHAINS, converge_window=20,
                           device=dev, seed=SEED)
            g.add_variants([gmodel, gmodel])
            g.burn(10)
            g.advance()
            return g

        t0 = time.perf_counter()
        a = fresh()
        a.advance()
        b = fresh()
        save_checkpoint(ck, b)
        del b
        b2, _ = load_checkpoint(ck, gmodel, device=dev)
        b2.advance()
        check(torch.equal(a.state, b2.state) and torch.equal(a.halves, b2.halves)
              and np.array_equal(a.totals, b2.totals), "kill-and-resume is not bit-exact")
        print(f"kill and resume ({card}), 10x10 grid, 2 x {GRID_CHAINS} chains: state, halves and "
              f"totals bit-exact ({time.perf_counter() - t0:.1f} s)", flush=True)
        del a, b2
        base = ["sample", "-m", path, "-d", "-o", "-s", "adaptive", "-c", "2",
                "--vchains", str(GRID_CHAINS), "-a", "2", "-b", str(200 * v),
                "-w", str(100 * v), "-e", str(SEED), "--split-group", "on",
                "--checkpoint", ck, "--checkpoint-secs", "2"]
        os.remove(ck)
        rc, log1 = run_cli(cli, base + ["-x", str(CLI_ADAPT_SECS // 3)])
        check(rc == 0 and os.path.exists(ck + ".aux"), "4e: the first run wrote no split snapshot")
        g1, meta1 = load_checkpoint(ck, model_ev, device=dev)
        snaps1 = dict(g1.aux._rbp_snaps)
        check(g1.aux_tier == "wide" and g1.aux_cpv == g1.aux.cpv == GRID_CHAINS
              and g1.collapse_oa_cap == PAL_AUX_OA_LIM
              and g1.aux.caps == wide_aux_spec(model_ev, dev),
              f"4e: the snapshot reloaded on the {g1.aux_tier} tier, {g1.aux_cpv} aux chains")
        # one save of the snapshot's group, timed: the wide aux's slots hold
        # 512 times the narrow tier's chains, and the periodic saves run on
        # the budget clock
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(td, "4e_timed.npz"), g1)
        save_secs = time.perf_counter() - t0
        aux_mb = (g1.aux.state.numel() + g1.aux.halves.numel()) * 4 / 1e6
        reset_counts()
        # the snapshot's clock, its saves included, is spent: give more
        resume_secs = math.ceil(meta1["runtime"]) + CLI_ADAPT_SECS // 3
        rc, log2 = run_cli(cli, base + ["-x", str(resume_secs), "--resume"])
        launches_r = read_counts("4e")
        g2, meta2 = load_checkpoint(ck, model_ev, device=dev)
        check(rc == 0 and "RESUMED" in log2, "4e: the run did not resume")
        check(launches_r > 0, "4e: the resumed run did not launch the kernel")
        check(meta2["total_samples"] > meta1["total_samples"],
              f"4e: the sample count did not grow ({meta1['runtime']:.2f} -> "
              f"{meta2['runtime']:.2f} s of clock): " + "; ".join(
                  ln.strip() for ln in log2.splitlines()
                  if ln.startswith(("RESUMED", "checkpoint", "  Samps", "STOPPING"))))
        check(snaps1 and all(g2.aux._rbp_snaps[k] > n for k, n in snaps1.items()),
              f"4e: RB snapshots did not continue: {snaps1} -> {g2.aux._rbp_snaps}")
        print(f"kill and resume through the CLI (4d with --checkpoint; {card}): "
              f"{meta1['total_samples']:,} -> {meta2['total_samples']:,} samples, "
              f"{meta1['runtime']:.1f} -> {meta2['runtime']:.1f} s of clock, reloaded on the "
              f"wide tier ({g1.aux_cpv} aux chains per variant, the spec's caps), RB snapshots "
              f"{snaps1} -> {dict(g2.aux._rbp_snaps)}, {launches_r} kernel launches after "
              f"resume (-x {resume_secs}); one save of the snapshot's split group "
              f"{save_secs:.3f} s of host time ({aux_mb:.1f} MB of aux state and halves, "
              f"{g1.aux.slot_cap} slots)", flush=True)
        del g1, g2

        # ---- 4f. the adaptive engine under a mesh; --mesh auto ------------------
        mesh_secs = 20
        cfg = EngineConfig(
            model_path=path, device="cuda", use_evidence=True, use_solution=True,
            sampler="adaptive", chains=2, chains_per_variant=GRID_CHAINS, chain_adds=2,
            burnin=200 * v, converge_window=100 * v, max_secs=float(mesh_secs), seed=SEED,
            mesh="2x2")
        lines = []
        reset_counts()
        t0 = time.perf_counter()
        res = Engine(cfg, log=lines.append, devices=[dev] * 4).run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches_m = read_counts("4f")
        rate_4f = res.samples_per_sec
        mesh_line = [ln for ln in lines if ln.startswith("device mesh:")]
        steps = adapt_secs("\n".join(lines))
        check(mesh_line == ["device mesh: {'variants': 2, 'chains': 2} over 4 devices; "
                            "this process: cuda:0"],
              f"4f: mesh line {mesh_line}")
        check(not any("split group" in ln for ln in lines), "4f: a split group under a mesh")
        check(len(steps) >= 1 and len(res.collapsed) >= 2,
              f"4f: {len(steps)} adapt steps, collapsed vars {res.collapsed}")
        check(launches_m > 0, "4f: the sharded engine run did not launch the kernel")
        check(np.isfinite(res.marginals).all() and res.marginals.shape == (v, 2),
              "4f: bad marginals")
        check(res.final_score.max_hellinger < HELL_BOUND,
              f"4f: max Hellinger {res.final_score.max_hellinger:.5f} >= {HELL_BOUND}")
        print(f"engine -s adaptive -c 2 --vchains {GRID_CHAINS} -a 2 -x {mesh_secs} under a 2x2 "
              f"virtual mesh of the card (4f; {card}; no scaling figure): {secs:.1f} s, "
              f"{launches_m} kernel launches, {len(steps)} adapt steps ({sum(steps):.3f} s of "
              f"host time), collapsed vars {res.collapsed}, {res.variants} variants, "
              f"{res.samples_per_sec:.4e} counted site-samples/s, max Hellinger "
              f"{res.final_score.max_hellinger:.6f} (bound {HELL_BOUND})", flush=True)
        reset_counts()
        rc, log = run_cli(cli, ["sample", "-m", path, "-d", "-o", "-s", "simple", "--mesh", "auto",
                                "--vchains", str(GRID_CHAINS), "-b", str(200 * v),
                                "-w", str(100 * v), "-x", "5", "-e", str(SEED)])
        launches_auto = read_counts("4f auto")
        check(rc == 0 and "FINAL" in log, f"4f: --mesh auto returned {rc}")
        n_cards = torch.cuda.device_count()
        # one card: unsharded; several: a mesh over them all (phase 8c)
        check(("device mesh" in log) == (n_cards > 1),
              f"4f: --mesh auto on {n_cards} card(s): {log.count('device mesh')} mesh lines")
        check(launches_auto > 0, "4f: --mesh auto did not launch the kernel")
        print(f"cli sample -s simple --mesh auto on {n_cards} card(s): "
              f"{'sharded' if n_cards > 1 else 'unsharded'}, {launches_auto} kernel launches",
              flush=True)

        # ---- 4g. tooling --------------------------------------------------------
        from grample_tpu_torch import native
        from grample_tpu_torch.pgm.coloring import moral_adjacency
        from grample_tpu_torch.uai import parser

        rc, dot = run_cli(cli, ["dot", "-m", path])
        adj = moral_adjacency(v, [f.scope for f in model.factors])
        edges = [ln for ln in dot.splitlines() if " -- " in ln]
        check(rc == 0 and len(edges) == sum(len(a) for a in adj) // 2,
              f"4g: dot printed {len(edges)} edges")
        check(native.load() is not None, "4g: the native tier did not build")
        counts, a_secs, a_rate = native.anchor_gibbs(model_ev, 2_000_000, seed=SEED)
        free = model_ev.fixed < 0
        a_score = error_suite(counts.astype(np.float64) + 1e-9, truth, model_ev.cards,
                              model_ev.fixed, None)
        check(int(counts[free].sum()) == 2_000_000 and int(counts[~free].sum()) == 0,
              "4g: the anchor's counts do not add up")
        check(a_score.max_hellinger < 0.02,
              f"4g: anchor max Hellinger {a_score.max_hellinger:.5f} >= 0.02")
        with open(path) as fh:
            text = fh.read()
        fast, portable = parser.parse_model(text), parser.parse_model(text, native=False)
        check(len(fast.factors) == len(portable.factors) and all(
            np.array_equal(a.table, b.table) and np.array_equal(a.scope, b.scope)
            for a, b in zip(fast.factors, portable.factors)),
            "4g: the native tokenizer's model differs from the portable one's")
        print(f"tooling (4g): dot {len(edges)} edges; native anchor on the 4x4 grid, 2e6 "
              f"samples: {a_rate:.4e} samples/s on one core of the host ({cpu_name()}; a host "
              f"figure, beside the card {card}), max Hellinger {a_score.max_hellinger:.6f} "
              f"(bound 0.02); native tokenizer's model equals the portable one's", flush=True)

        # ---- 4j. --distributed: two rank processes on the card ------------------
        one_card = [visible_cards(torch)[0]] * 2  # both ranks on the first card
        gmodel = grid_model(10, 1)
        gpath = write_net(td, "grid10", gmodel, {0: 1, 55: 0, 99: 1})
        gv = gmodel.num_vars
        argv_a = ["sample", "-m", gpath, "-d", "-s", "simple", "--vchains", str(GRID_CHAINS),
                  "-b", str(100 * gv), "-w", str(100 * gv), "-i", "1", "-e", str(SEED)]
        mar_ranks, mar_one = os.path.join(td, "4j_ranks.MAR"), os.path.join(td, "4j_one.MAR")
        t0 = time.perf_counter()
        outs, records = run_ranks(
            argv_a + ["--distributed", "--mesh", "1x2", "--mar-out", mar_ranks], "4j (a)",
            one_card)
        secs_a = time.perf_counter() - t0
        add_rank_launches("4j", records)
        check("device mesh: {'variants': 1, 'chains': 2} over 2 devices of 2 ranks" in outs[0],
              "4j (a): no world mesh line")
        rc, _ = run_cli(cli, argv_a + ["--mar-out", mar_one])
        with open(mar_ranks) as fh_r, open(mar_one) as fh_o:
            same = fh_r.read() == fh_o.read()
        check(rc == 0 and same, "4j (a): rank 0's MAR differs from the one-process run's")
        print(f"4j (a) ({card}): sample -s simple -i 1 on the 10x10 grid, 2 x {GRID_CHAINS} "
              f"chains over a 1x2 world mesh of two rank processes: rank 0's MAR equals the "
              f"one-process unsharded run's byte for byte; {secs_a:.1f} s wall with process "
              f"start; launches {[rec['launches'] for rec in records]}; collectives "
              f"{collective_ms(records)}", flush=True)

        mar_b, trace_b = os.path.join(td, "4j.MAR"), os.path.join(td, "4j.t")
        argv_b = ["sample", "-m", path, "-d", "-o", "-s", "adaptive", "-c", "2",
                  "--vchains", str(GRID_CHAINS), "-a", "2", "-b", str(200 * v),
                  "-w", str(100 * v), "-e", str(SEED)]
        t0 = time.perf_counter()
        outs, records = run_ranks(
            argv_b + ["-x", str(RANKS_ADAPT_SECS), "--distributed", "--mesh", "2x1",
                      "--mar-out", mar_b, "-t", trace_b], "4j (b)", one_card)
        secs_b = time.perf_counter() - t0
        add_rank_launches("4j", records)
        picks = [adapt_picks(out) for out in outs]
        res_b = summary(trace_b)
        check(picks[0] and picks[0] == picks[1],
              f"4j (b): the ranks' adapt steps differ: {picks}")
        est = pad_marginals(read_mar_file(mar_b), model.cards)
        b_score = error_suite(est, truth, model_ev.cards, model_ev.fixed, None)
        check(np.isfinite(est).all() and b_score.max_hellinger < HELL_BOUND,
              f"4j (b): max Hellinger {b_score.max_hellinger:.5f} >= {HELL_BOUND}")
        print(f"4j (b) ({card_line()}): sample -s adaptive -c 2 --vchains {GRID_CHAINS} -a 2 "
              f"-x {RANKS_ADAPT_SECS} over a 2x1 world mesh of two rank processes on one card: "
              f"{secs_b:.1f} s wall with process start; both ranks: {picks[0]}; collapsed vars "
              f"{res_b['collapsed']}, {res_b['variants']} variants; "
              f"{res_b['samples_per_sec']:.4e} counted site-samples/s over "
              f"{res_b['runtime']:.2f} s of sampling clock (4f, one process over a 2x2 virtual "
              f"mesh: {rate_4f:.4e}; one card shared by two processes: no scaling figure); max "
              f"Hellinger {b_score.max_hellinger:.6f} (bound {HELL_BOUND}); launches "
              f"{[rec['launches'] for rec in records]}; collectives {collective_ms(records)}",
              flush=True)

        ck = os.path.join(td, "4j_ck.npz")
        t0 = time.perf_counter()
        outs, records = run_ranks(
            argv_b + ["-x", str(RANKS_CKPT_SECS), "--checkpoint", ck, "--checkpoint-secs", "2",
                      "--distributed", "--mesh", "2x1"], "4j (c)", one_card)
        secs_c = time.perf_counter() - t0
        add_rank_launches("4j", records)
        meta1 = read_meta(ck)
        trace_c = os.path.join(td, "4j_resume.t")
        reset_counts()
        # the snapshot's clock (its save included) is spent: give more
        rc, log = run_cli(cli, argv_b + [
            "-x", str(math.ceil(meta1["runtime"]) + RESUME_SECS), "--checkpoint", ck,
            "--resume", "-t", trace_c])
        launches_c = read_counts("4j resume")
        res_c = summary(trace_c)
        check(rc == 0 and "RESUMED" in log and "device mesh" not in log,
              f"4j (c): the one-process run did not resume ({rc})")
        check(launches_c > 0 and res_c["samples"] > meta1["total_samples"],
              "4j (c): the resumed run did not go on")
        print(f"4j (c) ({card}): the same over the two ranks for {RANKS_CKPT_SECS} s with --checkpoint "
              f"({secs_c:.1f} s wall with process start; collectives and saves "
              f"{collective_ms(records)}), {meta1['slot_cap']} slots saved after "
              f"{meta1['runtime']:.2f} s of clock, resumed by one unsharded process for "
              f"{RESUME_SECS} s more: {meta1['total_samples']:,} -> {res_c['samples']:,} "
              f"samples, {launches_c} kernel launches after resume", flush=True)

        # ---- 4k. the narrow aux tier on the card -------------------------------
        nmodel = torch_models.grid(discrete, 2, seed=4, card=9)
        ntruth = exact_marginals(nmodel)
        npath = write_net(td, "grid2_card9", nmodel, {}, ntruth)
        check(wide_aux_spec(nmodel, dev) is None, "4k: the 2x2 grid at card 9 has a wide spec")
        mar_n = os.path.join(td, "4k.MAR")
        reset_counts()
        t0 = time.perf_counter()
        rc, log = run_cli(cli, [
            "sample", "-m", npath, "-o", "-s", "adaptive", "-c", "2", "--vchains",
            str(GRID_CHAINS), "-a", "2", "-b", str(200 * 4), "-w", str(100 * 4), "-x",
            str(NARROW_SECS), "-e", str(SEED), "--split-group", "on", "--mar-out", mar_n])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches_n = read_counts("4k")
        aux_line = [ln for ln in log.splitlines() if ln.startswith("aux group:")]
        steps = adapt_secs(log)
        check(rc == 0 and launches_n > 0, f"4k: cli returned {rc}, {launches_n} kernel launches")
        check(aux_line and all(ln.startswith(
            f"aux group: narrow tier, {AUX_CHAINS} chains per variant, candidate bound "
            f"{COLLAPSE_OA_DENSE_CAP}") for ln in aux_line), f"4k: aux lines {aux_line}")
        check(len(steps) >= 1 and "collapsed vars" in log, f"4k: {len(steps)} adapt steps")
        est = pad_marginals(read_mar_file(mar_n), nmodel.cards)
        n_score = error_suite(est, ntruth, nmodel.cards, nmodel.fixed, None)
        check(np.isfinite(est).all() and n_score.max_hellinger < HELL_BOUND,
              f"4k: max Hellinger {n_score.max_hellinger:.5f} >= {HELL_BOUND}")
        print(f"4k ({card}): cli sample -s adaptive -c 2 --vchains {GRID_CHAINS} -a 2 -x "
              f"{NARROW_SECS} --split-group on, a 2x2 grid at card 9 (no candidate within "
              f"{PAL_AUX_OA_LIM} outcomes): {secs:.1f} s, {aux_line}, {len(steps)} adapt steps, "
              f"{launches_n} kernel launches, max Hellinger {n_score.max_hellinger:.6f} (bound "
              f"{HELL_BOUND})", flush=True)

    # ---- 5. timing ---------------------------------------------------------
    def timed(fn, st0, sweeps, count=True, cb=cb) -> float:
        st = st0.clone()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(st, SEED, sweeps, sweeps // 2, count, cb)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    def kern(kst_, sites=None, plan=None):
        return lambda st, seed, sweeps, half, count, cb_: gibbs_cuda.gibbs_window(
            kst_, st, seed, sweeps, half, count, cb_,
            plan or form_plan(torch, kst_, st.shape[2], count, sites))

    plain = plain_window

    def best(fn, st0, sweeps, count=True, cb=cb) -> float:
        fn(st0.clone(), SEED, 1, 0, count, cb)  # warm
        return min(timed(fn, st0, sweeps, count, cb), timed(fn, st0, sweeps, count, cb))

    def shape_rows(label, kst_, st0, nf, chains, sweeps, shapes):
        """One counted thread-per-chain window at each (threads, lists
        staged, tables staged) of ``shapes``, beside the rule's pick."""
        fit = gibbs_cuda.plan_launch(
            kst_, chains, True, torch.cuda.get_device_properties(0).multi_processor_count,
            False)
        for threads, lists, tables in shapes:
            plan = reshaped(kst_, fit, threads, lists, tables)
            if plan is None:
                continue
            name = (f"{label}, {sweeps}-sweep counted window, thread per chain at {threads} "
                    f"threads, lists {'staged' if lists else 'in device memory'}, tables "
                    f"{'staged' if tables else 'in device memory'}")
            describe_launch(torch, kst_, chains, True, name, plan=plan)
            ms = best(kern(kst_, plan=plan), st0, sweeps, cb=hash_block(chains))
            rate_line(name, sweeps * chains * nf, ms)

    def rate_line(label, sites, kernel_ms, plain_ms=None, bound=None):
        text = (f"timing ({card}): {label}: kernel {kernel_ms:.3f} ms = "
                f"{sites / (kernel_ms / 1e3):.4e} site-samples/s")
        if plain_ms is not None:
            text += (f", plain {plain_ms:.3f} ms = {sites / (plain_ms / 1e3):.4e} "
                     f"site-samples/s, kernel/plain speed {plain_ms / kernel_ms:.2f}x")
            if kernel_ms >= plain_ms:
                text += " (the kernel is SLOWER)"
        if bound is not None:
            text += (f"; bound {bound[0]:.3f} ms by {bound[1]} "
                     f"({bound[0] / kernel_ms:.3f} of the kernel's time)")
        print(text, flush=True)

    source = "grample_tpu_torch/csrc/gibbs_window.cu"
    kernels = []

    def record(name, replaces, launched, err, ms, plain_ms_, bound):
        """``launched(path_launches)`` gives the entry's launches once
        every main path has run."""
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms_,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None})

    def of_form(*forms):
        return lambda paths: sum(by_form.get(form, 0) for by_form in paths.values()
                                 for form in forms)

    def of_phases(*phases):
        return lambda paths: sum(sum(paths.get(ph, {}).values()) for ph in phases)

    # the 10x10 grid: every kernel form against one plain run each
    sites = TIMED_SWEEPS * GRID_CHAINS * n_free
    grid_label = f"10x10 grid, 262144 chains, {TIMED_SWEEPS}-sweep window"
    plain_ms = timed(plain(kst), state0, TIMED_SWEEPS)
    plain_unc_ms = timed(plain(kst), state0, TIMED_SWEEPS, False)
    grid_ms = {}
    for form, count, by_site in KERNEL_FORMS:
        plan = describe_launch(torch, kst, GRID_CHAINS, count, f"{grid_label}, {form}", by_site)
        grid_ms[form] = best(kern(kst, by_site), state0, TIMED_SWEEPS, count)
        bound = window_bound(kst, GRID_CHAINS, TIMED_SWEEPS, count, clock_hz)
        rate_line(f"{grid_label}, {form}", sites, grid_ms[form],
                  plain_ms if count else plain_unc_ms, bound)
        if not form.startswith("rule"):
            record(f"gibbs_window ({form})", "grample_tpu/ops/gibbs_pallas.py:297",
                   of_form(gibbs_cuda.form_name(plan)), grid_errs[form], grid_ms[form],
                   plain_ms if count else plain_unc_ms, bound)
    kernel_ms = grid_ms["rule"]
    print(f"timing: the same window uncounted: {grid_ms['rule, uncounted'] / kernel_ms:.3f} of the "
          f"counted window", flush=True)

    # the same grid at card 8: the instance with 8 logits a thread, held
    # against the plain version and timed at each block width
    k8models, k8caps = grid_variants(8)
    k8kst, k8state0, k8free, k8n_free = window_inputs(torch, dev, k8models, k8caps, GRID_CHAINS)
    compare_window(torch, k8kst, k8state0, k8free, k8n_free, k8caps.num_slots, GRID_CHAINS,
                   cb, "10x10 grid at card 8")
    k8label = "10x10 grid at card 8, 262144 chains"
    describe_launch(torch, k8kst, GRID_CHAINS, True, f"{k8label}, {K8_SWEEPS}-sweep counted window")
    rate_line(f"{k8label}, {K8_SWEEPS}-sweep counted window", K8_SWEEPS * GRID_CHAINS * k8n_free,
              best(kern(k8kst), k8state0, K8_SWEEPS), None,
              window_bound(k8kst, GRID_CHAINS, K8_SWEEPS, True, clock_hz))
    shape_rows(k8label, k8kst, k8state0, k8n_free, GRID_CHAINS, K8_SWEEPS,
               [(1024, True, True), (512, True, True), (256, True, True)])
    del k8kst, k8state0

    # the collapse-headroom encodings of phase 3c, kernel and plain
    for label, kst_h, st_h, nf, chains, sweeps, err, replaces in (
            ("10x10 grid at headroom caps, 2 plain + 2 collapse variants x "
             f"{HEADROOM_CHAINS} chains", hkst, hstate0, hn_free, HEADROOM_CHAINS, TIMED_SWEEPS,
             head_err, "grample_tpu/ops/gibbs_pallas.py:297"),
            (f"{WIDE_SLOTS} Promedus-shaped collapse variants at aux caps x {AUX_CHAINS} "
             "chains", akst, astate0, an_free, AUX_CHAINS, WIDE_PAIR_SWEEPS, aux_err,
             "grample_tpu/ops/gibbs_pallas.py:355-367")):
        cb_h = hash_block(chains)
        label = f"{label}, {sweeps}-sweep counted window"
        describe_launch(torch, kst_h, chains, True, label)
        k_ms = best(kern(kst_h), st_h, sweeps, cb=cb_h)
        p_ms = timed(plain(kst_h), st_h, sweeps, cb=cb_h)
        bound = window_bound(kst_h, chains, sweeps, True, clock_hz)
        rate_line(label, sweeps * chains * nf, k_ms, p_ms, bound)
        for name, by_site in (("thread per chain", False), ("site-parallel", True)):
            describe_launch(torch, kst_h, chains, True, f"{label}, {name}", by_site)
            rate_line(f"{label}, {name}", sweeps * chains * nf,
                      best(kern(kst_h, by_site), st_h, sweeps, cb=cb_h))
        record(f"gibbs_window ({label.split(',')[0]})", replaces,
               of_phases("4c") if kst_h is hkst else of_phases("4k"), err, k_ms, p_ms, bound)
    del hkst, hstate0, akst, astate0

    # 3f's window: the wide aux tier's collapse variants at the pooled caps
    polabel = (f"{WIDE_SLOTS} Promedus-shaped collapse variants at pooled caps x "
               f"{POOLED_CHAINS} chains, {WIDE_PAIR_SWEEPS}-sweep counted window")
    describe_launch(torch, pokst, POOLED_CHAINS, True, polabel)
    pooled_ms = best(kern(pokst), postate0, WIDE_PAIR_SWEEPS, cb=pcb)
    pooled_plain_ms = timed(plain(pokst), postate0, WIDE_PAIR_SWEEPS, cb=pcb)
    pooled_bound = window_bound(pokst, POOLED_CHAINS, WIDE_PAIR_SWEEPS, True, clock_hz)
    rate_line(polabel, WIDE_PAIR_SWEEPS * POOLED_CHAINS * pon_free, pooled_ms, pooled_plain_ms,
              pooled_bound)
    for name, by_site in (("thread per chain", False), ("site-parallel", True)):
        describe_launch(torch, pokst, POOLED_CHAINS, True, f"{polabel}, {name}", by_site)
        rate_line(f"{polabel}, {name}", WIDE_PAIR_SWEEPS * POOLED_CHAINS * pon_free,
                  best(kern(pokst, by_site), postate0, WIDE_PAIR_SWEEPS, cb=pcb))
    record("gibbs_window (wide aux tier, pooled caps)", "grample_tpu/ops/gibbs_pallas.py:297",
           of_phases("4d", "4e", "5b adaptive"), pooled_err, pooled_ms, pooled_plain_ms,
           pooled_bound)
    del pokst, postate0

    # one shard of phase 3d's 2x2 mesh: the launch a sharded group makes
    sh_chains = shard_state0.shape[2]
    sh_label = (f"one shard of the 10x10 grid on a 2x2 mesh, {shard_state0.shape[0]} x "
                f"{sh_chains} chains, {TIMED_SWEEPS}-sweep counted window")
    sh_plan = describe_launch(torch, shard_kst, sh_chains, True, sh_label)
    sh_cb = hash_block(sh_chains)
    sh_ms = best(kern(shard_kst), shard_state0, TIMED_SWEEPS, cb=sh_cb)
    sh_plain_ms = timed(plain(shard_kst), shard_state0, TIMED_SWEEPS, cb=sh_cb)
    sh_bound = window_bound(shard_kst, sh_chains, TIMED_SWEEPS, True, clock_hz)
    rate_line(sh_label, TIMED_SWEEPS * sh_chains * shard_n_free, sh_ms, sh_plain_ms, sh_bound)
    print(f"timing ({card}): four such shards one after the other {4 * sh_ms:.3f} ms, the unsharded "
          f"window {kernel_ms:.3f} ms ({gibbs_cuda.form_name(sh_plan)}; one card, one stream: "
          f"no scaling figure)", flush=True)
    record("gibbs_window (sharded launch)", "grample_tpu/parallel/mesh.py:137",
           of_phases("4f", "4j", "8a", "8b", "8c", "8c -i 1", "8d", "8e"),
           max(shard_errs), sh_ms, sh_plain_ms, sh_bound)
    del shard_kst, shard_state0

    wsites = WIDE_CHAINS * wn_free
    wlabel = f"{WIDE_SLOTS} collapse variants x {WIDE_CHAINS} chains"
    describe_launch(torch, wkst, WIDE_CHAINS, True, wlabel)
    wide_full_ms = best(kern(wkst), wstate0, WIDE_FULL_SWEEPS)
    rate_line(f"{wlabel}, {WIDE_FULL_SWEEPS}-sweep counted window", WIDE_FULL_SWEEPS * wsites,
              wide_full_ms, None, window_bound(wkst, WIDE_CHAINS, WIDE_FULL_SWEEPS, True, clock_hz))
    wide_ms = best(kern(wkst), wstate0, WIDE_PAIR_SWEEPS)
    wide_plain_ms = timed(plain(wkst), wstate0, WIDE_PAIR_SWEEPS)
    wbound = window_bound(wkst, WIDE_CHAINS, WIDE_PAIR_SWEEPS, True, clock_hz)
    rate_line(f"the same variants, {WIDE_PAIR_SWEEPS}-sweep counted window",
              WIDE_PAIR_SWEEPS * wsites, wide_ms, wide_plain_ms, wbound)
    # 3e's times: the same 8-sweep counted window on the kernel's gather form
    # and on the ops route, both on the all-gather encoding, and on the ops
    # route on the dense one
    glabel = (f"3e, {WIDE_SLOTS} collapse variants all-gather x {WIDE_CHAINS} chains, "
              f"{WIDE_PAIR_SWEEPS}-sweep counted window, gather form")
    gplan = describe_launch(torch, gkst, WIDE_CHAINS, True, glabel)
    gather_ms = best(kern(gkst), wstate0, WIDE_PAIR_SWEEPS)
    torch.cuda.reset_peak_memory_stats()
    ops_gather_ms = best(plain(gkst), wstate0, WIDE_PAIR_SWEEPS)
    ops_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gbound = window_bound(gkst, WIDE_CHAINS, WIDE_PAIR_SWEEPS, True, clock_hz)
    rate_line(glabel, WIDE_PAIR_SWEEPS * wsites, gather_ms, ops_gather_ms, gbound)
    ops_dense_ms = best(lambda st, *a: window_ops(wkst, st, *a), wstate0, WIDE_PAIR_SWEEPS)
    print(f"timing ({card}): 3e, the same variants, {WIDE_PAIR_SWEEPS}-sweep counted window: "
          f"kernel on the dense encoding {wide_ms:.3f} ms; kernel's gather form on the all-gather "
          f"encoding {gather_ms:.3f} ms ({gather_ms / wide_ms:.3f}x the dense kernel); torch-ops "
          f"route on the all-gather encoding {ops_gather_ms:.3f} ms = "
          f"{WIDE_PAIR_SWEEPS * wsites / (ops_gather_ms / 1e3):.4e} site-samples/s "
          f"({ops_gather_ms / gather_ms:.1f}x the gather form, peak device memory "
          f"{ops_peak_gb:.2f} GB); torch-ops route on the dense encoding {ops_dense_ms:.3f} ms; "
          f"plain version {wide_plain_ms:.3f} ms", flush=True)
    record(f"gibbs_window (gather bank, {gibbs_cuda.form_name(gplan).split(',')[0]})",
           "grample_tpu/ops/gibbs_xla.py:129-141",
           of_form(*(gibbs_cuda.form_name(dataclasses.replace(gplan, count=c_))
                     for c_ in (True, False))),
           gather_errs["rule"], gather_ms, ops_gather_ms, gbound)
    del gkst
    # block width against staging: what plan_launch's width rule rests on
    shape_rows(wlabel, wkst, wstate0, wn_free, WIDE_CHAINS, WIDE_FULL_SWEEPS,
               [(256, True, True), (256, False, False), (1024, True, True),
                (1024, False, False)])
    del wkst, wstate0

    pvariants, pcaps, _ = promedus_variants(False)
    pkst, pstate0, _, pn_free = window_inputs(torch, dev, pvariants, pcaps, WIDE_CHAINS)
    plabel = (f"{WIDE_SLOTS} plain copies (oa_cap {pcaps.oa_cap}, NVp {pcaps.num_rows}) x "
              f"{WIDE_CHAINS} chains, {TIMED_SWEEPS}-sweep counted window")
    describe_launch(torch, pkst, WIDE_CHAINS, True, plabel)
    plain_copy_ms = best(kern(pkst), pstate0, TIMED_SWEEPS)
    rate_line(plabel, TIMED_SWEEPS * WIDE_CHAINS * pn_free, plain_copy_ms, None,
              window_bound(pkst, WIDE_CHAINS, TIMED_SWEEPS, True, clock_hz))
    shape_rows(f"{WIDE_SLOTS} plain copies x {WIDE_CHAINS} chains", pkst, pstate0, pn_free,
               WIDE_CHAINS, 64, [(256, True, True), (256, True, False), (256, False, False)])
    # the shape of the 5b runs' main group (2 x 8192 chains), twice and four
    # times that, in both forms: the form rule's threshold lies where they tie
    for copies in (2, 4, 8):
        small = {key: v[:copies] for key, v in pkst.items()}
        st_small = pstate0[:copies, :, :8192].contiguous()
        for name, by_site in (("thread per chain", False), ("site-parallel", True)):
            label = (f"{copies} plain copies x 8192 chains, {TIMED_SWEEPS}-sweep counted "
                     f"window, {name}")
            describe_launch(torch, small, 8192, True, label, by_site)
            rate_line(label, TIMED_SWEEPS * 8192 * pn_free * copies // WIDE_SLOTS,
                      best(kern(small, by_site), st_small, TIMED_SWEEPS, cb=hash_block(8192)))
    per_site = ((wide_full_ms / (WIDE_FULL_SWEEPS * wsites))
                / (plain_copy_ms / (TIMED_SWEEPS * WIDE_CHAINS * pn_free)))
    print(f"timing: collapse variants / plain copies, time per counted site: {per_site:.3f}",
          flush=True)
    del pkst, pstate0

    with tempfile.TemporaryDirectory() as td:
        m_plain, p_evidence = torch_models.promedus_like(discrete, seed=1)
        path = write_net(td, "promedus", m_plain, p_evidence)
        v = m_plain.num_vars
        cfg = EngineConfig(
            model_path=path, device="cuda", use_evidence=True, sampler="collapsed",
            chains=WIDE_SLOTS, chains_per_variant=WIDE_CHAINS, burnin=50 * v,
            converge_window=100 * v, max_secs=10.0, seed=SEED)
        lines = []
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = Engine(cfg, log=lines.append).run()
        torch.cuda.synchronize()
        eng_secs = time.perf_counter() - t0
        eng_launches = read_counts("5 collapsed")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(res.samples > 0 and np.isfinite(res.marginals).all() and eng_launches > 0,
          "engine run produced nothing")
    print(f"timing ({card}): engine -s collapsed -c {WIDE_SLOTS} --vchains {WIDE_CHAINS} on "
          f"the Promedus-shaped net: {res.samples_per_sec:.4e} counted site-samples/s over "
          f"{res.runtime:.2f} s of sampling clock ({eng_secs:.2f} s wall, {res.sweeps} "
          f"sweeps), collapsed vars {res.collapsed}, peak device memory {peak_gb:.2f} GB "
          f"({held_gb:.2f} GB of it held by earlier phases), "
          f"{eng_launches} kernel launches", flush=True)

    # ---- 5b. the adaptive engine on the Promedus-shaped net -----------------
    with tempfile.TemporaryDirectory() as td:
        m_plain, p_evidence = torch_models.promedus_like(discrete, seed=1)
        path = write_net(td, "promedus", m_plain, p_evidence)
        v = m_plain.num_vars
        runs = {}
        for sampler in ("adaptive", "simple"):
            cfg = EngineConfig(
                model_path=path, device="cuda", use_evidence=True, sampler=sampler,
                chains=2, chains_per_variant=8192, chain_adds=4 if sampler == "adaptive" else 1,
                burnin=50 * v, converge_window=100 * v, max_secs=float(ADAPT_SECS), seed=SEED)
            lines = []
            reset_counts()
            held_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = Engine(cfg, log=lines.append).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[sampler] = (res, wall, torch.cuda.max_memory_allocated() / 1e9,
                             read_counts(f"5b {sampler}"), "\n".join(lines))
    res, wall, peak_gb, launches_5b, log = runs["adaptive"]
    steps = adapt_secs(log)
    aux_line = [ln for ln in log.splitlines() if ln.startswith("aux group:")]
    check("split group" in log, "5b: the gate did not pick the split group")
    check(len(aux_line) == 2 and all(ln.startswith(
        f"aux group: wide tier, 8192 chains per variant, candidate bound {PAL_AUX_OA_LIM}")
        for ln in aux_line) and aux_line[0].endswith("read from the cache"),
        f"5b: the aux group is not on the wide tier with 3f's spec: {aux_line}")
    ticks_5b, sweeps_5b = (int(x) for x in re.search(
        r": (\d+) ticks, (\d+) sweeps", aux_line[1]).groups())
    check(res.samples > 0 and np.isfinite(res.marginals).all() and launches_5b > 0,
          "5b: the adaptive engine run produced nothing")
    check(len(steps) >= 1 and res.aux_secs > 0, f"5b: {len(steps)} adapt steps, aux "
          f"{res.aux_secs} s")
    print(f"timing ({card}): engine -s adaptive -c 2 --vchains 8192 -a 4 on the "
          f"Promedus-shaped net (split group chosen by the gate): {len(steps)} adapt steps, "
          f"{len(res.collapsed)} collapsed vars, {res.variants} variants; "
          f"{res.samples_per_sec:.4e} counted site-samples/s over {res.runtime:.2f} s of "
          f"sampling clock; aux {res.aux_secs:.3f} s = {res.aux_secs / res.runtime:.3f} of the "
          f"clock, {sweeps_5b / ticks_5b:.1f} aux sweeps per tick over {ticks_5b} ticks "
          f"{aux_line}; wide spec {spec_cold_secs:.3f} s of host time from a cold cache, "
          f"{spec_warm_secs:.3f} s warm (3f); host s per adapt step {[round(x, 3) for x in steps]} "
          f"(mean {np.mean(steps):.3f}); set-up {wall - res.runtime:.2f} s ({wall:.2f} s "
          f"wall); peak device memory {peak_gb:.2f} GB ({held_gb:.2f} GB of it held by earlier "
          f"phases); {launches_5b} kernel launches",
          flush=True)
    res_s, wall_s, peak_s, launches_s, _ = runs["simple"]
    check(res_s.samples > 0 and launches_s > 0, "5b: the simple engine run produced nothing")
    print(f"timing ({card}): engine -s simple -c 2 --vchains 8192 on the same net: "
          f"{res_s.samples_per_sec:.4e} counted site-samples/s over {res_s.runtime:.2f} s of "
          f"sampling clock; set-up {wall_s - res_s.runtime:.2f} s; peak device memory "
          f"{peak_s:.2f} GB; adaptive/simple rate {res.samples_per_sec / res_s.samples_per_sec:.3f}",
          flush=True)

    # ---- 4h. the single adaptive group's all-gather headroom caps -------------
    simple_marginals = res_s.marginals
    hmodel, hevidence = torch_models.promedus_like(discrete, seed=1)
    hmodel_ev, _ = torch_models.promedus_like(discrete, seed=1)
    hmodel_ev.apply_evidence(hevidence)
    v = hmodel.num_vars
    head_caps = compute_caps(hmodel_ev, collapse_headroom=True, slot_hint=128, headroom_factors=2)
    check(head_caps.base_mode == "gather" and kernel_refusal(head_caps) is None,
          f"4h: headroom caps {head_caps} are not all-gather caps the kernel takes")
    # the window of the runs' first tick: 2 plain copies x 8192 chains,
    # every form against window_ops, the rule's pick timed beside it
    hvkst, hvstate0, hvfree, hvn_free = window_inputs(torch, dev, [hmodel_ev] * 2, head_caps,
                                                      HEAD_CHAINS)
    hcb = hash_block(HEAD_CHAINS)
    head_errs = compare_window(torch, hvkst, hvstate0, hvfree, hvn_free, head_caps.num_slots,
                               HEAD_CHAINS, hcb, f"4h encoding, 2 x {HEAD_CHAINS} chains")
    hlabel = (f"the Promedus-shaped net at all-gather headroom caps (4h), 2 x {HEAD_CHAINS} "
              f"chains, {WIDE_FULL_SWEEPS}-sweep counted window")
    hplan = describe_launch(torch, hvkst, HEAD_CHAINS, True, hlabel)
    head_ms = best(kern(hvkst), hvstate0, WIDE_FULL_SWEEPS, cb=hcb)
    head_plain_ms = timed(plain(hvkst), hvstate0, WIDE_FULL_SWEEPS, cb=hcb)
    head_bound = window_bound(hvkst, HEAD_CHAINS, WIDE_FULL_SWEEPS, True, clock_hz)
    rate_line(hlabel, WIDE_FULL_SWEEPS * HEAD_CHAINS * hvn_free, head_ms, head_plain_ms,
              head_bound)
    record(f"gibbs_window (gather bank, {gibbs_cuda.form_name(hplan).split(',')[0]})",
           "grample_tpu/ops/gibbs_xla.py:129-141",
           of_form(*(gibbs_cuda.form_name(dataclasses.replace(hplan, count=c_))
                     for c_ in (True, False))),
           head_errs["rule"], head_ms, head_plain_ms, head_bound)
    del hvkst, hvstate0
    # one engine window as the 4h runs make it once adaptation has grown the
    # group (10 variants, a 5-sweep window: -w 5·V): the whole advance, the
    # state permuted into kernel order and back and the counts mapped from
    # the padded slots onto the vars, against the kernel launch inside it
    akst10, ast10, _, _ = window_inputs(torch, dev, [hmodel_ev] * 10, head_caps, HEAD_CHAINS)
    noo = akst10["pal_noo"].long()
    ast10_old = torch.gather(ast10, 1, noo[:, :, None].expand(-1, -1, HEAD_CHAINS)) \
        .transpose(1, 2).contiguous()
    halves10 = torch.zeros((10, 2, HEAD_CHAINS, v + 1, head_caps.max_card), dtype=torch.int32,
                           device=dev)
    adv_ms = best(lambda st, *a: advance_chains(akst10, st, halves10, *a), ast10_old, 5, cb=hcb)
    adv_kernel_ms = best(kern(akst10), ast10, 5, cb=hcb)
    print(f"timing ({card}): 4h, one engine window at the runs' grown shape, 10 variants x "
          f"{HEAD_CHAINS} chains, 5 sweeps counted: advance_chains {adv_ms:.3f} ms, the kernel "
          f"launch inside it {adv_kernel_ms:.3f} ms ({adv_kernel_ms / adv_ms:.3f} of it; the "
          f"rest permutes the state and maps the counts of {head_caps.num_slots} padded slots)",
          flush=True)
    del akst10, ast10, ast10_old, halves10
    rates_h = {}
    with tempfile.TemporaryDirectory() as td:
        path = write_net(td, "promedus", hmodel, hevidence)
        for how in ("--split-group off", "2x2 virtual mesh"):
            trace = os.path.join(td, "4h.t")
            reset_counts()
            held_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if how == "--split-group off":
                mar_out = os.path.join(td, "4h.MAR")
                rc, log = run_cli(cli, [
                    "sample", "-m", path, "-d", "-s", "adaptive", "-c", "2", "--vchains",
                    str(HEAD_CHAINS), "-a", "4", "-b", str(10 * v), "-w", str(5 * v), "-x",
                    str(HEAD_SECS), "-e", str(SEED), "--split-group", "off", "-t", trace,
                    "--mar-out", mar_out])
                check(rc == 0, f"4h: cli returned {rc}")
                out = summary(trace)
                marg = pad_marginals(read_mar_file(mar_out), hmodel.cards)
                collapsed_h, variants_h, rate_h, kernel_h = (
                    out["collapsed"], out["variants"], out["samples_per_sec"], out["kernel"])
            else:
                lines = []
                res_h = Engine(EngineConfig(
                    model_path=path, device="cuda", use_evidence=True, sampler="adaptive",
                    chains=2, chains_per_variant=HEAD_CHAINS, chain_adds=4, burnin=10 * v,
                    converge_window=5 * v, max_secs=float(HEAD_SECS), seed=SEED, mesh="2x2"),
                    log=lines.append, devices=[dev] * 4).run()
                log = "\n".join(lines)
                marg, collapsed_h, variants_h, rate_h, kernel_h = (
                    res_h.marginals, res_h.collapsed, res_h.variants, res_h.samples_per_sec,
                    res_h.kernel)
                check("device mesh: {'variants': 2, 'chains': 2} over 4 devices" in log,
                      "4h: no mesh line")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak_h = torch.cuda.max_memory_allocated() / 1e9
            launches_h = read_counts(f"4h {how}")
            rates_h[how] = rate_h
            steps = adapt_secs(log)
            route_line = [ln for ln in log.splitlines() if ln.startswith("sweep route:")]
            check(len(route_line) == 1 and route_line[0].startswith(
                f"sweep route: kernel, gather form (gfac_cap={head_caps.gfac_cap})"),
                f"4h, {how}: route line {route_line}")
            check("split group" not in log, f"4h, {how}: a split group")
            check(launches_h > 0 and kernel_h and not ops_windows[f"4h {how}"],
                  f"4h, {how}: {launches_h} kernel launches, ops windows "
                  f"{ops_windows[f'4h {how}']}")
            check(len(steps) >= 1 and len(collapsed_h) >= 1,
                  f"4h, {how}: {len(steps)} adapt steps, collapsed vars {collapsed_h}")
            check(marg.shape == (v, 2) and np.isfinite(marg).all(), f"4h, {how}: bad marginals")
            h_score = error_suite(marg, simple_marginals, hmodel_ev.cards, hmodel_ev.fixed, None)
            check(h_score.max_hellinger < HEAD_HELL_BOUND,
                  f"4h, {how}: max Hellinger {h_score.max_hellinger:.5f} against -s simple "
                  f">= {HEAD_HELL_BOUND}")
            print(f"4h ({card}): sample -s adaptive -c 2 --vchains {HEAD_CHAINS} -a 4 -x "
                  f"{HEAD_SECS}, {how}, on the Promedus-shaped net at all-gather headroom caps "
                  f"(gfac_cap {head_caps.gfac_cap}, group_cap {head_caps.group_cap}, scope_cap "
                  f"{head_caps.scope_cap}): {route_line[0]!r}; {secs:.1f} s wall, {len(steps)} "
                  f"adapt steps ({sum(steps):.3f} s of host time), {len(collapsed_h)} collapsed "
                  f"vars, {variants_h} variants, {rate_h:.4e} counted site-samples/s, kernel "
                  f"launches by form {path_launches[f'4h {how}']}, torch-ops windows "
                  f"{ops_windows[f'4h {how}']}, peak device memory {peak_h:.2f} GB "
                  f"({held_gb:.2f} GB of it held by earlier phases), max Hellinger against the "
                  f"{ADAPT_SECS} s -s simple run {h_score.max_hellinger:.6f} (bound "
                  f"{HEAD_HELL_BOUND}), mean {h_score.mean_hellinger:.6f}", flush=True)
    print(f"4h ({card}): counted site-samples/s, --split-group off {rates_h['--split-group off']:.4e}, "
          f"2x2 virtual mesh {rates_h['2x2 virtual mesh']:.4e}; 5b's split group "
          f"{res.samples_per_sec:.4e} and -s simple {res_s.samples_per_sec:.4e} on the same net",
          flush=True)

    # ---- 4i. -s simple on a mixed encoding ------------------------------------
    wmodel = torch_models.wide_factor(discrete, 12, seed=2)
    wide_caps = compute_caps(wmodel, headroom_factors=0)
    check(wide_caps.gfac_cap == 1 and wide_caps.adj_cap == 1,
          f"4i: caps {wide_caps} are not a mixed encoding")
    wtruth = exact_marginals(wmodel)
    with tempfile.TemporaryDirectory() as td:
        path = write_net(td, "wide12", wmodel, {}, wtruth)
        mar_out = os.path.join(td, "out.MAR")
        v = wmodel.num_vars
        reset_counts()
        t0 = time.perf_counter()
        rc, log = run_cli(cli, [
            "sample", "-m", path, "-o", "-s", "simple", "--vchains", str(GRID_CHAINS),
            "-b", str(100 * v), "-w", str(100 * v), "-i", str(3 * 100 * 2 * GRID_CHAINS * v),
            "-x", "60", "-e", str(SEED), "--mar-out", mar_out])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches_w = read_counts("4i")
        check(rc == 0 and "sweep route: kernel, gather form (gfac_cap=1)" in log,
              f"4i: cli returned {rc}, or no gather-form route line")
        check(launches_w > 0 and not ops_windows["4i"],
              f"4i: {launches_w} kernel launches, ops windows {ops_windows['4i']}")
        est = pad_marginals(read_mar_file(mar_out), wmodel.cards)
        w_score = error_suite(est, wtruth, wmodel.cards, wmodel.fixed, None)
    check(w_score.max_hellinger < HELL_BOUND,
          f"4i: max Hellinger {w_score.max_hellinger:.5f} >= {HELL_BOUND}")
    rate_w = [ln for ln in log.splitlines() if "samples/s" in ln][-1].strip()
    print(f"4i ({card}): cli sample -s simple on a 12-var factor + unaries (mixed encoding, "
          f"the kernel's gather form): {secs:.1f} s, kernel launches by form "
          f"{path_launches['4i']}, last status line {rate_w!r}, max Hellinger "
          f"{w_score.max_hellinger:.6f} (bound {HELL_BOUND})", flush=True)

    # ---- 7. the port's bench -----------------------------------------------
    from grample_tpu_torch import bench

    t7 = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory() as td:
        model = grid_model(4, 7)
        model_ev = grid_model(4, 7)
        model_ev.apply_evidence({5: 1, 10: 0})
        write_net(td, "grid4", model, {5: 1, 10: 0}, exact_marginals(model_ev))
        write_net(td, "grid10", grid_model(10, 1), {0: 1, 55: 0, 99: 1})
        # no exact marginals for the Promedus-shaped net: its .MAR is 5b's
        # 30 s -s simple run, as 4h holds its runs against it
        write_net(td, "promedus", *torch_models.promedus_like(discrete, seed=1), res_s.marginals)
        # a phase's own process reads the nets and the device from the
        # environment, a phase called here from the module
        os.environ.update(GRAMPLE_RES=td, BENCH_DEVICE="cuda")
        bench.RES, bench.DEVICE = td, "cuda"
        proc = subprocess.run(
            [sys.executable, "-m", "grample_tpu_torch.bench"], cwd=REPO, capture_output=True,
            text=True, timeout=BENCH_WALL + 60,
            env=dict(os.environ, BENCH_NETS="grid4", BENCH_WALL=str(BENCH_WALL),
                     BENCH_SECS=str(BENCH_SECS)))
        lines = proc.stdout.splitlines()
        check(proc.returncode == 0 and len(lines) == 1,
              f"7: the bench exited {proc.returncode} with {len(lines)} lines:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        line = json.loads(lines[0])
        print(f"7 ({card}): python -m grample_tpu_torch.bench, BENCH_NETS=grid4 BENCH_WALL="
              f"{BENCH_WALL} BENCH_SECS={BENCH_SECS}: {lines[0]}", flush=True)
        leg = line["detail"].get("grid4", {})
        check("skipped" not in line and "error" not in leg,
              f"7: skipped {line.get('skipped')}, error {leg.get('error')}")
        check(line["value"] and line["vs_baseline"], "7: no value or vs_baseline")
        check(leg["route"] == "kernel" and leg["launches_by_form"] and leg["kernel"],
              f"7: route {leg['route']}, launches {leg['launches_by_form']}, engine kernel "
              f"{leg['kernel']}")
        check(leg["max_hellinger"] < HELL_BOUND,
              f"7: engine leg max Hellinger {leg['max_hellinger']} >= {HELL_BOUND}")
        # the throughput leg on phase 5's shapes, in this process
        for net, num_vars, rate_5, shape_5 in (
                ("grid10", 100, TIMED_SWEEPS * GRID_CHAINS * n_free / (kernel_ms / 1e3),
                 f"2 x {GRID_CHAINS} chains, the rule's pick"),
                ("promedus", promedus.num_vars,
                 TIMED_SWEEPS * WIDE_CHAINS * pn_free / (plain_copy_ms / 1e3),
                 f"{WIDE_SLOTS} plain copies x {WIDE_CHAINS} chains")):
            leg_t = bench.phase_throughput(net, 0.0)
            check(leg_t["route"] == "kernel" and leg_t["launches_by_form"],
                  f"7, throughput {net}: {leg_t}")
            print(f"7 ({card}): throughput leg on {net}: {leg_t['device_samples_per_sec']:.4e} "
                  f"counted site-samples/s at {bench.bench_chains(num_vars, 2, bench.CHAINS)} "
                  f"chains, {leg_t['est_tops']} TOPS; phase 5's {TIMED_SWEEPS}-sweep window "
                  f"({shape_5}) {rate_5:.4e}: {leg_t['device_samples_per_sec'] / rate_5:.3f} of "
                  f"it", flush=True)
        anchor_p = bench.phase_anchor("promedus", 0.0)
        check(anchor_p.get("anchor_samples_per_sec", 0) > 0, f"7: anchor {anchor_p}")
        # an engine leg on the larger net, its wall against its budget:
        # what ENGINE_OVERHEAD stands for (its wide aux spec read from 3f's
        # cache; a first run computes it, as 3f did from a cold one)
        t0 = time.perf_counter()
        leg_e = bench.run_phase_subprocess(
            "engine", "promedus", bench.ENGINE_OVERHEAD + 2 * BENCH_SECS + 120, secs=BENCH_SECS)
        wall_e = time.perf_counter() - t0
        check("error" not in leg_e and leg_e["kernel"], f"7, engine promedus: {leg_e}")
        check(leg_e["max_hellinger"] < HEAD_HELL_BOUND,
              f"7, engine promedus: max Hellinger {leg_e['max_hellinger']} against 5b's -s "
              f"simple >= {HEAD_HELL_BOUND}")
    for key in ("GRAMPLE_RES", "BENCH_DEVICE"):
        os.environ.pop(key)
    read_counts("7")
    for form, n in leg["launches_by_form"].items():
        path_launches["7"][form] = path_launches["7"].get(form, 0) + n
    print(f"7 ({card}): anchor leg on promedus {anchor_p['anchor_samples_per_sec']:.4e} samples/s "
          f"on one core of the host ({cpu_name()}); engine leg on promedus, {BENCH_SECS} s budget: "
          f"{leg_e['engine_samples_per_sec']:.4e} counted site-samples/s, {leg_e['collapsed_vars']} "
          f"collapsed vars, max Hellinger against 5b's {ADAPT_SECS} s -s simple run "
          f"{leg_e['max_hellinger']} (bound {HEAD_HELL_BOUND}), wall {wall_e:.1f} s = budget + "
          f"{wall_e - BENCH_SECS:.1f} s with the wide aux spec cached, + "
          f"{wall_e - BENCH_SECS + spec_cold_secs:.1f} s with it computed (3f: "
          f"{spec_cold_secs:.1f} s; ENGINE_OVERHEAD {bench.ENGINE_OVERHEAD:.0f} s); launches "
          f"{path_launches['7']}; "
          f"phase 7 {time.perf_counter() - t7:.1f} s", flush=True)

    # ---- 8. the mesh on real cards -------------------------------------------
    if torch.cuda.device_count() >= 2:
        ctx.simple_marginals, ctx.rate_4h_mesh, ctx.rate_4j = (
            res_s.marginals, rates_h["2x2 virtual mesh"], res_b["samples_per_sec"])
        mesh_on_cards(ctx)
    else:
        print("8: not run: 1 card", flush=True)

    # ---- 6. results --------------------------------------------------------
    record("gibbs_window (wide tables)", "grample_tpu/ops/gibbs_pallas.py:355-367",
           of_phases("4b", "5 collapsed"), wide_err, wide_ms, wide_plain_ms, wbound)
    for name, by_form in path_launches.items():
        print(f"launches on path {name}: {by_form}"
              + (f"; torch-ops windows {ops_windows[name]}" if ops_windows[name] else ""),
              flush=True)
    for entry in kernels:
        entry["launches"] = entry["launches"](path_launches)
        check(entry["launches"] > 0, f"{entry['name']}: no launch on the main paths")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
