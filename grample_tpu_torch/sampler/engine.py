"""Run orchestration for chromatic Gibbs (``sample -s simple``,
``-s collapsed`` and ``-s adaptive``).

Counterpart of ``grample_tpu.sampler.engine`` (reference
``cmd/root.go:309-719``): load model + evidence + solutions, build (or
resume) the chain group, burn in, then loop advance → RB snapshot →
score → adapt → checkpoint under time/iteration budgets, and emit the
final report, trace records and MAR output.

``-s collapsed`` (the reference's random-collapse sampler) builds its
whole variant set up front: one random collapsible var per slot (the
same draws as the JAX package for the same seed), and caps measured on
exactly those variants (``caps_for_variants``).

``-s adaptive`` (the kelly19a estimator) adds collapse variants of the
worst-converged vars during the first half of the budget
(``sampler/adaptive.py``).  It runs one ``ChainGroup`` on collapse-headroom
caps where the sweep kernel takes them, else a ``SplitChainGroup``
(``_want_split``, the reference's question: does the dense-bank kernel
take the plain caps and not the headroom caps).  Under a mesh or
``split_group="off"`` it is one group whatever its caps: the gather bank
of a Promedus-shaped net's headroom caps sweeps on the kernel's gather
form, and what the kernel's gate refuses (cards above 16, rows beyond
shared memory) as torch ops (``ops.gibbs_bank``); the engine logs either
route with its reason.

Reference flag units are single-site samples; the engine works in
*sweeps* (one sweep resamples every free variable once): ``burnin``
samples ≈ ``burnin / V`` sweeps, and the default burnin 2000·V gives
2000 sweeps.

``mesh`` shards the chains over several GPUs (``parallel.mesh``); a split
group is not used under a mesh.  With ``distributed`` the mesh spans the
devices of every rank of a ``torch.distributed`` process group
(``parallel.distributed``), and every rank runs this engine on its own
shards.  The ranks then make the same group calls in the same order:
what the engine decides from reduced data (adapt targets, the sample
cap, the reserve) comes out the same on every rank, and what it decides
from a clock (the seed of ``--seed 0``, windows per tick, the budget's
end, status ticks, the end of adaptation with its compensation, the
checkpoint cadence, the runtime reported) is read on rank 0 and
broadcast once per tick (``from_main``).  Rank 0 alone writes the trace,
the MAR and the checkpoints (``sampler.checkpoint``) and logs; the other
ranks log only their adapt steps, which must agree with rank 0's.  Every
rank reads a checkpoint it resumes from, so the file must be visible to
every host.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from grample_tpu_torch.metrics import ErrorSuite, error_suite
from grample_tpu_torch.metrics.divergences import pad_marginals
from grample_tpu_torch.pgm.discrete import DiscreteModel, norm_marginals
from grample_tpu_torch.ops.sweep import kernel_refusal
from grample_tpu_torch.parallel import distributed
from grample_tpu_torch.pgm.encode import (
    COLLAPSE_OA_DENSE_CAP,
    caps_for_variants,
    compute_caps,
    encode_model,
)
from grample_tpu_torch.sampler import checkpoint
from grample_tpu_torch.sampler.adaptive import adapt_step
from grample_tpu_torch.sampler.chains import MAX_VARIANTS, ChainGroup
from grample_tpu_torch.sampler.collapse import collapse_var, pick_random_collapsible
from grample_tpu_torch.sampler.split import SplitChainGroup
from grample_tpu_torch.tracing import Tracer, clock
from grample_tpu_torch.uai import load_model, read_mar_file

#: Max seconds of batched device work per engine tick (see the nwin
#: computation): bounds the scoring/adapt/RB cadence when status output
#: is quiet.
TICK_WORK_SECS = 30.0

#: Tick budget while adaptation is live: shorter ticks give more adapt
#: rounds inside the half-budget adapt window (the reference adapts at its
#: ~5 s scoring cadence, cmd/root.go:498-547).
ADAPT_TICK_WORK_SECS = 10.0

SAMPLERS = ("simple", "collapsed", "adaptive")


@dataclasses.dataclass
class EngineConfig:
    model_path: str
    device: str = "cuda"
    use_evidence: bool = False
    use_solution: bool = False
    sampler: str = "simple"  # simple | collapsed | adaptive
    burnin: int = -1  # single-site samples; <0 → 2000·V (2000 sweeps)
    converge_window: int = 0  # single-site samples; <=0 → burnin
    chains: int = 0  # logical chains (variant slots); <=0 → 2
    chains_per_variant: int = 64  # micro-chains per slot
    chain_adds: int = 1  # new chains per adapt step (adaptive only)
    max_iters: int = 0  # site updates; 0 = unlimited, <0 → 20000·V
    max_secs: float = 300.0
    # "sampling": max_secs bounds the clock from after the first kernel
    # launch (build, first launch and the aux group's build excluded, and
    # adapt steps' host time beyond 0.5 s each compensated); "wall": the
    # reference's literal contract, max_secs bounds wall clock from start
    budget: str = "sampling"
    seed: int = 0  # <1 → wall clock
    measure: str = "hellinger"
    adapt_policy: str = "worst"  # worst | ref-tail
    warm_start: bool = True
    # tempered burn-in stages (0 = plain uniform-init burn, the
    # reference-faithful quench; see ChainGroup.burn_annealed)
    anneal_stages: int = 20
    # Rao-Blackwell mixture estimator for collapsed vars (False = the
    # reference's static collapse-time marginal; see rb_accumulate)
    rb_mixture: bool = True
    trace_path: str = ""
    experiment: bool = False
    verbose: bool = False
    status_secs: float = 5.0
    mar_out: str = ""  # write final MAR solution here
    checkpoint_path: str = ""
    checkpoint_secs: float = 60.0
    resume: bool = False
    max_variants: int = MAX_VARIANTS
    # pre-size variant slots (0 = just the starting chains, or for
    # adaptive runs max_variants when their footprint is small)
    reserve_slots: int = 0
    # split execution for adaptive runs: "auto" = a SplitChainGroup when
    # the sweep takes the plain caps but refuses the collapse-headroom
    # caps (see _want_split); "on"/"off" force it.  Ignored under a mesh.
    split_group: str = "auto"
    # device mesh: "off" = one device; "auto" = shard over every GPU when
    # there are several; "VxC" (e.g. "2x4") = an explicit (variants,
    # chains) grid, which needs V*C devices
    mesh: str = "off"
    # run as one rank of a torch.distributed process group (joined first,
    # ``parallel.distributed.init_distributed``): the mesh takes the
    # devices of every rank; needs a mesh
    distributed: bool = False

    def resolve_seed(self) -> int:
        if self.seed >= 1:
            return self.seed
        t = time.localtime()
        return int(t.tm_sec + t.tm_min + time.time_ns() % 1_000_000_007)


@dataclasses.dataclass
class RunResult:
    marginals: np.ndarray  # [V, K] normalized final estimate
    model: DiscreteModel
    samples: int
    sweeps: int
    runtime: float
    chains: int
    variants: int
    collapsed: List[int]
    final_score: Optional[ErrorSuite] = None
    merlin_score: Optional[ErrorSuite] = None
    score_vs_merlin: Optional[ErrorSuite] = None
    convergence: Optional[Dict[str, np.ndarray]] = None
    samples_per_sec: float = 0.0
    aux_secs: float = 0.0  # split execution: the ``tick.aux`` spans' total
    # throughput path on the kernel route (the CUDA kernel on a card, its
    # plain version on the CPU), not the torch-ops route
    kernel: bool = False
    # the run's tracer (``grample_tpu_torch.tracing``): per span name
    # {n, total_s, self_s, max_s}; its counters (``sites.main``,
    # ``sites.aux``: the site updates each group claims, this process's
    # run; ``sites.folded``: those that reached the host totals); its raw
    # events
    spans: Dict[str, dict] = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)
    # the sampling clock's anchor, in ns on the tracer's clock
    # (``perf_counter_ns``), and the unix clock's lead over it (read at
    # the first sync): ``clock_start + wall_offset_ns`` is the anchor on
    # the unix clock of a ``torch.profiler`` trace
    clock_start: int = 0
    wall_offset_ns: int = 0


class Engine:
    """One marginal-estimation run."""

    def __init__(
        self,
        cfg: EngineConfig,
        log: Callable[[str], None] = print,
        monitor=None,
        devices=None,
    ):
        """``devices`` names the mesh's devices explicitly; one device may
        be named several times (a virtual mesh, see ``parallel.mesh``)."""
        if cfg.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler: {cfg.sampler}")
        if cfg.sampler != "adaptive" and cfg.chain_adds != 1:
            raise ValueError(
                f"sampler is not adaptive: chain_adds={cfg.chain_adds} makes no sense")
        if cfg.split_group not in ("auto", "on", "off"):
            raise ValueError(f"unknown split_group {cfg.split_group!r}")
        if cfg.budget not in ("sampling", "wall"):
            raise ValueError(f"unknown budget mode {cfg.budget!r}")
        if cfg.experiment and not cfg.trace_path:
            raise ValueError("experiment mode requires a trace file")
        if cfg.mesh not in ("", "off", "auto"):
            vways, _, cways = cfg.mesh.partition("x")
            if not (vways.isdigit() and cways.isdigit() and int(vways) and int(cways)):
                raise ValueError(f"unknown mesh {cfg.mesh!r}: off | auto | VxC")
        if cfg.distributed and cfg.mesh in ("", "off"):
            # the reference runs one group per rank here, each writing
            # the same files
            raise ValueError("--distributed needs a device mesh (--mesh auto or VxC): under "
                             "--mesh off every rank would run a group of its own")
        self.cfg = cfg
        self.log = log
        self.monitor = monitor
        self.devices = devices
        self.trace_fh = None
        self._routes_logged = set()  # route lines already logged

    def trace(self, line: str):
        if self.trace_fh:
            self.trace_fh.write(line + "\n")
            self.trace_fh.flush()

    # ------------------------------------------------------------------
    def run(self) -> RunResult:
        if self.cfg.distributed and not torch.distributed.is_initialized():
            raise RuntimeError("a distributed run needs its process group: call "
                               "parallel.distributed.init_distributed() first")
        if not self._main():
            self.log = _adapt_lines(self.log)
        elif self.cfg.trace_path:
            self.trace_fh = open(self.cfg.trace_path, "w")
        try:
            return self._run()
        finally:
            if self.trace_fh:
                self.trace_fh.close()
                self.trace_fh = None

    def _run(self) -> RunResult:
        cfg = self.cfg
        tr = Tracer()
        setup = tr.span("setup")  # ends at the sampling clock's anchor
        t_start = setup.start_ns / 1e9

        load = tr.span("setup.load")
        self.log(f"Reading model from {cfg.model_path}")
        model = load_model(cfg.model_path, use_evidence=cfg.use_evidence)
        v = model.num_vars
        self.log(f"Model has {v} vars and {len(model.factors)} functions")

        solution = None
        merlin = None
        if cfg.use_solution:
            solution = pad_marginals(read_mar_file(cfg.model_path + ".MAR"), model.cards)
            start = error_suite(model.marginals, solution, model.cards, model.fixed, None)
            self.log(f"START {start}")
            if cfg.verbose:
                self.log(start.report())
            mer_path = cfg.model_path + ".merlin.MAR"
            if os.path.exists(mer_path):
                merlin = pad_marginals(read_mar_file(mer_path), model.cards)
        load.end()

        # ---- derived defaults (reference cmd/root.go:344-363) ----------
        seed = int(self._agreed([cfg.resolve_seed()])[0])
        burn_sweeps = 2000 if cfg.burnin < 0 else max(0, math.ceil(cfg.burnin / v))
        cw_sweeps = (
            burn_sweeps if cfg.converge_window <= 0
            else max(2, math.ceil(cfg.converge_window / v))
        )
        cw_sweeps = max(2, cw_sweeps)
        n_slots = cfg.chains if cfg.chains > 0 else 2
        n_slots = max(2 if cfg.sampler == "adaptive" else 1, n_slots)
        # negative maxiters derives 20000·|vars|; 0 means unlimited
        max_iters = 20000 * v if cfg.max_iters < 0 else cfg.max_iters

        self.log(
            f"sampler={cfg.sampler} seed={seed} burnin={burn_sweeps} sweeps "
            f"cwin={cw_sweeps} sweeps chains={n_slots}x{cfg.chains_per_variant} "
            f"maxsecs={cfg.max_secs} maxiters={max_iters} device={cfg.device}"
        )

        adaptive = cfg.sampler == "adaptive"
        prior_runtime = 0.0
        resume = cfg.resume and cfg.checkpoint_path and self._agreed(
            [os.path.exists(cfg.checkpoint_path)])[0]
        build = tr.span("setup.build")
        if resume:
            group, meta = checkpoint.load_checkpoint(
                cfg.checkpoint_path, model, make_group=self._resume_factory(cfg),
                device=cfg.device)
            group.tracer = tr
            cw_sweeps = group.cw
            prior_runtime = float(meta.get("runtime", 0.0))
            self.log(
                f"RESUMED from {cfg.checkpoint_path}: {group.num_variants} "
                f"chains, {group.total_samples:,} samples, "
                f"{group.total_sweeps} sweeps, {prior_runtime:.1f}s spent"
            )
            # the aux group is still to be built when the snapshot predates
            # the first collapse: build it before the clock, as a fresh run
            # does, not on the clock at the first adapt step
            prewarm = prior_runtime < cfg.max_secs / 2
        else:
            variants = [model] * n_slots
            caps = None
            if cfg.sampler == "collapsed":
                variants = self._collapse_variants(model, n_slots, seed)
                caps = caps_for_variants(variants, slot_hint=n_slots)
            group = self._group_factory(cfg)(
                model, chains_per_variant=cfg.chains_per_variant,
                converge_window=cw_sweeps, seed=seed, caps=caps,
                collapse_headroom=adaptive, rb_mixture=cfg.rb_mixture,
            )
            group.tracer = tr
            self.log(f"Creating chains and performing burn-in ({burn_sweeps} sweeps)")
            reserve = max(n_slots, cfg.reserve_slots)
            if adaptive and cfg.reserve_slots == 0:
                # reserve every slot up front when the footprint is small:
                # each pow2 slot growth otherwise restacks on the clock
                reserve = max(reserve, self._auto_reserve(cfg, group))
            group.reserve(reserve)
            group.add_variants(variants)
            prewarm = True
        self._log_route(group)
        build.end()
        with tr.span("setup.warmup"):
            group.warmup()  # wall mode: the first launch runs ON the clock
        tr.calibrate()
        if adaptive and isinstance(group, SplitChainGroup) and prewarm:
            # the aux group's build and first launch, before the sampling
            # clock anchors (wall mode keeps it on the clock)
            with tr.span("setup.aux"):
                group.prewarm_aux()
                self._log_aux(group)
        setup.end()
        clock_start = setup.end_ns if cfg.budget == "sampling" else setup.start_ns
        t_clock = clock_start / 1e9
        if not resume:
            if cfg.anneal_stages > 0:
                group.burn_annealed(burn_sweeps, cfg.anneal_stages)
            else:
                group.burn(burn_sweeps)

        if self.monitor:
            self.monitor.update(
                burnin=burn_sweeps, cwin=cw_sweeps, chains=group.num_chains,
                variants=group.num_variants, maxsecs=cfg.max_secs,
            )

        if cfg.experiment:
            self.trace("// EXPERIMENT RESULTS")
            self.trace("RunSecs, MaxHell, NegLogMaxHell, MaxJS, NegLogMaxJS, CollapseCount")

        # ---- main loop --------------------------------------------------
        # budgets anchor at t_clock (burn-in included, as the reference)
        # and continue across a resume: the prior runtime is spent
        stop_time = t_clock + max(0.0, cfg.max_secs - prior_runtime)
        next_status = t_clock + cfg.status_secs / 2
        no_adapt_time = t_clock + max(0.0, cfg.max_secs / 2 - prior_runtime)
        next_checkpoint = t_clock + cfg.checkpoint_secs
        keep_adapting = adaptive
        keep_working = True
        score = None
        # budget-clock compensation for adapt steps' host time (see below),
        # bounded so the run cannot pass about twice its budget
        comp_left = 0.0 if cfg.budget == "wall" else max(60.0, cfg.max_secs)
        win_time = None  # EMA: measured seconds per counted window
        nwin = 1
        while keep_working:
            tr.tick += 1
            tick_span = tr.span("tick")
            # Launch a BATCH of windows with deferred count deltas (no host
            # sync between windows), sized so one batch ≈ the status
            # cadence (the reference's ~5 s scoring loop,
            # cmd/root.go:498-539).
            with tr.span("tick.launch") as launch:
                for _ in range(nwin):
                    group.advance(cw_sweeps, defer=True)
            with tr.span("tick.flush"):
                group.flush()
            now = clock()
            dt = (now - launch.start_ns / 1e9) / nwin
            win_time = dt if win_time is None else 0.5 * win_time + 0.5 * dt
            # Every decision read from a clock is rank 0's: the ranks act on
            # its readings, never on their own (one broadcast a tick).  The
            # next batch is sized here, before this tick's adapt step, whose
            # host time the budget's compensation gives back.
            adapt_over = keep_adapting and now > no_adapt_time
            budget = min(cfg.status_secs,
                         ADAPT_TICK_WORK_SECS if keep_adapting and not adapt_over
                         else TICK_WORK_SECS,
                         max(stop_time - now, 0.25))
            tick = self._agreed([
                now - t_clock, cfg.max_secs > 0 and now > stop_time, now > next_status,
                adapt_over, bool(cfg.checkpoint_path) and now > next_checkpoint,
                max(1, min(1024, int(budget / max(win_time, 1e-4))))])
            runtime = float(tick[0])
            out_of_time, status_due, adapt_over, checkpoint_due = (bool(x) for x in tick[1:5])
            nwin = int(tick[5])
            if out_of_time:
                keep_working = False
            if max_iters > 0 and group.total_samples > max_iters:
                keep_working = False

            # RB mixture snapshot: one per tick; ticks are a window or more
            # apart, so chain states are decorrelated between snapshots
            with tr.span("tick.rb"):
                group.rb_accumulate()

            if status_due or not keep_working or cfg.experiment:
                if status_due or not keep_working:
                    rate = group.total_samples / max(runtime, 1e-9)
                    self.log(
                        f"  Samps: {group.total_samples:>14,d} | RT {runtime:10.2f}s"
                        f" | {rate:,.0f} samples/s | chains {group.num_chains}"
                    )
                if solution is not None:
                    merged = group.merged_marginals()
                    score = error_suite(merged, solution, model.cards, model.fixed, None)
                    if status_due or not keep_working:
                        self.log(score.report() if cfg.verbose else f"    {score}")
                    if cfg.experiment:
                        ncol = int(group.collapsed_any().sum())
                        self.trace(
                            f"{runtime:.1f}, {score.max_hellinger:.8f}, "
                            f"{_neglog2(score.max_hellinger):.5f}, {score.max_js:.8f}, "
                            f"{_neglog2(score.max_js):.5f}, {ncol}"
                        )
                if self.monitor:
                    self.monitor.update(
                        iterations=group.total_samples, runtime=now - t_start,
                        chains=group.num_chains, variants=group.num_variants,
                        **(_score_vars(score) if score else {}), **tr.counters,
                    )
                if status_due:
                    next_status = now + cfg.status_secs

            if adapt_over:
                self.log("STOPPING ADAPTATION")
                keep_adapting = False
            if keep_working and keep_adapting:
                with tr.span("tick.adapt") as step:
                    added = adapt_step(group, cfg.chain_adds, measure=cfg.measure,
                                       policy=cfg.adapt_policy, warm_start=cfg.warm_start)
                if added:
                    # an adapt step's host work (collapse, encode, stacking,
                    # the new slots' burn) costs the reference milliseconds
                    # (cmd/root.go:542-547): under --budget sampling the
                    # clock is extended by its time beyond 0.5 s
                    dt = step.seconds
                    comp = min(comp_left, max(0.0, dt - 0.5))
                    comp_left -= comp
                    stop_time += comp
                    no_adapt_time += comp
                    self.log(
                        f"ADAPT: {group.num_variants} chains "
                        f"(+{len(added)}: collapsed vars {added}) in {dt:.3f} s"
                    )
                    self._log_route(group)  # grown caps may leave the kernel's gate

            if checkpoint_due:
                self.save_checkpoint(group, prior_runtime + (clock() - t_clock))
                next_checkpoint = clock() + cfg.checkpoint_secs
            tick_span.end()

        # ---- final ------------------------------------------------------
        runtime = float(self._agreed([clock() - t_clock])[0])
        if isinstance(group, SplitChainGroup) and group.aux_ticks:
            self.log(
                f"aux group: {self._aux_shape(group)}: {group.aux_ticks} ticks, "
                f"{group.aux_tick_sweeps} sweeps "
                f"({group.aux_tick_sweeps / group.aux_ticks:.1f} per tick), "
                f"{group.aux_secs:.3f} s")
        merged = group.merged_marginals()
        final = norm_marginals(merged, model.cards)
        self.log("DONE")

        result = RunResult(
            marginals=final,
            model=model,
            samples=group.total_samples,
            sweeps=group.total_sweeps,
            runtime=runtime,
            chains=group.num_chains,
            variants=group.num_variants,
            collapsed=sorted(int(x) for x in np.nonzero(group.collapsed_any())[0]),
            samples_per_sec=group.total_samples / max(runtime, 1e-9),
            aux_secs=tr.total("tick.aux"),
            kernel=group.route == "kernel",
            spans=tr.spans(),
            counters=dict(tr.counters),
            events=tr.events,
            clock_start=clock_start,
            wall_offset_ns=tr.wall_offset_ns,
        )

        if solution is not None:
            result.final_score = error_suite(final, solution, model.cards, model.fixed, None)
            self.log(f"FINAL {result.final_score}")
            self.log(result.final_score.report())
            if merlin is not None:
                result.merlin_score = error_suite(merlin, solution, model.cards, model.fixed, None)
                self.log(f"MERLIN SCORE {result.merlin_score}")
                result.score_vs_merlin = error_suite(final, merlin, model.cards, model.fixed, None)
                self.log(f"OUR SCORE USING MERLIN AS SOLUTION {result.score_vs_merlin}")

        result.convergence = {
            meas: group.convergence(measure=meas)
            for meas in ("hellinger", "js", "maxabs", "meanabs")
        }

        if cfg.verbose:
            # reference --verbose: per-variable final summaries
            # (cmd/root.go:677-685)
            for i in range(v):
                kind = "EVID" if model.fixed[i] >= 0 else "est"
                self.log(
                    f"Variable[{i}] {model.var_name(i)} (Card:{int(model.cards[i])}, "
                    f"{kind}) {np.round(result.marginals[i, :int(model.cards[i])], 6)}"
                )

        self._final_trace(result, solution, merlin)

        if cfg.mar_out and self._main():
            from grample_tpu_torch.uai.writer import write_mar

            mars = [final[i, : model.cards[i]] for i in range(v)]
            with open(cfg.mar_out, "w") as fh:
                fh.write(write_mar(mars))
            self.log(f"Wrote MAR solution to {cfg.mar_out}")
        return result

    def _main(self) -> bool:
        """Whether this process writes the run's files and logs: always,
        unless it is a rank other than 0 of a ``distributed`` run."""
        return not self.cfg.distributed or distributed.is_main()

    def _agreed(self, values) -> np.ndarray:
        """``values`` (a short float vector) as rank 0 read them, under
        ``distributed``; else this process's own."""
        if self.cfg.distributed:
            return distributed.from_main(values)
        return np.asarray(values, dtype=np.float64)

    def _collapse_variants(self, model: DiscreteModel, n_slots: int,
                           seed: int) -> List[DiscreteModel]:
        """One variant per slot, each with one random collapsible var
        collapsed (the base model where none is left), drawn as the
        reference's prebuild loop draws them (``engine.py:230-242``)."""
        rng = np.random.default_rng(seed)
        variants = []
        for slot in range(n_slots):
            var = pick_random_collapsible(model, rng, oa_cap=COLLAPSE_OA_DENSE_CAP)
            if var is None:
                variants.append(model)
                continue
            variant, exact = collapse_var(model, var)
            self.log(f" ... chain {slot + 1}: collapsed var {var} "
                     f"marginal={np.round(exact, 4)}")
            variants.append(variant)
        return variants

    # ------------------------------------------------------------------
    def _final_trace(self, result: RunResult, solution, merlin):
        """Per-variable JSON trace records (reference cmd/root.go:656-716)."""
        if not self.trace_fh:
            return
        from grample_tpu_torch.metrics.divergences import (
            hellinger,
            js_divergence,
            max_abs_diff,
            mean_abs_diff,
        )

        model = result.model
        conv = result.convergence
        # evidence-fixed vars contribute zero to every per-var error
        # record (reference ErrorSuite, model/error.go:44-49)
        err = None
        if solution is not None:
            err = {
                "Hell-Error": hellinger(result.marginals, solution, model.cards, model.fixed),
                "JS-Error": js_divergence(result.marginals, solution, model.cards, model.fixed),
                "MaxAD-Error": max_abs_diff(result.marginals, solution, model.cards, model.fixed),
                "AvgAD-Error": mean_abs_diff(result.marginals, solution, model.cards, model.fixed),
            }
        mer_hell = None
        if merlin is not None:
            mer_hell = hellinger(result.marginals, merlin, model.cards, model.fixed)

        def var_record(i: int, with_merlin: bool = False) -> dict:
            card = int(model.cards[i])
            rec = {
                "ID": i,
                "Name": model.var_name(i),
                "Card": card,
                "FixedVal": int(model.fixed[i]),
                "Collapsed": bool(i in result.collapsed),
                "Marginal": [float(x) for x in result.marginals[i, :card]],
                "State": {
                    "Hell-Convergence": float(conv["hellinger"][i]),
                    "JS-Convergence": float(conv["js"][i]),
                    "MaxAD-Convergence": float(conv["maxabs"][i]),
                    "AvgAD-Convergence": float(conv["meanabs"][i]),
                },
            }
            if solution is not None:
                for c in range(card):
                    rec["State"][f"SOL-MAR[{c}]"] = float(solution[i, c])
                for name, vals in err.items():
                    rec["State"][name] = float(vals[i])
            if with_merlin and mer_hell is not None:
                rec["State"]["MerlinHellError"] = float(mer_hell[i])
            return rec

        self.trace("// EVIDENCE")
        for i in range(model.num_vars):
            if model.fixed[i] >= 0:
                self.trace(json.dumps(var_record(i)))
        self.trace("// VARS (ESTIMATED)")
        for i in range(model.num_vars):
            if model.fixed[i] < 0:
                self.trace(json.dumps(var_record(i)))
        if mer_hell is not None:
            # reference cmd/root.go:689-709: estimated vars ranked by
            # Hellinger distance from the merlin solution
            order = sorted(
                (i for i in range(model.num_vars) if model.fixed[i] < 0),
                key=lambda i: mer_hell[i],
            )
            self.trace("// VARS SORTED BY DIST FROM HELLINGER")
            for i in order:
                self.trace(json.dumps(var_record(i, with_merlin=True)))
        self.trace("// OPERATING PARAMS")
        self.trace(json.dumps(dataclasses.asdict(self.cfg)))
        self.trace("// RESULT SUMMARY")
        self.trace(
            json.dumps(
                {
                    "samples": result.samples,
                    "sweeps": result.sweeps,
                    "runtime": result.runtime,
                    "chains": result.chains,
                    "variants": result.variants,
                    "collapsed": result.collapsed,
                    "samples_per_sec": result.samples_per_sec,
                    "aux_secs": result.aux_secs,
                    "kernel": result.kernel,
                    "spans": result.spans,
                    "counters": result.counters,
                    "final_score": result.final_score.as_dict() if result.final_score else None,
                }
            )
        )
        # reference cmd/root.go:714-716: the whole model (factor tables
        # excluded from JSON, matching model/model.go:28)
        self.trace("// ENTIRE MODEL")
        self.trace(
            json.dumps(
                {
                    "Type": model.type,
                    "Name": model.name,
                    "Vars": [var_record(i) for i in range(model.num_vars)],
                }
            )
        )

    # ------------------------------------------------------------------
    def _group_factory(self, cfg: EngineConfig):
        """Factory for fresh runs and resume: a ``ShardedChainGroup`` under
        a mesh (reference ``engine.py:603-641``), else a ``SplitChainGroup``
        for adaptive runs that ``_want_split``, else a ``ChainGroup``.  The
        caller's keywords (the shapes a resume restores) win."""

        def make(model, **kw):
            kw.setdefault("max_variants", cfg.max_variants)
            kw.setdefault("device", cfg.device)
            mesh = self._mesh(cfg)
            if mesh is not None:
                from grample_tpu_torch.parallel.mesh import ShardedChainGroup

                self.log(f"device mesh: {mesh.shape} over {mesh.size} devices"
                         + ("" if mesh.ranks is None else f" of {distributed.world()} ranks")
                         + "; this process: "
                         + (", ".join(map(str, mesh.local_devices())) or "none"))
                return ShardedChainGroup(model, mesh=mesh, **kw)
            if cfg.sampler == "adaptive" and self._want_split(cfg, model):
                self.log("split group: plain slots on plain caps + "
                         "collapse slots on aux caps")
                kw.pop("caps", None)
                return SplitChainGroup(model, **kw)
            return ChainGroup(model, **kw)

        return make

    def _mesh(self, cfg: EngineConfig):
        """The device mesh ``cfg.mesh`` asks for, or None: ``auto`` shards
        when there are several devices, ``VxC`` needs V*C of them.  The
        devices are the engine's explicit list, else every GPU, else (for
        a CPU run) the one CPU; under ``distributed`` those of every rank,
        in rank order."""
        if cfg.mesh in ("", "off"):
            return None
        from grample_tpu_torch.parallel.mesh import chain_mesh

        devices = self.devices
        if devices is None and torch.device(cfg.device).type != "cuda":
            devices = [cfg.device]
        ranks = None
        if cfg.distributed:
            if devices is None:
                devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            devices, ranks = distributed.world_devices(devices)
        if cfg.mesh == "auto":
            n = torch.cuda.device_count() if devices is None else len(devices)
            return chain_mesh(devices=devices, ranks=ranks) if n > 1 else None
        vways, _, cways = cfg.mesh.partition("x")
        return chain_mesh(n_devices=int(vways) * int(cways), variant_ways=int(vways),
                          devices=devices, ranks=ranks)

    def _resume_factory(self, cfg: EngineConfig):
        """Factory for a resumed non-split snapshot.  A ``-s collapsed``
        snapshot's variant set is fixed, so its group takes caps measured
        on those variants (``caps_for_variants``), as the fresh run did:
        collapse-headroom caps, which the reference rebuilds, need not
        pass the sweep's gate on wide nets."""
        if cfg.sampler != "collapsed":
            return self._group_factory(cfg)
        variants = checkpoint.snapshot_variants(checkpoint.read_meta(cfg.checkpoint_path))

        def make(model, **kw):
            kw["caps"] = caps_for_variants(variants, slot_hint=len(variants))
            kw["collapse_headroom"] = False
            return self._group_factory(cfg)(model, **kw)

        return make

    @staticmethod
    def _auto_reserve(cfg: EngineConfig, group) -> int:
        """Slots to pre-reserve for an adaptive run: ``max_variants`` when
        the full-capacity footprint (encodings + state + window halves)
        fits in 1 GiB, else 0 (lazy pow2 growth).  A split group sizes its
        own reserve (reference ``engine.py:643-666``)."""
        if isinstance(group, SplitChainGroup):
            return 0
        enc = encode_model(group.base, group.caps)
        enc_bytes = sum(np.asarray(a).nbytes for a in enc.arrays().values())
        cpv, v1, k = group.cpv, group.v1, group.kdim
        per_slot = enc_bytes + cpv * v1 * 4 + 2 * cpv * v1 * k * 4
        return cfg.max_variants if per_slot * cfg.max_variants <= (1 << 30) else 0

    @staticmethod
    def _aux_shape(group: SplitChainGroup) -> str:
        """A split group's aux tier, chains per variant and candidate bound."""
        return (f"{group.aux_tier} tier, {group.aux_cpv} chains per variant, "
                f"candidate bound {group.collapse_oa_cap}")

    def _log_aux(self, group: SplitChainGroup) -> None:
        """The aux tier, and the host seconds of the wide spec where this
        process looked for one (a CUDA device), with where they came from."""
        line = f"aux group: {self._aux_shape(group)}"
        if group.aux_spec_secs is not None:
            line += (f"; wide spec {'found' if group.aux_tier == 'wide' else 'none'}, "
                     f"{group.aux_spec_secs:.3f} s of host time, "
                     + ("read from the cache" if group.aux_spec_cached else "computed"))
        self.log(line)

    def _log_route(self, group) -> None:
        """One line for every group (a split group's main and aux) whose
        sweep is not the dense-bank kernel: the torch-ops route with the
        kernel gate's reason, or the kernel's gather form (on the CPU its
        plain version, ``window_ops``); each line once."""
        for g in (getattr(group, "main", group), getattr(group, "aux", None)):
            if g is None:
                continue
            if g.route == "ops":
                line = f"sweep route: torch ops on {g.device} ({kernel_refusal(g.caps)})"
            elif g.caps.gfac_cap > 0:
                line = (f"sweep route: kernel, gather form (gfac_cap={g.caps.gfac_cap}) on "
                        f"{g.device}" + (", as its plain version window_ops"
                                         if torch.device(g.device).type == "cpu" else ""))
            else:
                continue
            if line not in self._routes_logged:
                self._routes_logged.add(line)
                self.log(line)

    @staticmethod
    def _want_split(cfg: EngineConfig, model) -> bool:
        """Split execution when the model's plain caps are dense-bank caps
        the sweep kernel takes and its collapse-headroom caps are not: the
        question the reference asks its kernel's ``pallas_eligible``
        (``engine.py:668-684``), which refuses the gather bank.  The
        port's kernel also walks the gather bank, but a split group keeps
        every slot on dense tables, as the reference chooses.
        ``split_group`` "on"/"off" overrides."""
        if cfg.split_group != "auto":
            return cfg.split_group == "on"

        def dense_kernel(caps) -> bool:
            return caps.gfac_cap == 0 and kernel_refusal(caps) is None

        plain = compute_caps(model, headroom_factors=0)
        head = compute_caps(model, collapse_headroom=True,
                            slot_hint=cfg.max_variants, headroom_factors=2)
        return dense_kernel(plain) and not dense_kernel(head)

    def save_checkpoint(self, group, runtime: float = 0.0):
        checkpoint.save_checkpoint(self.cfg.checkpoint_path, group, self.cfg,
                                   runtime=runtime)
        self.log(f"checkpoint -> {self.cfg.checkpoint_path}")


def _adapt_lines(log: Callable[[str], None]) -> Callable[[str], None]:
    """A rank's log other than rank 0's: its adapt steps only, the
    decisions every rank takes and that must agree."""
    return lambda line: line.startswith("ADAPT: ") and log(line)


def _neglog2(x: float) -> float:
    return -math.log2(max(x, 1e-300))


def _score_vars(score: ErrorSuite) -> dict:
    return {
        "mean_hellinger": score.mean_hellinger,
        "max_hellinger": score.max_hellinger,
        "mean_js": score.mean_js,
        "max_js": score.max_js,
    }
