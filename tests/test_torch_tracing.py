"""The port's tracer (``grample_tpu_torch.tracing``) and its spans and
counters inside the engine, on the CPU: nesting, self time and the event
cap; engine runs of each sampler on a 3x3 grid with every span where the
work happens; the site updates folded into the estimate against those
claimed, also on a 2x2 virtual mesh and with one shard's counts left out;
the adapt step's parts against its ``ADAPT`` line; the split group's aux
seconds and the operator's exporters.  The file imports no JAX."""

import json
import subprocess
import sys
import types

import pytest
import torch

import grample_tpu_torch.pgm.discrete as port_pgm
from grample_tpu_torch import tracing
from grample_tpu_torch.ops import gibbs_cuda
from grample_tpu_torch.parallel.mesh import ShardedChainGroup, chain_mesh
from grample_tpu_torch.pgm.encode import compute_caps
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.tracing import Tracer
from grample_tpu_torch.uai.writer import write_model

from tests import torch_models

#: the parent every engine span must have, by name
PARENT = {
    "setup.load": "setup", "setup.build": "setup", "setup.warmup": "setup",
    "setup.aux": "setup", "setup.aux.spec": "setup.aux",
    "tick.launch": "tick", "tick.flush": "tick", "tick.rb": "tick", "tick.adapt": "tick",
    "tick.aux": "tick.flush",
    "adapt.rank": "tick.adapt", "adapt.collapse": "tick.adapt", "adapt.place": "tick.adapt",
    "adapt.burn": "adapt.place",
}
#: the spans of a run of each kind on the CPU (no wide aux spec there)
SIMPLE = {"setup", "setup.load", "setup.build", "setup.warmup", "tick", "tick.launch",
          "tick.flush", "tick.rb"}
ADAPTIVE = SIMPLE | {"tick.adapt", "adapt.rank", "adapt.collapse", "adapt.place", "adapt.burn"}
SPLIT = ADAPTIVE | {"setup.aux", "tick.aux"}


@pytest.fixture
def fake_clock(monkeypatch):
    """The tracer's clock as a counter that the test moves by hand."""
    now = [0]
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: now[0], time_ns=lambda: 10**18 + now[0]))
    return now


# ---- the tracer ----------------------------------------------------------------

def test_nesting_and_self_time(fake_clock):
    tr = Tracer()
    outer = tr.span("outer")
    fake_clock[0] = 10
    with tr.span("child") as child:
        fake_clock[0] = 40
    fake_clock[0] = 50
    tr.tick = 3
    inner = tr.span("child")
    fake_clock[0] = 60
    inner.end()
    fake_clock[0] = 100
    assert outer.end() == 100 and child.seconds == 30e-9
    spans = tr.spans()
    assert spans["outer"] == {"n": 1, "total_s": 100e-9, "self_s": 60e-9, "max_s": 100e-9}
    assert spans["child"] == {"n": 2, "total_s": 40e-9, "self_s": 40e-9, "max_s": 30e-9}
    assert tr.total("child") == 40e-9 and tr.count("child") == 2 and tr.count("none") == 0
    ev = {e.id: e for e in tr.events}
    assert [e.name for e in tr.events] == ["child", "child", "outer"]
    assert ev[1].parent == ev[2].parent == 0 and ev[0].parent == -1
    assert (ev[1].tick, ev[2].tick, ev[0].tick) == (0, 3, 0)
    assert (ev[2].start_ns, ev[2].end_ns) == (50, 60)


def test_a_child_left_open_ends_with_its_parent(fake_clock):
    tr = Tracer()
    outer = tr.span("outer")
    tr.span("open child")
    fake_clock[0] = 7
    outer.end()
    assert [(e.name, e.end_ns) for e in tr.events] == [("open child", 7), ("outer", 7)]
    assert tr.spans()["outer"]["self_s"] == 0.0
    assert tr.span("next").parent is None


def test_event_cap_counts_the_dropped(fake_clock, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_EVENTS", 3)
    tr = Tracer()
    for i in range(5):
        fake_clock[0] = i
        with tr.span("s"):
            tr.add("work", 2)
    assert len(tr.events) == 3 and tr.counters == {"work": 10, "events.dropped": 2}
    assert tr.count("s") == 5


def test_calibrate_reads_the_unix_clock(fake_clock):
    fake_clock[0] = 123
    assert Tracer().calibrate() == 10**18


def test_tracing_imports_no_torch():
    """The module alone, loaded in a fresh interpreter, loads no torch."""
    code = ("import importlib.util, sys; "
            f"spec = importlib.util.spec_from_file_location('t', {tracing.__file__!r}); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


# ---- engine runs ---------------------------------------------------------------

def _net(tmp_path, name="grid3"):
    path = str(tmp_path / f"{name}.uai")
    with open(path, "w") as fh:
        fh.write(write_model(torch_models.MODELS[name][0](port_pgm)))
    return path


def _run(tmp_path, lines=None, devices=None, **kw):
    cfg = dict(model_path=_net(tmp_path), device="cpu", burnin=9 * 20, converge_window=9 * 20,
               chains=2, chains_per_variant=32, max_iters=9 * 64 * 20 * 6, max_secs=600.0,
               seed=5, status_secs=1e-6)
    cfg.update(kw)
    log = (lambda line: None) if lines is None else lines.append
    return Engine(EngineConfig(**cfg), log=log, devices=devices).run()


RUNS = {
    "simple": (dict(sampler="simple"), SIMPLE),
    "collapsed": (dict(sampler="collapsed"), SIMPLE),
    "adaptive": (dict(sampler="adaptive", chain_adds=2, split_group="off"), ADAPTIVE),
    "adaptive-split": (dict(sampler="adaptive", chain_adds=2, split_group="on"), SPLIT),
    "mesh2x2": (dict(sampler="simple", mesh="2x2"), SIMPLE),
}


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_engine_spans_and_folded_sites(tmp_path, kind):
    """Every span of the kind's table, each child inside its parent; the
    site updates folded into the host totals equal those claimed, which
    add up to ``RunResult.samples``, and those on merged tables too."""
    kw, names = RUNS[kind]
    res = _run(tmp_path, devices=["cpu"] * 4 if "mesh" in kind else None, **kw)
    assert set(res.spans) == names
    ticks = res.spans["tick"]["n"]
    assert ticks >= 2 and res.spans["tick.launch"]["n"] == ticks
    assert res.spans["setup"]["n"] == 1 and res.spans["setup.warmup"]["n"] == 1
    by_id = {e.id: e for e in res.events}
    for e in res.events:
        if e.name in PARENT:
            parent = by_id[e.parent]
            assert parent.name == PARENT[e.name], e
            assert parent.start_ns <= e.start_ns <= e.end_ns <= parent.end_ns, e
            assert parent.tick == e.tick
        else:
            assert e.parent == -1, e
    setup = next(e for e in res.events if e.name == "setup")
    assert res.clock_start == setup.end_ns and setup.tick == 0
    assert sorted({e.tick for e in res.events if e.name == "tick"}) == list(range(1, ticks + 1))
    assert abs(res.wall_offset_ns + setup.end_ns - tracing.time.time_ns()) < 600e9
    c = res.counters
    assert c["sites.folded"] == res.samples > 0
    assert c["sites.main"] + c.get("sites.aux", 0) == res.samples
    assert ("sites.aux" in c) == (kind == "adaptive-split")
    # every site of the 3x3 grid and of its collapse variants walks one
    # merged table (a blanket of at most 4 binary vars)
    assert c["sites.merged"] == res.samples


def test_a_merge_that_drops_one_shard_reads_three_quarters(tmp_path, monkeypatch):
    """One card's counts left out of the merge of a 2x2 mesh: every update
    is still claimed, and a quarter of them never reach the estimate."""
    delta = ShardedChainGroup._window_delta
    monkeypatch.setattr(ShardedChainGroup, "_window_delta", lambda self: delta(self)[:-1])
    res = _run(tmp_path, devices=["cpu"] * 4, sampler="simple", mesh="2x2")
    assert res.counters["sites.main"] == res.samples
    assert res.counters["sites.folded"] / res.samples == 0.75


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("mesh", [False, True], ids=["group", "mesh2x2"])
def test_rest_derived_counts_outcome_zero_where_the_kernel_ran(monkeypatch, mesh, kernel):
    """``sites.rest_derived`` (the draws whose count the CUDA kernel
    derives once a window, outcome 0's) is absent where the plain version
    ran the windows, as on the CPU, since it counts every outcome; where
    a group's windows ran the kernel (here pretended) it is the outcome-0
    updates folded into the totals, real vars only.  The launch counters
    come with it: ``sites.merged`` always (every site of the grid walks a
    merged table), ``sites.tables_global`` and ``sites.spilled`` only
    where the kernel ran, here 0 (the grid's tables are staged) and every
    claimed update (a spilling instance pretended), summed over the
    launches of the group or of the mesh's shards."""
    m = torch_models.MODELS["grid4_evid"][0](port_pgm)
    caps = compute_caps(m, headroom_factors=0)
    if mesh:
        g = ShardedChainGroup(m, 32, 8, seed=3, caps=caps,
                              mesh=chain_mesh(variant_ways=2, devices=["cpu"] * 4))
    else:
        g = ChainGroup(m, 32, 8, "cpu", seed=3, caps=caps)
    g.reserve(2)
    g.add_variants([m, m])
    if kernel:
        for stack in (g.kstack if mesh else [g.kstack]):
            monkeypatch.setattr(stack, "kernel", True)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: types.SimpleNamespace(multi_processor_count=132))
        monkeypatch.setattr(gibbs_cuda, "spills", lambda k, plan, dev: True)
    taken = g.advance(defer=True) + g.advance(defer=True)
    g.flush()
    c = g.tracer.counters
    assert c["sites.folded"] == c["sites.merged"] == taken > 0
    if not kernel:
        assert not {"sites.rest_derived", "sites.tables_global", "sites.spilled"} & set(c)
        return
    rest = g.totals[:, :caps.num_vars, 0].sum()
    assert c["sites.rest_derived"] == rest and 0 < rest < taken
    assert c["sites.tables_global"] == 0 and c["sites.spilled"] == taken


@pytest.mark.parametrize("split", ["off", "on"])
def test_adapt_parts_match_each_adapt_line(tmp_path, split):
    """Each ``ADAPT`` line's seconds are its ``tick.adapt`` span's, and the
    step's four parts (``adapt.burn`` inside ``adapt.place``) cover that
    span to within 5 %."""
    lines = []
    res = _run(tmp_path, lines, sampler="adaptive", chain_adds=2, split_group=split)
    steps = [float(ln.rsplit(" in ", 1)[1][:-2]) for ln in lines if ln.startswith("ADAPT: ")]
    assert len(steps) >= 2
    by_tick = {}
    for e in res.events:
        by_tick.setdefault(e.tick, {}).setdefault(e.name, []).append(e.end_ns - e.start_ns)
    adapted = [t for t in by_tick.values() if "adapt.collapse" in t]
    assert len(adapted) == len(steps)
    for secs, t in zip(steps, adapted):
        step = t["tick.adapt"][0]
        assert secs == round(step * 1e-9, 3)
        parts = t["adapt.rank"][0] + t["adapt.collapse"][0] + t["adapt.place"][0]
        assert 0.95 * step <= parts <= step
        assert t["adapt.burn"][0] <= t["adapt.place"][0]


def test_split_group_aux_from_the_tracer_and_the_exporters(tmp_path):
    """``aux_secs`` is the ``tick.aux`` total, the final ``aux group`` line
    counts its spans and the ``aux.sweeps`` counter; the monitor's status
    updates carry the site counters and the trace's summary the spans and
    counters."""
    updates = []
    monitor = types.SimpleNamespace(update=lambda **kw: updates.append(kw))
    trace = str(tmp_path / "t.jsonl")
    lines = []
    cfg = EngineConfig(model_path=_net(tmp_path), device="cpu", burnin=180, converge_window=180,
                       chains=2, chains_per_variant=32, chain_adds=2, max_iters=9 * 64 * 20 * 6,
                       max_secs=600.0, seed=5, status_secs=1e-6, sampler="adaptive",
                       split_group="on", trace_path=trace)
    res = Engine(cfg, log=lines.append, monitor=monitor).run()
    aux = res.spans["tick.aux"]
    assert res.aux_secs == aux["total_s"] > 0
    final = next(ln for ln in lines if ln.startswith("aux group: ") and " ticks, " in ln)
    assert f": {aux['n']} ticks, {res.counters['aux.sweeps']} sweeps " in final
    assert final.endswith(f"{res.aux_secs:.3f} s")
    last = updates[-1]
    assert last["iterations"] == res.samples
    assert {k: last[k] for k in ("sites.main", "sites.aux", "sites.folded")} == {
        k: res.counters[k] for k in ("sites.main", "sites.aux", "sites.folded")}
    text = open(trace).read().splitlines()
    summary = json.loads(text[text.index("// RESULT SUMMARY") + 1])
    assert summary["counters"] == res.counters
    assert summary["spans"]["tick.aux"] == aux and summary["aux_secs"] == res.aux_secs


def test_wall_budget_anchors_at_the_start(tmp_path):
    res = _run(tmp_path, sampler="simple", budget="wall")
    setup = next(e for e in res.events if e.name == "setup")
    assert res.clock_start == setup.start_ns < setup.end_ns
