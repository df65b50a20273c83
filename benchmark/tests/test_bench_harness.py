"""CPU tests of the benchmark harness: generators, the reference, the count,
the registry, the result line, the import check, the control and the
planted faults.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import control, count, exact, faults, nets, registry, run

ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: the cells in the order the benchmark lists them
CELLS = ["grid10x10-simple", "promedus916-adaptive", "promedus916-simple",
         "promedus916-adaptive-mesh2x2"]


def brute_marginals(net):
    """Exact marginals by enumerating every assignment."""
    cards = net["cards"]
    rows = np.array(list(itertools.product(*[range(c) for c in cards])))
    logw = np.zeros(len(rows))
    for scope, table in net["factors"]:
        arr = np.asarray(table).reshape([cards[u] for u in scope])
        logw += np.log(arr[tuple(rows[:, u] for u in scope)])
    w = np.exp(logw - logw.max())
    for u, x in net["evidence"].items():
        w[rows[:, u] != x] = 0.0
    out = np.zeros((len(cards), max(cards)))
    for u, c in enumerate(cards):
        for k in range(c):
            out[u, k] = w[rows[:, u] == k].sum()
    return out / out.sum(axis=1, keepdims=True)


# ---- generators ------------------------------------------------------------

@pytest.mark.parametrize("config", ["grid10x10", "promedus916"])
def test_same_seed_same_uai_bytes(config):
    spec = registry.config(config)["net"]
    a, b = nets.build(spec, 2**31 + 11), nets.build(spec, 2**31 + 11)
    assert nets.uai_text(a) == nets.uai_text(b)
    assert nets.evidence_text(a) == nets.evidence_text(b)


@pytest.mark.parametrize("config", ["grid10x10", "promedus916"])
def test_structure_and_evidence_fixed_across_seeds(config):
    spec = registry.config(config)["net"]
    a, b = nets.build(spec, 5), nets.build(spec, 6)
    assert [s for s, _ in a["factors"]] == [s for s, _ in b["factors"]]
    assert a["evidence"] == b["evidence"] and a["cards"] == b["cards"]
    assert any(not np.array_equal(x, y) for (_, x), (_, y) in zip(a["factors"], b["factors"]))


def test_promedus_shape():
    net = nets.build(registry.config("promedus916")["net"], 3)
    assert len(net["cards"]) == 916 and len(net["evidence"]) == 46
    assert max(len(s) for s, _ in net["factors"]) == 3
    for scope, table in net["factors"]:  # CPT rows sum to 1
        assert np.allclose(table.reshape(-1, 2).sum(axis=1), 1.0)


def test_uai_files_parse_back(tmp_path):
    net = nets.grid(3, side=3, evidence={4: 1})
    path = nets.write_uai(net, str(tmp_path), "g")
    text = open(path).read().split()
    assert text[:4] == ["MARKOV", "9", "2", "2"] and text[11] == "21"
    assert open(path + ".evid").read() == "1\n1 4 1\n"


# ---- the reference ---------------------------------------------------------

@pytest.mark.parametrize("net", [
    nets.grid(5, side=3, evidence={0: 1}),
    nets.grid(8, side=3, card=3, evidence={4: 2}),
    nets.promedus_like(7, v=12, evidence_frac=0.2),
    nets.promedus_like(9, structure_seed=4, v=12, evidence_frac=0.0),
], ids=["grid3", "grid3_card3", "promedus12", "promedus12_no_evidence"])
def test_reference_equals_enumeration(net):
    np.testing.assert_allclose(exact.exact_marginals(net), brute_marginals(net), atol=1e-12)


def test_hellinger():
    p = np.array([[1.0, 0.0], [0.5, 0.5]])
    q = np.array([[0.0, 1.0], [0.5, 0.5]])
    np.testing.assert_allclose(exact.hellinger(p, q), [1.0, 0.0])


# ---- the count -------------------------------------------------------------

def test_site_operations_binary():
    # the draw at card 2: mask 2, max 1, subtract 2, exp 2, total 1, floor
    # 1 + 2 + 2, total 1, hash 22 + scale 1, CDF 0 + compares 1 + outcome 1,
    # count 1
    assert count.site_operations(2) == 40


def test_count_on_a_hand_counted_net():
    # 0 - 1 - 2, a unary on each, var 2 observed
    net = {"type": "MARKOV", "cards": [2, 2, 2], "evidence": {2: 1},
           "factors": [((0,), np.ones(2)), ((1,), np.ones(2)), ((2,), np.ones(2)),
                       ((0, 1), np.ones(4)), ((1, 2), np.ones(4))]}
    # var 0: 40 + unary 2 + pair (2 + 1) = 45; var 1: 40 + 2 + (2 + 1) + (2 + 0) = 47
    assert count.net_operations(net) == (92, 2, 4)
    least, by = count.least_seconds(net, 1e6, 10, 1e9, 1e9)
    assert by == "operations" and math.isclose(least, 1e6 * 46 / 1e9)
    least, by = count.least_seconds(net, 1e6, 1, 1e12, 1e9)
    assert by == "bytes" and math.isclose(least, 1e6 * (8 + 4 * 2) / 1e9)


# ---- BENCHMARK.json and the registry ---------------------------------------

def test_benchmark_json_names_units_and_files():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert [w["name"] for w in bench["workloads"]] == CELLS[:len(bench["workloads"])]
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(CELLS) // 4)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"site_samples_per_s", "setup_s"} <= e2e
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert callable(registry.reader(m["name"]))
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in ("sweep_roofline", "step_mfu"):
        assert next(x for x in bench["per_layer"] if x["name"] == m)["unit"] == "%"
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        c = registry.cell(w["name"])
        assert c["config"]["name"] == w["config"] and c["limits"]
        assert {m["moves"] for m in c["per_layer"]} <= {m["name"] for m in c["end_to_end"]}
        per_layer = {m["name"].split(".")[0] for m in c["per_layer"]}
        assert {"sweep_roofline", "step_mfu"} <= per_layer
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = registry.config(c["name"])
        assert c["file"].startswith("benchmark/") and conf["name"] == c["name"]
        assert c["reduced"] == conf["reduced"] and len(c["source"]) <= 200


def test_new_files_are_found_without_edits(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as new
    files (and entries) in a copy of the benchmark are found by name, and
    the new cell runs with the new metric in its line."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(root, "benchmark", p)).read()
              for p in ("run.py", "registry.py", "trace.py", "nets.py")}
    bench = registry.benchmark()
    with open(os.path.join(root, "benchmark", "configs", "grid4.json"), "w") as fh:
        json.dump({"name": "grid4", "source": "a test", "reduced": [], "assumed": {},
                   "net": {"builder": "grid", "side": 4, "evidence": {"5": 1}},
                   "burnin_sweeps": 20, "cwin_sweeps": 20}, fh)
    with open(os.path.join(root, "benchmark", "traffic", "simple-c2-v32.json"), "w") as fh:
        json.dump({"sampler": "simple", "chains": 2, "vchains": 32}, fh)
    with open(os.path.join(root, "benchmark", "workloads", "grid4-simple.json"), "w") as fh:
        json.dump({"limits": {"hellinger_max": 0.2}}, fh)
    with open(os.path.join(root, "benchmark", "metrics", "sweeps_total.py"), "w") as fh:
        fh.write("def read(rec):\n    return rec['result'].sweeps\n")
    bench["configs"].append({"name": "grid4", "source": "a test",
                             "file": "benchmark/configs/grid4.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "grid4-simple", "config": "grid4",
                               "traffic": "simple-c2-v32", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "sweeps_total", "unit": "sweeps", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["grid4-simple"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)

    cell = registry.cell("grid4-simple", root)
    assert cell["traffic"]["vchains"] == 32 and cell["config"]["net"]["side"] == 4
    assert "sweeps_total" in {m["name"] for m in cell["end_to_end"]}
    assert "sweeps_total" not in {m["name"] for m in registry.cell(CELLS[0], root)["end_to_end"]}
    cell["root"] = root
    out = drive(cell, seed=3, seconds=1.0)
    assert out["correct"] and out["metrics"]["sweeps_total"]["value"] > 0
    assert before == {p: open(os.path.join(root, "benchmark", p)).read() for p in before}


#: a net family's builder as a file of its own: a ring Markov net of card-3
#: vars, a unary factor per var and a pairwise factor per edge
RING_BUILDER = """
import numpy as np


def build(seed, n=6, card=3, evidence=None):
    rng = np.random.default_rng(int(seed) % (1 << 64))
    factors = [((i,), rng.random(card) + 0.3) for i in range(n)]
    factors += [(tuple(sorted((i, (i + 1) % n))), rng.random(card * card) + 0.3)
                for i in range(n)]
    ev = {int(k): int(x) for k, x in (evidence or {}).items()}
    return {"type": "MARKOV", "cards": [card] * n, "factors": factors, "evidence": ev}
"""


def test_new_builder_and_engine_flags_are_found_without_edits(tmp_path):
    """A net builder (``benchmark/builders/<name>.py``) and a traffic mix
    that sets further ``EngineConfig`` fields, added as new files (and
    entries) in a copy of the benchmark, are found by name: the builder's
    net passes through the reference and a run, the mix's flags reach the
    engine, and no file of the harness changes."""
    root = str(tmp_path)
    here = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(ROOT, "benchmark"), here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(here, p)).read()
              for p in ("run.py", "registry.py", "trace.py", "nets.py")}
    os.makedirs(os.path.join(here, "builders"), exist_ok=True)
    with open(os.path.join(here, "builders", "ring.py"), "w") as fh:
        fh.write(RING_BUILDER)
    with open(os.path.join(here, "configs", "ring6.json"), "w") as fh:
        json.dump({"name": "ring6", "source": "a test", "reduced": [], "assumed": {},
                   "net": {"builder": "ring", "n": 6, "evidence": {"2": 1}},
                   "burnin_sweeps": 20, "cwin_sweeps": 20}, fh)
    with open(os.path.join(here, "traffic", "simple-c2-v32-flags.json"), "w") as fh:
        json.dump({"sampler": "simple", "chains": 2, "vchains": 32, "anneal_stages": 0,
                   "status_secs": 0.5, "why": "a test"}, fh)
    with open(os.path.join(here, "workloads", "ring6-simple.json"), "w") as fh:
        json.dump({"limits": {"hellinger_max": 0.2}}, fh)
    bench = registry.benchmark()
    bench["configs"].append({"name": "ring6", "source": "a test",
                             "file": "benchmark/configs/ring6.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "ring6-simple", "config": "ring6",
                               "traffic": "simple-c2-v32-flags", "chips": 1, "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)

    with pytest.raises(KeyError, match="ring"):
        nets.build({"builder": "ring"}, 3)  # the checkout's own files have none
    cell = registry.cell("ring6-simple", root)
    cell["root"] = root
    net = nets.build(cell["config"]["net"], 3, root)
    assert net["cards"] == [3] * 6 and net["evidence"] == {2: 1}
    assert nets.uai_text(net) == nets.uai_text(nets.build(cell["config"]["net"], 3, root))
    np.testing.assert_allclose(exact.exact_marginals(net), brute_marginals(net), atol=1e-12)
    cell["net"] = net
    cfg = run.engine_config(cell, "net.uai", 3, 1.0, "cpu")
    assert (cfg.anneal_stages, cfg.status_secs, cfg.chains_per_variant) == (0, 0.5, 32)
    out = drive(cell, seed=3, seconds=1.0)
    assert out["correct"] and out["attempted"] == 5, out["checks"]
    assert before == {p: open(os.path.join(here, p)).read() for p in before}


def test_unknown_builder_names_both_places():
    with pytest.raises(KeyError) as err:
        nets.build({"builder": "no_such_family"}, 1)
    assert "nets.BUILDERS" in str(err.value)
    assert os.path.join("benchmark", "builders", "no_such_family.py") in str(err.value)


def engine_config_before_flags(cell, path, seed, seconds, device):
    """``run.engine_config`` as it was before a mix could set any field:
    five keys of the mix, each passed by hand."""
    from grample_tpu_torch.sampler.engine import EngineConfig

    conf, traffic = cell["config"], cell["traffic"]
    v = len(cell["net"]["cards"])
    return EngineConfig(
        model_path=path, device=device, use_evidence=True, use_solution=False,
        sampler=traffic["sampler"], chains=traffic["chains"],
        chains_per_variant=traffic["vchains"], chain_adds=traffic.get("chain_adds", 1),
        burnin=conf["burnin_sweeps"] * v, converge_window=conf["cwin_sweeps"] * v,
        max_secs=float(seconds), budget="sampling", seed=int(seed) % (1 << 62) + 1,
        split_group=traffic.get("split_group", "auto"))


@pytest.mark.parametrize("cell_name", CELLS[:3])
def test_engine_config_of_the_first_cells_unchanged(cell_name):
    """The cells that passed five keys of their mix by hand build the same
    ``EngineConfig``, field for field, now that every key is passed."""
    cell = registry.cell(cell_name)
    cell["net"] = nets.build(cell["config"]["net"], 2**31 + 5)
    for seed in (1, 2**31 + 5, -7):
        new = run.engine_config(cell, "m.uai", seed, 30.0, "cuda")
        assert dataclasses.asdict(new) == dataclasses.asdict(
            engine_config_before_flags(cell, "m.uai", seed, 30.0, "cuda"))


@pytest.mark.parametrize("key", ["chainz", "max_secs", "model_path"])
def test_traffic_key_that_sets_no_field_raises(key):
    """A key of a mix that names no ``EngineConfig`` field, or one the
    harness sets itself, raises."""
    cell = small("simple-c2-v131072")
    cell["traffic"][key] = 3
    cell["net"] = nets.build(cell["config"]["net"], 1)
    with pytest.raises(KeyError, match=key):
        run.engine_config(cell, "m.uai", 1, 1.0, "cpu")


# ---- a run on the CPU: the result line, the planted faults ------------------

def drive(cell, seed, seconds):
    """A run of ``cell`` on the CPU, with the harness's look for a card
    skipped; ``judge``'s output."""
    cell["net"] = nets.build(cell["config"]["net"], seed, cell.get("root", ROOT))
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = nets.write_uai(cell["net"], td, "net")
        rec = run.run_program(cell, path, seed, seconds, False, time.perf_counter(),
                              device="cpu")
    rec["peak_ops"] = rec["peak_bytes_per_s"] = None
    return run.judge(cell, rec, False)


#: a test's net: the Promedus-shaped structure cut to 600 vars, enough
#: free vars for ``error_inflation`` to see half the chains left out
NET600 = {"builder": "promedus_like", "structure_seed": 1, "v": 600, "window": 40,
          "evidence_frac": 0.05, "floor": 0.05}


def small(traffic, limits=None, net=None):
    """A cell of a test's size under traffic mix ``traffic``
    (``benchmark/traffic/<traffic>.json``) at 64 chains a variant, with the
    end-to-end metrics of the benchmark's cell of that mix: by default a
    4x4 grid judged by its largest Hellinger distance."""
    with open(os.path.join(ROOT, "benchmark", "traffic", traffic + ".json")) as fh:
        mix = json.load(fh)
    like = next(w["name"] for w in registry.benchmark()["workloads"] if w["traffic"] == traffic)
    return {"entry": {"name": "small", "chips": 1},
            "config": {"name": "small",
                       "net": net or {"builder": "grid", "side": 4,
                                      "evidence": {"5": 1, "10": 0}},
                       "burnin_sweeps": 40, "cwin_sweeps": 40},
            "traffic": dict(mix, vchains=64), "limits": limits or {"hellinger_max": 0.05},
            "end_to_end": registry.cell(like)["end_to_end"], "per_layer": []}


def test_result_line_keys():
    out = drive(small("simple-c2-v131072"), seed=2**31 + 3, seconds=1.0)
    device = {"platform": "gpu", "kind": "a card", "count": 1, "memory_peak_bytes": 1}
    span = {"busy_s": [1.0, 3.0], "wall": 4.0, "ops": [["k", 1.0]], "gaps": [["g", 0.5]]}
    for s in ({}, span):
        line = run.result_line(out, device, s)
        keys = list(line)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert keys[-1] == "checks" and ("breakdown" in line) == bool(s)
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
        assert set(line["checks"]) == {"hellinger_max"}
        assert set(line["checks"]["hellinger_max"]) == {"value", "limit"}
        json.dumps(line)
    assert line["device"]["busy_s"] == 2.0 and line["device"]["window_s"] == 4.0
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == 14
    assert set(out["metrics"]) == {"site_samples_per_s.grid", "setup_s"}  # no card: no peak


#: a test cell's limits by traffic mix, of the kinds its benchmark cell
#: compares: readings at this size (CPU, seeds 11-13, at ``SMALL_SECONDS``)
#: put ``error_inflation`` at 1.24-1.46 sound and 2.95-3.18 with half the
#: chains left out (simple), the median at 0.88-1.11 and 2.10-2.35 (adaptive)
SMALL_LIMITS = {"simple-c2-v131072": {"hellinger_mean": 0.01, "error_inflation": 2.1},
                "adaptive-c2-v8192-a4": {"hellinger_mean": 0.01, "error_inflation_median": 1.6}}
#: a test run's length by traffic mix: an adaptive run adapts in the first
#: half of its clock, and its first window takes 3.5-5.2 s on the CPU, so a
#: 10 s run can end adaptation before its first adapt step
SMALL_SECONDS = {"simple-c2-v131072": 10.0, "adaptive-c2-v8192-a4": 16.0}


@pytest.mark.parametrize("traffic", sorted(SMALL_LIMITS))
@pytest.mark.parametrize("fault", [None, *sorted(faults.FAULTS)])
def test_planted_faults_fail_correct(traffic, fault, monkeypatch):
    """Each fault the traffic can have, planted under the timed path, makes
    ``correct`` false; the same run without it is correct."""
    from grample_tpu_torch.ops import sweep

    if fault:
        monkeypatch.setattr(sweep, "window", faults.FAULTS[fault](sweep.window))
    # an adaptive run takes an RB snapshot a status tick, and a collapsed
    # var's estimate needs two after its collapse: ticks a second apart
    # give a run of a test's length several
    config = run.engine_config
    monkeypatch.setattr(run, "engine_config", lambda *a: dataclasses.replace(config(*a),
                                                                             status_secs=1.0))
    out = drive(small(traffic, SMALL_LIMITS[traffic], NET600), seed=11,
                seconds=SMALL_SECONDS[traffic])
    assert out["correct"] == (fault is None), out["checks"]


#: the mesh mix's test cell: the adaptive cell's limits and ``unfolded_share``
#: (readings at this size, CPU, seed 11: ``error_inflation_median`` 0.91
#: sound, 2.24 with a shard's counts left out, 2.61 with half the chains';
#: ``unfolded_share`` 0 sound, 0.5 with either)
MESH_LIMITS = {"hellinger_mean": 0.01, "error_inflation_median": 1.9, "unfolded_share": 0.0}


@pytest.mark.parametrize("fault", [None, *sorted(faults.FAULTS), *sorted(faults.MESH_FAULTS)])
def test_planted_faults_fail_correct_on_a_mesh(fault, monkeypatch):
    """The mesh mix on a virtual 2x2 mesh of the CPU: correct without a
    fault; each fault it can have, the mesh's own among them, makes it not
    correct, and ``shard`` through the counts that never reached the host
    totals."""
    import functools

    from grample_tpu_torch.sampler import engine

    if fault:
        owner, attr, wrap = faults.target(fault)
        monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    monkeypatch.setattr(engine, "Engine", functools.partial(engine.Engine, devices=["cpu"] * 4))
    config = run.engine_config
    monkeypatch.setattr(run, "engine_config", lambda *a: dataclasses.replace(config(*a),
                                                                             status_secs=1.0))
    out = drive(small("adaptive-c2-v8192-a4-mesh2x2", MESH_LIMITS, NET600), seed=11,
                seconds=10.0)
    assert out["correct"] == (fault is None), out["checks"]
    unfolded = out["checks"]["unfolded_share"]
    assert (unfolded["value"] > unfolded["limit"]) == (fault in faults.MESH_FAULTS or
                                                       fault == "half"), out["checks"]


def test_main_refuses_without_a_card(capsys, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for var in ("HOME", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):  # main sets them
        monkeypatch.setenv(var, os.environ.get(var, ""))
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_reduce_span_clips_and_names():
    """Sums of a made-up trace: clipped to the span between the first and
    the last tick's markers, busy time as a union without the markers,
    gaps named by the log lines whose markers lie around them."""
    from types import SimpleNamespace as NS

    from benchmark import trace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"

    def ev(name, a, b, dev=cuda, index=0):
        return NS(name=name, device_type=dev, device_index=index,
                  time_range=NS(start=a, end=b))

    events = [ev(spin, 100, 101), ev(spin, 1100, 1101), ev(spin, 600, 601),
              ev("cudaLaunchKernel", 90, 95, cpu),
              ev("void gibbs_window_kernel<2, true, false>", 50, 400),
              ev("elementwise_kernel", 300, 500),  # overlaps the window on card 0
              ev("void gibbs_window_sites_kernel<2>", 700, 1200),
              ev("void gibbs_window_kernel<2, true, false>", 100, 300, index=1)]
    marks = [trace.TICK, trace.LOG + "ADAPT: 6 chains in 0.5 s", trace.TICK]
    span = trace.reduce_span(NS(events=lambda: events), 2, marks)
    assert span["wall"] == 1000e-6
    assert math.isclose(span["gibbs_s"], (300 + 400 + 200) * 1e-6)
    assert math.isclose(span["device_s"], (300 + 200 + 400 + 200) * 1e-6)
    assert np.allclose(span["busy_s"], [800e-6, 200e-6])  # [100, 500] + [700, 1100]
    assert span["gaps"] == [["after 'start', before 'ADAPT: 6 chains in 0.5 s'", 200e-6]]
    assert span["ops"][0][0].startswith("void gibbs_window")
    assert trace.reduce_span(NS(events=lambda: events), 2, marks[:2]) == {}  # a marker lost


def test_monitor_reads_the_peak_at_its_first_update(monkeypatch):
    """The monitor reads the cards' peak once, at the engine's first update
    (after burn-in, before any adapt step), the fullest card's;
    ``burnin_peak_gb`` reports it in GB, and nothing without a card."""
    from benchmark import trace

    peaks = iter([5e9, 7e9, 9e9, 11e9])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: next(peaks))
    mon = trace.SpanMonitor(["card 0", "card 1"])
    assert mon.burnin_peak == 0
    mon.update(iterations=0)
    mon.update(iterations=10)
    assert mon.burnin_peak == 7e9 and len(mon.updates) == 2
    read = registry.reader("burnin_peak_gb")
    assert read({"burnin_peak_bytes": mon.burnin_peak, "peak_bytes": 11e9}) == 7.0
    assert read({"burnin_peak_bytes": 0, "peak_bytes": 0}) is None


# ---- the import check --------------------------------------------------------

def test_forbidden_names_compare_whole_top_level_names():
    assert run.forbidden_modules(["jax.numpy", "numpy", "grample_tpu_torch.ops"]) == ["jax"]
    assert run.forbidden_modules(["grample_tpu.ops.sweep", "flax", "jaxlib.xla"]) == [
        "flax", "grample_tpu", "jaxlib"]
    assert run.forbidden_modules(["grample_tpu_torch", "jaxtyping", "benchmark.run"]) == []


def test_a_run_loads_no_jax():
    code = ("import sys; from benchmark import run, exact, trace, control, count, nets; "
            "import grample_tpu_torch.sampler.engine, grample_tpu_torch.parallel.mesh; "
            "print(run.forbidden_modules())")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout.strip()
    assert out == "[]"


# ---- the control ---------------------------------------------------------------

@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name):
    """The reference in bfloat16, at the configuration's own size, put in
    the program's place and judged by the harness's own comparison under
    the cell's limits, comes out not correct; it fails the limit of the
    mean Hellinger distance, the number that every cell compares."""
    from types import SimpleNamespace as NS

    cell = registry.cell(cell_name)
    for seed in (1, 2, 3):
        cell["net"] = nets.build(cell["config"]["net"], seed)
        low = control.marginals(cell["net"])
        rec = {"result": NS(marginals=low, samples=10**12, runtime=30.0, aux_secs=0.0),
               "peak_bytes": 0, "setup_s": 1.0, "adapt_s": [], "span": {}}
        out = run.judge(cell, rec, False)
        assert not out["correct"], (seed, out["checks"])
        mean = out["checks"]["hellinger_mean"]
        assert mean["value"] > mean["limit"], (seed, out["checks"])


# ---- on the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_cell_on_the_card(card):
    """A traced run of the first cell at the benchmark's own length: the
    limits of ``correct`` hold at ``run_seconds`` (a shorter window reads a
    higher ``error_inflation``), and its kernel's share of the roofline,
    under the name the cell reports it by, is a share."""
    seconds = str(registry.benchmark()["run_seconds"])
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                          "--seed", str(2**31 + 7), "--seconds", seconds, "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    roofline = next(m["name"] for m in registry.cell(CELLS[0])["per_layer"]
                    if m["name"].split(".")[0] == "sweep_roofline")
    assert 0 < line["metrics"][roofline]["value"] <= 105
