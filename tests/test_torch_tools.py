"""The port's tooling against the JAX package's: the ``dot`` command, the
native host tier (tokenizer, UAI fast path, anchor sampler) and the seven
tools under ``grample_tpu_torch.tools``."""

import csv
import io
import json
import os

import numpy as np
import pytest

import grample_tpu.native as ref_native
import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.tools.bench_compare as ref_bench_compare
import grample_tpu.tools.experiments as ref_experiments
import grample_tpu.tools.ref300 as ref_ref300
import grample_tpu.tools.trace_process as ref_trace_process
import grample_tpu.uai.parser as ref_parser
import grample_tpu_torch.native as port_native
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.tools.bench_compare as port_bench_compare
import grample_tpu_torch.tools.drift as port_drift
import grample_tpu_torch.tools.experiments as port_experiments
import grample_tpu_torch.tools.profile_adaptive as port_profile
import grample_tpu_torch.tools.ref300 as port_ref300
import grample_tpu_torch.tools.scaling as port_scaling
import grample_tpu_torch.tools.trace_process as port_trace_process
import grample_tpu_torch.uai.parser as port_parser
from grample_tpu import cli as ref_cli
from grample_tpu_torch import cli
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.ops import _build
from grample_tpu_torch.pgm.coloring import moral_adjacency
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.uai.writer import write_model

from tests import torch_models
from tests.conftest import RES_DIR, res_path
from tests.test_torch_engine import _write_net
from tests.test_uai import PASCAL_DOC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_native = pytest.mark.skipif(port_native.load() is None,
                                  reason="no C++ compiler: the native tier is unavailable")


# ---- dot ---------------------------------------------------------------------

@pytest.mark.parametrize("name,evidence", [("grid4_evid", {5: 1, 10: 0}), ("rand8_card4", None),
                                           ("star6_card3_evid", None)])
def test_dot_matches_reference(tmp_path, capsys, name, evidence):
    """``dot`` prints what the reference CLI prints, one edge per pair of
    the moral graph."""
    path, _ = _write_net(tmp_path, name, evidence)
    argv = ["dot", "-m", path] + (["-d"] if evidence else [])
    assert cli.main(argv) == 0
    mine = capsys.readouterr().out
    assert ref_cli.main(argv) == 0
    assert mine == capsys.readouterr().out
    m = torch_models.MODELS[name][0](port_pgm)
    adj = moral_adjacency(m.num_vars, [f.scope for f in m.factors])
    lines = mine.splitlines()
    assert lines[0] == "strict graph G {" and lines[-1] == "}"
    assert len(lines) - 2 == sum(len(a) for a in adj) // 2


# ---- the native tier ---------------------------------------------------------

def test_native_builds_into_the_build_directory():
    """The library lands under ``_build/`` (never in the package
    directory), named by the hash of its source."""
    if port_native.load() is None:
        pytest.skip("no C++ compiler")
    libs = [f for f in os.listdir(_build.BUILD_DIR) if f.startswith("libanchor_")]
    assert libs and all(f.endswith(".so") for f in libs)
    pkg = os.path.dirname(port_native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    with open(os.path.join(_build.CSRC_DIR, "anchor.cpp")) as fh:
        src = fh.read()
    assert "tokenize_f64" in src and "cuda" not in src.lower().replace("no cuda", "")


def test_native_unavailable_without_a_compiler(monkeypatch, tmp_path):
    """No compiler: ``load`` gives None and the parser takes the portable
    path with the same result."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "nobuild"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_load_failed", False)
    assert port_native.load() is None
    assert port_native.tokenize_f64(b"1 2 3", 3) is None
    assert port_native.anchor_gibbs(torch_models.build(port_pgm, "grid3"), 10) is None
    m = port_parser.parse_model(PASCAL_DOC)
    want = port_parser.parse_model(PASCAL_DOC, native=False)
    assert [f.table.tolist() for f in m.factors] == [f.table.tolist() for f in want.factors]
    assert not os.path.exists(str(tmp_path / "nobuild"))


@needs_native
@pytest.mark.parametrize("text,expect", [
    (b"1 2.5 -3e2\n4\t5", 5), (b"1 2 3", 8), (b"", 4), (b"  7  ", 1), (b"1 2 x 4", 4),
    (b"1 2 3 4 5", 3), (b"0.25 .5 1e-3 +2", 4),
])
def test_tokenize_f64_matches_reference(text, expect):
    mine = port_native.tokenize_f64(text, expect)
    ref = ref_native.tokenize_f64(text, expect)
    if ref is None:
        assert mine is None
    else:
        np.testing.assert_array_equal(mine, ref)


def _same_model(a, b):
    assert a.type == b.type and a.cards.tolist() == b.cards.tolist()
    assert len(a.factors) == len(b.factors)
    for fa, fb in zip(a.factors, b.factors):
        assert fa.name == fb.name and fa.scope.tolist() == fb.scope.tolist()
        np.testing.assert_array_equal(fa.table, fb.table)
        assert fa.is_log == fb.is_log


@needs_native
@pytest.mark.parametrize("name", ["pascal"] + sorted(torch_models.MODELS))
def test_fast_path_model_matches_portable_and_reference(monkeypatch, name):
    """The model the fast tokenizer parses equals the portable parser's
    and the reference's, and the fast path really was taken."""
    text = PASCAL_DOC if name == "pascal" else write_model(torch_models.MODELS[name][0](port_pgm))
    calls = []
    real = port_parser._NumCursor
    monkeypatch.setattr(port_parser, "_NumCursor",
                        lambda arr: (calls.append(arr.size), real(arr))[1])
    fast = port_parser.parse_model(text)
    assert calls
    _same_model(fast, port_parser.parse_model(text, native=False))
    _same_model(fast, ref_parser.parse_model(text))


@needs_native
@pytest.mark.parametrize("text", [
    "MARKOV\n2\n2 2\n1\n2 0 1\n4 1 2 3",  # a table cut short
    "MARKOV\n2\n2 2\n1\n2 0 5\n4 1 2 3 4",  # var index out of range
    "MARKOV\n2\n2 x\n1\n2 0 1\n4 1 2 3 4",  # not a number: the portable path's message
    "MARKOV\n2\n2 2.5\n1\n2 0 1\n4 1 2 3 4",  # not an int
])
def test_fast_path_errors_match_portable_and_reference(text):
    with pytest.raises(port_parser.UAIParseError) as fast:
        port_parser.parse_model(text)
    with pytest.raises(port_parser.UAIParseError) as portable:
        port_parser.parse_model(text, native=False)
    with pytest.raises(ref_parser.UAIParseError) as ref:
        ref_parser.parse_model(text)
    assert str(fast.value) == str(portable.value) == str(ref.value)


@needs_native
@pytest.mark.parametrize("name,seed", [("grid3", 1), ("grid3_card3_evid", 7), ("rand8_card4", 3)])
def test_anchor_counts_equal_reference(name, seed):
    """The same C++ source on the same encoding and seed: the same counts,
    exactly."""
    mine = port_native.anchor_gibbs(torch_models.build(port_pgm, name), 20000, seed=seed)
    ref = ref_native.anchor_gibbs(torch_models.build(ref_pgm, name), 20000, seed=seed)
    if ref is None:
        pytest.skip("the reference's native tier is unavailable")
    np.testing.assert_array_equal(mine[0], ref[0])
    assert mine[0].sum() == 20000 and mine[1] > 0 and mine[2] > 0


@needs_native
def test_anchor_vs_exact():
    """The anchor's stationary distribution is the model's: 4x4 grid with
    evidence, 4e5 single-site samples (28571 per free var; the grid's
    chains mix within about 8 visits: 5 sigma(H) ~ 5 / sqrt(8 * 3500))."""
    m = torch_models.build(port_pgm, "grid4_evid")
    counts, secs, rate = port_native.anchor_gibbs(m, 400000, seed=5)
    free = m.fixed < 0
    assert (counts[~free] == 0).all()
    h = hellinger(counts[free].astype(np.float64), exact_marginals(m)[free], m.cards[free])
    assert h.max() < 5.0 / np.sqrt(8 * 3500), h


# ---- trace_process, bench_compare, ref300 ------------------------------------

@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A trace (experiment CSV included) that the port's engine wrote."""
    tmp = tmp_path_factory.mktemp("trace")
    path, _ = _write_net(tmp, "grid3_card3_evid", {4: 2})
    trace = str(tmp / "t.trace")
    cfg = EngineConfig(model_path=path, device="cpu", use_evidence=True, use_solution=True,
                       sampler="adaptive", burnin=90, converge_window=180, chains=2,
                       chains_per_variant=32, chain_adds=2, max_iters=9 * 64 * 20 * 4, seed=4,
                       status_secs=1e-6, trace_path=trace, experiment=True)
    Engine(cfg, log=lambda s: None).run()
    return trace


def test_trace_process_matches_reference(port_trace):
    text = open(port_trace).read()
    outs = []
    for mod in (port_trace_process, ref_trace_process):
        out = io.StringIO()
        assert mod.process(text.splitlines(), out) == 0
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    rows = list(csv.DictReader(io.StringIO(outs[0])))
    assert len(rows) == 8 and "Hell-Convergence-RANK" in rows[0]
    assert sorted(int(r["Hell-Error-RANK"]) for r in rows) == list(range(1, 9))
    assert port_trace_process.process([], io.StringIO()) == 1


def test_trace_process_main_reads_a_file(port_trace, capsys):
    assert port_trace_process.main([port_trace]) == 0
    mine = capsys.readouterr().out
    assert ref_trace_process.main([port_trace]) == 0
    assert mine == capsys.readouterr().out


@pytest.mark.parametrize("a,b", [("BENCH_r04.json", "BENCH_r05.json"),
                                 ("BENCH_r05.json", "BENCH_r01.json")])
def test_bench_compare_matches_reference(capsys, a, b):
    with open(os.path.join(REPO, a)) as fa, open(os.path.join(REPO, b)) as fb:
        da, db = json.load(fa), json.load(fb)
    outs = []
    for mod in (port_bench_compare, ref_bench_compare):
        out = io.StringIO()
        mod.compare(da, db, out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[0].startswith("metric") and "%" in outs[0]
    assert port_bench_compare._flat({"a": {"b": 1, "c": True, "d": "x"}}) == {"a.b": 1.0}
    assert port_bench_compare.main([]) == 2
    assert port_bench_compare.main([os.path.join(REPO, a), os.path.join(REPO, b)]) == 0


def test_ref300_matches_reference(tmp_path, port_trace):
    """The committed 300 s rows and traces, and a trace of the port's own
    engine, give the reference tool's analysis."""
    assert port_ref300.parse_trace_csv(port_trace) == ref_ref300.parse_trace_csv(port_trace)
    assert len(port_ref300.parse_trace_csv(port_trace)) >= 3
    series = [s[1] for s in port_ref300.parse_trace_csv(port_trace)]
    assert port_ref300.sparkline(series) == ref_ref300.sparkline(series)
    assert port_ref300.sparkline([]) == ""
    outs = []
    for mod, name in ((port_ref300, "port.md"), (ref_ref300, "ref.md")):
        out = str(tmp_path / name)
        assert mod.main(["--rows", os.path.join(REPO, "results/ref300.jsonl"), "--traces",
                         os.path.join(REPO, "results/traces300"), "--out", out]) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1] and "Plateau curves" in outs[0]


# ---- experiments --------------------------------------------------------------

def test_experiment_modes_match_reference():
    assert port_experiments.MODES == ref_experiments.MODES


def test_summarize_table_and_claim():
    """``tests/test_experiments.py::test_summarize_table_and_claim``, and
    the same text as the reference's."""
    rows = [
        {"net": "x", "mode": "adaptive", "mean_hellinger": 0.1,
         "max_hellinger": 0.2, "max_js": 0.1, "mean_js": 0.05,
         "samples_per_sec": 1e6, "merlin_mean_hellinger": 0.15},
        {"net": "x", "mode": "plain", "mean_hellinger": 0.2,
         "max_hellinger": 0.4, "max_js": 0.2, "mean_js": 0.1,
         "samples_per_sec": 1e6},
        {"net": "y", "mode": "plain", "error": "boom"},
    ]
    out, ref_out = io.StringIO(), io.StringIO()
    wins, losses = port_experiments.summarize(rows, out)
    assert (wins, losses) == (1, 0) == ref_experiments.summarize(rows, ref_out)
    text = out.getvalue()
    assert "ERROR: boom" in text
    assert "adaptive <= plain" in text
    assert text == ref_out.getvalue()


@pytest.mark.parametrize("mode", sorted(port_experiments.MODES))
def test_run_one_on_a_written_net(tmp_path, mode):
    """Each mode drives the port's engine on the CPU and reports scores."""
    _write_net(tmp_path, "grid3")
    r = port_experiments.run_one(str(tmp_path), "grid3", mode, secs=1.0, vchains=32, seed=3,
                                 burnin=90, cwin=180, device="cpu",
                                 trace_dir=str(tmp_path / "traces"))
    assert "error" not in r, r
    assert r["samples"] > 0 and r["mean_hellinger"] < 0.1 and r["device"] == "cpu"
    assert r["chains"] >= 32 * port_experiments.MODES[mode]["chains"]
    assert port_ref300.parse_trace_csv(str(tmp_path / "traces" / f"grid3_{mode}.trace"))


def test_experiments_run_and_summary(tmp_path, capsys):
    _write_net(tmp_path, "grid3")
    assert port_experiments.suite_nets(str(tmp_path)) == ["grid3"]
    out = str(tmp_path / "acc.jsonl")
    rc = port_experiments.main(["--res", str(tmp_path), "--secs", "1", "--vchains", "16",
                                "--modes", "plain,rnd", "--device", "cpu", "--out", out])
    assert rc == 0
    rows = [json.loads(ln) for ln in open(out)]
    assert [r["mode"] for r in rows] == ["plain", "rnd"]
    assert all("error" not in r and r["device"] == "cpu" and "pallas" not in r for r in rows)
    assert rows[0]["mean_hellinger"] < 0.1 and rows[1]["collapsed"] >= 1
    assert "| grid3 | plain |" in open(str(tmp_path / "acc.md")).read()
    # a net that cannot run is itself a result
    bad = port_experiments.run_one(str(tmp_path), "absent", "plain", 1.0, 16, 1, device="cpu")
    assert bad["error"].startswith("FileNotFoundError")


def test_experiments_says_when_the_nets_are_absent(tmp_path, capsys):
    assert port_experiments.main(["--res", str(tmp_path / "none")]) == 1
    assert "GRAMPLE_RES" in capsys.readouterr().err
    assert port_experiments.main(["--res", str(tmp_path), "--nets", "Grids_13"]) == 1
    assert "Grids_13" in capsys.readouterr().err


def test_suite_nets_lists_mar_nets():
    """``tests/test_experiments.py::test_suite_nets_lists_mar_nets``."""
    res_path("one.uai")  # skip when data absent
    assert port_experiments.suite_nets(RES_DIR) == ref_experiments.suite_nets(RES_DIR)


# ---- scaling, drift, profile_adaptive -----------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2])
def test_scaling_measure_on_a_virtual_mesh(tmp_path, n_dev):
    _write_net(tmp_path, "grid3")
    r = port_scaling.measure("grid3", str(tmp_path), n_dev, cpv_per_dev=16, cw=8, windows=3,
                             device="cpu")
    assert r["virtual"] and r["devices"] == n_dev and r["chains"] == 2 * 16 * n_dev
    assert r["cards"] == ["cpu"]
    assert r["chains_per_device"] == 32 and r["samples"] == r["chains"] * 8 * 3 * 9
    assert set(r) >= {"net", "windows", "cw", "sweep_secs", "samples_per_sec",
                      "reduction_secs_per_tick", "reduction_share_per_tick", "device"}
    assert 0 <= r["reduction_share_per_tick"] <= 1


def test_scaling_main(tmp_path, capsys):
    _write_net(tmp_path, "grid3")
    out = str(tmp_path / "s.jsonl")
    assert port_scaling.main(["--res", str(tmp_path), "--net", "grid3", "--counts", "1,2,3",
                              "--cpv", "8", "--cw", "4", "--windows", "2", "--device", "cpu",
                              "--out", out]) == 0
    rows = [json.loads(ln) for ln in open(out)]
    assert [r["devices"] for r in rows] == [1, 2, 3] and not any("error" in r for r in rows)
    assert port_scaling.main(["--res", str(tmp_path), "--net", "absent"]) == 1


def test_drift_rows(tmp_path, capsys):
    """Window-local counts and state occupancy agree with the cumulative
    estimate on a net that mixes: no drift, no counting bug."""
    path, _ = _write_net(tmp_path, "grid3")
    out = str(tmp_path / "d.jsonl")
    assert port_drift.main(["--res", str(tmp_path), "--net", "grid3", "--windows", "3", "--cw",
                            "40", "--chains", "64", "--burn", "40", "--device", "cpu",
                            "--out", out]) == 0
    rows = [json.loads(ln) for ln in open(out)]
    assert [r["window"] for r in rows] == [0, 1, 2] and rows[-1]["sweeps"] == 40 + 3 * 40
    assert len({r["worst_var"] for r in rows}) == 1
    for r in rows:
        assert r["max_hell_window"] < 0.1 and r["max_hell_cum"] < 0.1
        assert r["max_hell_occupancy"] < 0.2
        assert abs(r["worst_var_window0"] - r["sol_worst0"]) < 0.1
    assert port_drift.main(["--res", str(tmp_path), "--net", "absent"]) == 1


def test_drift_window_row_reads_a_sharded_group_too():
    from tests.test_torch_parallel import _sharded

    m = torch_models.build(port_pgm, "grid3")
    sol = exact_marginals(m)
    rows = []
    for g in (ChainGroup(m, 32, 20, "cpu", seed=2), _sharded(m, "2x2", 32, 20, 2)):
        g.cb = 16
        g.add_variants([m, m])
        g.burn(10)
        g.advance()
        rows.append(port_drift.window_row(g, sol, 0))
    assert rows[0] == rows[1]


def test_profile_adaptive_components(tmp_path, capsys):
    """The tool runs the adaptive engine and reads its tracer: the tick's
    direct parts and its own time share the tick time whole, and the adapt
    step's parts lie inside it."""
    path, _ = _write_net(tmp_path, "grid3")
    r = port_profile.profile(path, secs=6.0, chains=16, cw=10, adds=2, device="cpu", burn=20)
    assert r["ticks"] >= 2 and r["variants"] >= 4 and r["device"] == "cpu"
    assert r["samples"] > 0 and "use_pallas" not in r
    parts = port_profile.TICK_PARTS + ("tick.other",)
    assert all(f"secs_{k}" in r and f"share_{k}" in r
               for k in parts + port_profile.NESTED)
    assert abs(sum(r[f"share_{k}"] for k in parts) - 1.0) < 0.01
    assert r["secs_adapt.rank"] > 0 and r["secs_adapt.burn"] <= r["secs_adapt.place"]
    assert (r["secs_adapt.rank"] + r["secs_adapt.collapse"] + r["secs_adapt.place"]
            <= r["secs_tick.adapt"] + 1e-3)
    assert port_profile.main(["--res", str(tmp_path), "--net", "absent"]) == 1
    assert "GRAMPLE_RES" in capsys.readouterr().err
