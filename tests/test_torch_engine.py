"""``sample -s simple`` and ``sample -s collapsed`` through the port's
Engine and CLI, held against the exact marginals, one
reference Engine run, and the reference's collapse selection."""

import json

import numpy as np
import pytest

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.pgm.encode as ref_encode
import grample_tpu.sampler.collapse as ref_collapse
import grample_tpu_torch.pgm.discrete as port_pgm
from grample_tpu.sampler.engine import Engine as RefEngine
from grample_tpu.sampler.engine import EngineConfig as RefEngineConfig
from grample_tpu_torch import cli
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.uai import read_mar_file
from grample_tpu_torch.uai.writer import write_mar, write_model

from tests import torch_models


def quiet(_msg):
    pass


def _write_net(tmp_path, name="grid3", evidence=None):
    """``<net>.uai`` (+ ``.evid``) and an exact ``.MAR``; returns (path,
    exact marginals with the evidence applied)."""
    m = torch_models.MODELS[name][0](port_pgm)
    path = str(tmp_path / f"{name}.uai")
    with open(path, "w") as fh:
        fh.write(write_model(m))
    if evidence:
        with open(path + ".evid", "w") as fh:
            fh.write(f"{len(evidence)} " + " ".join(f"{k} {v}" for k, v in evidence.items()))
        m.apply_evidence(evidence)
    truth = exact_marginals(m)
    with open(path + ".MAR", "w") as fh:
        fh.write(write_mar([truth[i, : m.cards[i]] for i in range(m.num_vars)]))
    return path, truth


def _cfg(cls, path, **kw):
    cfg = cls(model_path=path, use_solution=True, burnin=9 * 30, converge_window=9 * 50,
              chains=2, chains_per_variant=128, max_secs=600.0, max_iters=9 * 256 * 200,
              seed=42, status_secs=0.5)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def test_engine_matches_exact_and_reference(tmp_path):
    """Port and reference Engine runs on one 3x3 ``.uai``: both within
    5 sigma of the exact marginals and of each other."""
    path, truth = _write_net(tmp_path)
    port = Engine(_cfg(EngineConfig, path, device="cpu"), log=quiet).run()
    ref = RefEngine(_cfg(RefEngineConfig, path), log=quiet).run()
    cards = np.full(9, 2)
    # >= 256 chains x 200 counted sweeps; 3x3 grid mixes within ~4 sweeps:
    # n_eff >= 12800, sigma(H) ~ 1/sqrt(8 n_eff) = 3.1e-3
    bound = 5.0 / np.sqrt(8 * 12800)
    assert port.final_score.max_hellinger < bound
    assert hellinger(port.marginals, truth, cards).max() < bound
    assert hellinger(ref.marginals, truth, cards).max() < bound
    # two independent estimates: their difference has sqrt(2) x sigma
    assert hellinger(port.marginals, ref.marginals, cards).max() < np.sqrt(2) * bound
    assert port.samples >= 9 * 256 * 200 and port.chains == 256
    np.testing.assert_allclose(port.marginals.sum(axis=1), 1.0, atol=1e-9)
    assert set(port.convergence) == {"hellinger", "js", "maxabs", "meanabs"}


def test_cli_sample_outputs(tmp_path, capsys):
    """``sample -d -o -s simple`` with evidence, experiment CSV, trace
    records and ``--mar-out``."""
    path, truth = _write_net(tmp_path, "grid4_evid", {5: 1, 10: 0})
    trace, mar = str(tmp_path / "t.jsonl"), str(tmp_path / "out.MAR")
    rc = cli.main(["sample", "-m", path, "-d", "-o", "-s", "simple", "--device", "cpu",
                   "--vchains", "64", "-b", "320", "-w", "640", "-i", "100000",
                   "-e", "5", "-t", trace, "-p", "--mar-out", mar])
    assert rc == 0
    out = capsys.readouterr().out
    assert "FINAL" in out and "Wrote MAR solution" in out
    est = read_mar_file(mar)
    assert len(est) == 16
    # evidence vars are never counted: they keep each chain's uniform
    # seed, as in the reference's MergeChains
    np.testing.assert_allclose(est[5], [0.5, 0.5])
    free = [i for i in range(16) if i not in (5, 10)]
    assert hellinger(np.array(est)[free], truth[free], np.full(14, 2)).max() < 0.05
    text = open(trace).read()
    for section in ("RunSecs, MaxHell", "// EVIDENCE", "// VARS (ESTIMATED)",
                    "// OPERATING PARAMS", "// RESULT SUMMARY", "// ENTIRE MODEL"):
        assert section in text
    records = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    assert any(r.get("ID") == 5 and r["FixedVal"] == 1 for r in records)
    assert records[-1]["Type"] == "MARKOV"


@pytest.mark.parametrize("budget", ["sampling", "wall"])
def test_maxiters_and_budget_modes(tmp_path, budget):
    path, _ = _write_net(tmp_path)
    cfg = _cfg(EngineConfig, path, device="cpu", max_iters=500, budget=budget,
               chains_per_variant=32, anneal_stages=0)
    res = Engine(cfg, log=quiet).run()
    # stops at the iteration cap: one window (2 x 32 chains x 50 sweeps x
    # 9 vars) is already past 500 samples
    assert res.samples == 2 * 32 * 50 * 9
    assert res.sweeps == 30 + 50


@pytest.mark.parametrize("argv,error", [
    # the case that pinned the refusal of --distributed (ROADMAP A11b)
    pytest.param(["--distributed", "--mesh", "auto"],
                 "missing: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT", id="argv0-A11b"),
    pytest.param(["--distributed", "--mesh", "off"], "needs a device mesh", id="mesh-off"),
])
def test_unported_options_raise(tmp_path, monkeypatch, argv, error):
    """``--distributed`` without torchrun's environment names what is
    missing, and refuses ``--mesh off``; neither falls back to one process."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    path, _ = _write_net(tmp_path)
    with pytest.raises(ValueError, match=error):
        cli.main(["sample", "-m", path, "--device", "cpu", *argv])


def test_experiment_needs_trace(tmp_path):
    path, _ = _write_net(tmp_path)
    with pytest.raises(ValueError, match="trace"):
        Engine(_cfg(EngineConfig, path, device="cpu", experiment=True))


def _ref_prebuild(name, evidence, n_slots, seed):
    """The reference engine's prebuild loop (``engine.py:230-242``) on the
    same model: the collapsed var of each slot, None for a plain slot."""
    m = torch_models.MODELS[name][0](ref_pgm)
    m.apply_evidence(evidence)
    rng = np.random.default_rng(seed)
    return [ref_collapse.pick_random_collapsible(m, rng, oa_cap=ref_encode.COLLAPSE_OA_DENSE_CAP)
            for _ in range(n_slots)]


@pytest.mark.parametrize("seed", [42, 7])
def test_collapsed_engine_selection_and_outputs(tmp_path, seed):
    """``-s collapsed --device cpu``: the same vars collapsed in the same
    slots as the reference's prebuild loop for the same seed; the result's
    ``collapsed`` list, the trace's ``Collapsed`` fields and the
    experiment CSV's CollapseCount agree with them; the marginals,
    collapsed vars included, are within 5 sigma of exact."""
    name, evidence = "full8_evid", {7: 1}
    path, truth = _write_net(tmp_path, name, evidence)
    trace = str(tmp_path / "t.jsonl")
    lines = []
    cfg = _cfg(EngineConfig, path, device="cpu", sampler="collapsed", chains=4,
               use_evidence=True, burnin=8 * 40, converge_window=8 * 40,
               chains_per_variant=128, max_iters=4 * 128 * 40 * 7 * 4, seed=seed,
               trace_path=trace, experiment=True)
    res = Engine(cfg, log=lines.append).run()
    picks = _ref_prebuild(name, evidence, 4, seed)
    logged = [ln for ln in lines if "collapsed var" in ln]
    want = [f" ... chain {s + 1}: collapsed var {v} " for s, v in enumerate(picks) if v is not None]
    assert [ln.split("marginal=")[0] for ln in logged] == want
    assert res.collapsed == sorted({v for v in picks if v is not None})
    assert res.variants == 4 and res.chains == 512
    text = open(trace).read()
    csv = [ln for ln in text.splitlines() if ln[:1].isdigit()]
    assert csv and all(ln.split(", ")[-1] == str(len(res.collapsed)) for ln in csv)
    records = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"ID"')]
    assert {r["ID"] for r in records if r["Collapsed"]} == set(res.collapsed)
    summary = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"samples"')]
    assert summary[0]["collapsed"] == res.collapsed
    # >= 3 x 128 chains count each free var (a var collapsed in one slot
    # is counted by the others and, for the merge, replaced by its RB
    # mixture); 40-sweep windows, >= 5 of them, on a net that mixes
    # within ~8 sweeps: n_eff >= 384 * 200 / 8, plus at most 3e-3 of
    # bias from each chain's uniform seed
    assert res.samples >= 4 * 128 * 40 * 7 * 4
    cards = np.full(8, 2)
    h = hellinger(res.marginals, truth, cards, np.array([-1] * 7 + [1]))
    assert h.max() < 5.0 / np.sqrt(8 * 384 * 200 / 8) + 3e-3, h
    psrf = res.convergence["hellinger"]
    assert (psrf[res.collapsed] == 1.0).all()


def test_cli_collapsed_without_rb_mixture(tmp_path):
    """``--no-rb-mixture``: each collapsed var's final marginal is its
    static collapse marginal (the reference's behaviour), as logged."""
    path, _ = _write_net(tmp_path, "full8_evid", {7: 1})
    mar = str(tmp_path / "out.MAR")
    rc = cli.main(["sample", "-m", path, "-d", "-s", "collapsed", "-c", "3", "--device", "cpu",
                   "--vchains", "32", "-b", "80", "-w", "80", "-i", "20000", "-x", "1", "-e", "3",
                   "--no-rb-mixture", "--mar-out", mar])
    assert rc == 0
    est = read_mar_file(mar)
    m = torch_models.build(port_pgm, "full8_evid")
    from grample_tpu_torch.sampler.collapse import collapse_var

    for v in {v for v in _ref_prebuild("full8_evid", {7: 1}, 3, 3) if v is not None}:
        np.testing.assert_allclose(est[v], collapse_var(m, v)[1], rtol=1e-6)
