"""The port's benchmark harness (``grample_tpu_torch.bench``) against the
JAX package's (``bench.py`` at the repository root), on the CPU at tiny
sizes: the anchor leg's score, the chain-cap rule, the throughput and
engine legs' keys under the stated mapping, ``main()``'s one JSON line,
the device knob, and the operation count of ``ops/bound.py``."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

import bench as ref_bench
import grample_tpu.sampler.chains as ref_chains
import grample_tpu.uai as ref_uai
import grample_tpu_torch.native as port_native
from grample_tpu_torch import bench
from grample_tpu_torch.ops.bound import site_operations
from grample_tpu_torch.uai.writer import write_mar

from tests.test_torch_engine import _write_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NET, EVIDENCE = "grid4_evid", {5: 1, 10: 0}

#: the reference's top-level keys (``bench.py:293-306``) but ``skipped``,
#: which both print only when a leg was skipped
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline", "detail", "wall_s",
            "wall_budget_s"}

#: the reference's throughput keys and the port's, as the module
#: docstring maps them
THROUGHPUT_KEYS = {"tpu_samples_per_sec": "device_samples_per_sec", "pallas": "route",
                   "est_flops_per_site": "est_ops_per_site", "est_tflops": "est_tops",
                   "platform": "device"}

#: the reference's engine keys with a merlin solution (``bench.py:178-194``)
ENGINE_KEYS = {"engine_samples_per_sec", "engine_budget_secs", "samples", "chains",
               "collapsed_vars", "mean_hellinger", "max_hellinger", "merlin_mean_hellinger",
               "merlin_max_hellinger", "beats_merlin_mean"}

#: max Hellinger of the CPU engine leg against exact: one 2000-sweep
#: window of 2 x 256 chains is about 1e6 correlated draws a var (sigma
#: about 4e-4 for independent draws, a few times that for these); a
#: wrong table lookup shows as 0.1 and more
ENGINE_HELL_BOUND = 0.01


@pytest.fixture
def res(tmp_path, monkeypatch):
    """``grid4_evid`` with its exact ``.MAR`` in a fresh ``GRAMPLE_RES``,
    read by both benches' phases at call time."""
    _, truth = _write_net(tmp_path, NET, EVIDENCE)
    for mod in (bench, ref_bench):
        monkeypatch.setattr(mod, "RES", str(tmp_path))
    monkeypatch.setattr(bench, "DEVICE", "cpu")
    return tmp_path, truth


def _env(res_dir, **knobs):
    env = dict(os.environ, GRAMPLE_RES=str(res_dir), BENCH_DEVICE="cpu", JAX_PLATFORMS="cpu")
    env.update({k: str(v) for k, v in knobs.items()})
    return env


def _one_line(cmd, env):
    """Run a bench's ``main()``; its standard output must be exactly one
    JSON line."""
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


# ---- the legs ----------------------------------------------------------------

def test_anchor_leg_equals_reference(res, monkeypatch):
    """The same C++ source on the same seed: the same counts, so the same
    score to the last rounded digit."""
    if port_native.load() is None:
        pytest.skip("no C++ compiler: the native tier is unavailable")
    for mod in (bench, ref_bench):
        monkeypatch.setattr(mod, "ANCHOR_SAMPLES", 200_000)
    mine, ref = bench.phase_anchor(NET, 0.0), ref_bench.phase_anchor(NET, 0.0)
    assert set(mine) == set(ref) == {"anchor_samples_per_sec", "anchor_mean_hellinger"}
    assert mine["anchor_mean_hellinger"] == ref["anchor_mean_hellinger"]
    assert mine["anchor_samples_per_sec"] > 0


class _Chains(Exception):
    """Raised by a stand-in ``ChainGroup`` with the chain count it got."""


@pytest.mark.parametrize("num_vars,card,want", [
    (916, 2, 131072), (101, 2, 262144), (16, 2, 262144), (2000, 2, 65536),
    (100000, 16, 1024)])
def test_chain_cap_equals_reference(monkeypatch, num_vars, card, want):
    """``bench_chains`` gives the chain count the reference's inline loop
    (``bench.py:108-111``) gives, read from the ``ChainGroup`` it builds."""
    def group(model, chains_per_variant, **kw):
        raise _Chains(chains_per_variant)

    monkeypatch.setattr(ref_bench, "CHAINS", 262144)
    monkeypatch.setattr(ref_uai, "load_model", lambda path, use_evidence: types.SimpleNamespace(
        num_vars=num_vars, max_card=card))
    monkeypatch.setattr(ref_chains, "ChainGroup", group)
    with pytest.raises(_Chains) as got:
        ref_bench.phase_throughput("any", 0.0)
    assert got.value.args[0] == want
    assert bench.bench_chains(num_vars, card, 262144) == want


def test_throughput_leg_on_cpu(res, monkeypatch):
    """The kernel route (its plain version on the CPU), a rate, the
    operation count of ``ops/bound.py``, and the reference's keys under
    the mapping."""
    for mod in (bench, ref_bench):
        monkeypatch.setattr(mod, "CHAINS", 256)
    mine = bench.phase_throughput(NET, 0.0)
    ref = ref_bench.phase_throughput(NET, 0.0)
    assert set(mine) == {THROUGHPUT_KEYS[k] for k in ref} | {"launches_by_form"}
    assert mine["route"] == "kernel" and mine["device"] == "cpu"
    assert mine["device_samples_per_sec"] > 0
    assert mine["est_ops_per_site"] == site_operations(2, count=True) == 40
    assert mine["est_tops"] == round(mine["device_samples_per_sec"] * 40 / 1e12, 2)
    assert mine["launches_by_form"] == {}  # the plain version launches no kernel


def test_engine_leg_on_cpu(res, monkeypatch):
    """The adaptive engine leg with ``.MAR`` and ``.merlin.MAR`` both
    exact: the reference's keys plus ``kernel``, and the marginals close
    to exact."""
    res_dir, truth = res
    cards = [2] * truth.shape[0]
    with open(res_dir / f"{NET}.uai.merlin.MAR", "w") as fh:
        fh.write(write_mar([truth[i, : cards[i]] for i in range(len(cards))]))
    monkeypatch.setattr(bench, "ENGINE_VCHAINS", 256)
    out = bench.phase_engine(NET, 2.0)
    assert set(out) == ENGINE_KEYS | {"kernel"}
    assert out["kernel"] is True and out["chains"] == 2 * 256
    assert out["samples"] > 0 and out["engine_budget_secs"] == 2.0
    assert out["max_hellinger"] < ENGINE_HELL_BOUND
    assert out["merlin_max_hellinger"] == out["merlin_mean_hellinger"] == 0.0
    assert out["beats_merlin_mean"] is (out["mean_hellinger"] <= 0.0)


# ---- main() and the phases' processes ----------------------------------------

def test_main_without_nets_prints_one_line(tmp_path):
    """No net in ``GRAMPLE_RES``: one line, no value, the reference's keys."""
    env = _env(tmp_path, BENCH_NETS=NET)
    mine = _one_line([sys.executable, "-m", "grample_tpu_torch.bench"], env)
    ref = _one_line([sys.executable, os.path.join(REPO, "bench.py")], env)
    assert set(mine) == set(ref) == TOP_KEYS
    assert mine["value"] is None and mine["vs_baseline"] is None and mine["detail"] == {}
    assert mine["unit"] == "samples/s/gpu" and mine["baseline"] == ref["baseline"]


def test_main_skips_the_engine_leg_past_the_wall(tmp_path):
    """A wall that leaves the engine leg less than the reference's 30 s
    floor: the headline ratio set, the engine leg in ``skipped``."""
    _write_net(tmp_path, NET, EVIDENCE)
    env = _env(tmp_path, BENCH_NETS=NET, BENCH_CHAINS=256, BENCH_ANCHOR_SAMPLES=200_000,
               BENCH_WALL=bench.ENGINE_OVERHEAD + 60)
    out = _one_line([sys.executable, "-m", "grample_tpu_torch.bench"], env)
    assert set(out) == TOP_KEYS | {"skipped"}
    assert out["skipped"] == [f"engine:{NET}"]
    d = out["detail"][NET]
    assert "error" not in d and d["route"] == "kernel" and d["device"] == "cpu"
    assert out["value"] == d["device_samples_per_sec"] > 0
    if port_native.load() is not None:
        assert out["vs_baseline"] == round(d["device_samples_per_sec"]
                                           / d["anchor_samples_per_sec"], 1)
        assert d["speedup_vs_anchor"] == out["vs_baseline"]


def test_failed_phase_is_an_error_entry_not_retried(tmp_path, monkeypatch):
    """A phase on a net that is not there: one process, one ``error``."""
    calls = []
    real = subprocess.run
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **kw: (calls.append(a), real(
        *a, **kw))[1])
    monkeypatch.setenv("GRAMPLE_RES", str(tmp_path))
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    out = bench.run_phase_subprocess("throughput", "missing", 120)
    assert list(out) == ["error"] and out["error"].startswith("throughput failed: ")
    assert "missing.uai" in out["error"] and len(calls) == 1


def test_default_device_without_cuda_is_an_error(tmp_path, monkeypatch):
    """``BENCH_DEVICE`` unset where there is no CUDA device: the phase
    fails naming the device, and does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _write_net(tmp_path, NET, EVIDENCE)
    monkeypatch.setenv("GRAMPLE_RES", str(tmp_path))
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    out = bench.run_phase_subprocess("throughput", NET, 120)
    assert list(out) == ["error"]
    assert "BENCH_DEVICE=cuda: no CUDA device" in out["error"]


@pytest.mark.parametrize("phase", ["throughput", "engine"])
def test_device_check_comes_before_any_work(res, monkeypatch, phase):
    """The device legs refuse a missing CUDA device before they load the
    net or build anything."""
    monkeypatch.setattr(bench, "DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "_load", lambda net: pytest.fail("loaded the net"))
    with pytest.raises(RuntimeError, match="BENCH_DEVICE=cuda: no CUDA device"):
        bench.PHASES[phase](NET, 30.0)


# ---- ops/bound.py --------------------------------------------------------------

@pytest.mark.parametrize("k,count,gather,want", [
    (2, True, False, 40), (2, False, False, 39), (8, True, False, 106),
    (16, True, True, 210), (4, False, True, 65), (16, False, False, 193)])
def test_site_operations(k, count, gather, want):
    """40 operations a counted binary site (``PERF.md`` §5), and the
    values the smoke run's bounds were computed with before the count
    moved into ``ops/bound.py``."""
    assert site_operations(k, count, gather) == want
    assert want == 11 * k + 17 + count + (k if gather else 0)

