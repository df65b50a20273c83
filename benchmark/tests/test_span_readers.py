"""CPU tests of the readers of the program's spans and counters
(``benchmark/metrics``): their numbers on a hand-made record, None on a
program without the tracer, and numbers from a run of the program.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import time
from types import SimpleNamespace as NS

import pytest

from benchmark import registry, run
from benchmark.tests.test_bench_harness import small

#: the metrics that read ``RunResult.spans`` and ``RunResult.counters``
READERS = ["setup_build_s", "setup_warmup_s", "setup_aux_s", "host_bound_share",
           "host_bound_share.adaptive", "rb_snapshot_s", "adapt_rank_s", "adapt_collapse_s",
           "adapt_place_s", "adapt_burn_s", "aux_sites_share", "folded_share",
           "folded_share.adaptive"]


def span(total, self_s=None, n=1):
    return {"n": n, "total_s": total, "self_s": total if self_s is None else self_s,
            "max_s": total}


#: a run of 10 s of clock and 4e9 claimed updates
SPANS = {"setup": span(6.0, 0.5), "setup.load": span(0.25), "setup.build": span(2.0),
         "setup.warmup": span(1.5), "setup.aux": span(1.75, 1.5), "setup.aux.spec": span(0.25),
         "tick": span(9.0, 0.25, 4), "tick.launch": span(0.5, n=4),
         "tick.flush": span(7.5, 4.5, 4), "tick.aux": span(3.0, n=4), "tick.rb": span(0.25, n=4),
         "tick.adapt": span(1.0, n=2), "adapt.rank": span(0.125, n=2),
         "adapt.collapse": span(0.25, n=2), "adapt.place": span(0.5, 0.375, 2),
         "adapt.burn": span(0.125, n=2)}
COUNTERS = {"sites.main": 3_000_000_000, "sites.aux": 1_000_000_000,
            "sites.folded": 3_000_000_000}
EXPECTED = {"setup_build_s": 2.25, "setup_warmup_s": 1.5, "setup_aux_s": 1.75,
            "host_bound_share": 0.1, "host_bound_share.adaptive": 0.1, "rb_snapshot_s": 0.25,
            "adapt_rank_s": 0.125, "adapt_collapse_s": 0.25, "adapt_place_s": 0.375,
            "adapt_burn_s": 0.125, "aux_sites_share": 0.25, "folded_share": 0.75,
            "folded_share.adaptive": 0.75}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_made_record(name):
    rec = {"result": NS(spans=SPANS, counters=COUNTERS, samples=4_000_000_000, runtime=10.0)}
    assert registry.reader(name)(rec) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_tracer_reads_nothing(name):
    """The parent's ``RunResult`` has no spans or counters, a simple run no
    adapt, aux or split spans: the metric is left out, nothing raises."""
    bare = NS(marginals=None, samples=10**12, runtime=30.0, aux_secs=0.0)
    assert registry.reader(name)({"result": bare}) is None
    simple = NS(spans={"tick": span(1.0)}, counters={}, samples=10**12, runtime=30.0)
    assert registry.reader(name)({"result": simple}) is None or name.startswith("host_bound")


def test_readers_on_a_run_of_the_program(monkeypatch):
    """An adaptive run on the CPU at a test's size, the split group forced:
    every reader of the adaptive cell gives a number, all updates are
    folded, and the adapt steps' parts sum to their ``ADAPT`` lines'
    seconds within the lines' rounding."""
    import dataclasses
    import tempfile

    from benchmark import nets

    config = run.engine_config
    monkeypatch.setattr(run, "engine_config", lambda *a: dataclasses.replace(
        config(*a), status_secs=0.25, split_group="on"))
    cell = small("adaptive-c2-v8192-a4")
    cell["net"] = nets.build(cell["config"]["net"], 5)
    with tempfile.TemporaryDirectory() as td:
        path = nets.write_uai(cell["net"], td, "net")
        rec = run.run_program(cell, path, 5, 3.0, False, time.perf_counter(), device="cpu")
    mine = [m["name"] for m in registry.cell("promedus916-adaptive")["per_layer"]
            if m["name"] in READERS]
    values = {name: registry.reader(name)(rec) for name in mine}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["folded_share.adaptive"] == 1.0
    assert 0 < values["aux_sites_share"] < 1 and values["host_bound_share.adaptive"] < 1
    parts = sum(values[f"adapt_{p}_s"] for p in ("rank", "collapse", "place", "burn"))
    assert rec["adapt_s"] and abs(parts - sum(rec["adapt_s"])) <= 5e-4 * len(rec["adapt_s"])
