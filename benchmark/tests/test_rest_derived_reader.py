"""CPU tests of the reader of ``rest_derived_share`` (the program's
``sites.rest_derived`` counter over ``RunResult.samples``): its number on
a hand-made record, and None on a program without the counter or a run
off the card.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import tempfile
import time
from types import SimpleNamespace as NS

import pytest

from benchmark import nets, registry, run
from benchmark.tests.test_bench_harness import small

NAMES = ["rest_derived_share", "rest_derived_share.grid", "rest_derived_share.adaptive"]


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_hand_made_record(name):
    counters = {"sites.main": 3_000_000_000, "sites.rest_derived": 1_500_000_000}
    rec = {"result": NS(spans={}, counters=counters, samples=3_000_000_000, runtime=10.0)}
    assert registry.reader(name)(rec) == pytest.approx(0.5, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_the_counter_reads_nothing(name):
    """A program whose kernel reduces every draw's count (the parent of
    the change that derives outcome 0's) counts no
    ``sites.rest_derived``: the metric is left out."""
    bare = NS(marginals=None, samples=10**12, runtime=30.0, aux_secs=0.0)
    assert registry.reader(name)({"result": bare}) is None
    other = NS(spans={}, counters={"sites.main": 10**12}, samples=10**12, runtime=30.0)
    assert registry.reader(name)({"result": other}) is None


def test_reader_on_a_run_off_the_card():
    """A simple run on the CPU at a test's size: the plain version counts
    every outcome, so the counter is absent and the metric reads nothing."""
    cell = small("simple-c2-v131072")
    cell["net"] = nets.build(cell["config"]["net"], 5)
    with tempfile.TemporaryDirectory() as td:
        path = nets.write_uai(cell["net"], td, "net")
        rec = run.run_program(cell, path, 5, 2.0, False, time.perf_counter(), device="cpu")
    assert rec["result"].samples > 0
    assert registry.reader("rest_derived_share")(rec) is None
