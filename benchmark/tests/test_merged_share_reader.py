"""CPU tests of the reader of ``merged_site_share`` (the program's
``sites.merged`` counter over ``RunResult.samples``): its number on a
hand-made record, None on a program without the counter, and its number
on a run of the program.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import tempfile
import time
from types import SimpleNamespace as NS

import pytest

from benchmark import nets, registry, run
from benchmark.tests.test_bench_harness import small

NAMES = ["merged_site_share", "merged_site_share.adaptive"]


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_hand_made_record(name):
    counters = {"sites.main": 3_000_000_000, "sites.merged": 2_400_000_000}
    rec = {"result": NS(spans={}, counters=counters, samples=3_000_000_000, runtime=10.0)}
    assert registry.reader(name)(rec) == pytest.approx(0.8, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_the_counter_reads_nothing(name):
    """A program without merged tables (the parent of the change that
    brought them) counts no ``sites.merged``: the metric is left out."""
    bare = NS(marginals=None, samples=10**12, runtime=30.0, aux_secs=0.0)
    assert registry.reader(name)({"result": bare}) is None
    other = NS(spans={}, counters={"sites.main": 10**12}, samples=10**12, runtime=30.0)
    assert registry.reader(name)({"result": other}) is None


def test_reader_on_a_run_of_the_program():
    """A simple run on the CPU at a test's size (the 4x4 grid: every site's
    blanket has at most 4 binary vars): every update is on a merged
    table."""
    cell = small("simple-c2-v131072")
    cell["net"] = nets.build(cell["config"]["net"], 5)
    with tempfile.TemporaryDirectory() as td:
        path = nets.write_uai(cell["net"], td, "net")
        rec = run.run_program(cell, path, 5, 2.0, False, time.perf_counter(), device="cpu")
    assert registry.reader("merged_site_share")(rec) == 1.0
