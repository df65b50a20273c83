"""Find a cell's files by the names in ``BENCHMARK.json``.

Nothing here names a cell, a configuration, a traffic mix or a metric:

* ``configs[i]["file"]``: the configuration (its ``net`` and its sampler
  settings);
* ``benchmark/traffic/<traffic>.json``: the traffic mix, the engine's
  flags (sampler mode, chains, chain layout, device mesh);
* ``benchmark/workloads/<cell>.json``: the cell's limits for ``correct``;
* ``benchmark/metrics/<metric>.py``: a reader, ``read(rec)`` -> a number
  or None, for every metric of either kind.  A quantity split by the
  end-to-end metric it moves (``<metric>.<part>``, reported by other
  cells) is read by ``<metric>.py`` unless it has a file of its own;
* ``benchmark/builders/<builder>.py``: a net family's ``build(seed,
  **params)``, for a configuration whose ``net`` names a builder that
  ``nets.BUILDERS`` lacks (``nets.builder``).

A later change adds a cell, a configuration, a net builder, a traffic mix
(any ``EngineConfig`` field, ``run.engine_config``) or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return _read(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """Everything one cell needs: its ``BENCHMARK.json`` entry, its
    configuration, its traffic mix, its limits, and the metrics it reports
    with ``--trace 0`` (``end_to_end``) and ``--trace 1`` (``per_layer``)."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    here = os.path.join(root, "benchmark")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {
        "entry": entry,
        "config": config(entry["config"], root),
        "traffic": _read(os.path.join(here, "traffic", entry["traffic"] + ".json")),
        "limits": _read(os.path.join(here, "workloads", name + ".json"))["limits"],
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
    }


def config(name: str, root: str = ROOT) -> dict:
    """The configuration file of ``configs`` entry ``name``."""
    entry = next(c for c in benchmark(root)["configs"] if c["name"] == name)
    return _read(os.path.join(root, entry["file"]))


def load(subdir: str, name: str, attr: str, root: str = ROOT):
    """``attr`` of the module file ``<root>/benchmark/<subdir>/<name>.py``."""
    path = os.path.join(root, "benchmark", subdir, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{subdir}_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, attr)


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``, or of
    the file of the quantity that ``<metric>`` splits."""
    own = os.path.exists(os.path.join(root, "benchmark", "metrics", metric + ".py"))
    return load("metrics", metric if own else metric.split(".")[0], "read", root)
