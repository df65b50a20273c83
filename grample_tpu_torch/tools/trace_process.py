"""Flatten a run trace's estimated-vars section to CSV with rank columns.

The counterpart of the reference's trace post-processor
(``script/trace_file_process.py``): reads the JSON records under
``// VARS (ESTIMATED)`` in a trace file, flattens each variable's
``State`` dict into columns, and appends a ``<metric>-RANK`` column for
every ``*-Error`` and ``*-Convergence`` metric (1 = smallest value;
convergence ranks tie-break on the matching error column).  These rank
columns feed the paper's convergence-vs-error rank-correlation analysis
(``res/rank_correlation.xlsx``).

Usage:
    python -m grample_tpu_torch.tools.trace_process [trace-file] > vars.csv
    (reads stdin when no file is given)
"""

from __future__ import annotations

import csv
import json
import sys
from typing import Iterable, List

SECTION = "// VARS (ESTIMATED)"


def estimated_var_records(lines: Iterable[str]) -> List[dict]:
    """Parse the estimated-vars JSON records out of a trace stream."""
    records = []
    in_section = False
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        if line.startswith("// "):
            if in_section:
                break
            in_section = line.startswith(SECTION)
            continue
        if in_section:
            records.append(json.loads(line))
    return records


def flatten(records: List[dict]) -> List[dict]:
    """Lift each record's State dict into top-level columns."""
    rows = []
    for rec in records:
        row = {k: v for k, v in rec.items() if k != "State"}
        row.update(rec.get("State", {}))
        rows.append(row)
    return rows


def add_rank_columns(rows: List[dict]) -> List[str]:
    """Append <metric>-RANK columns; returns the final column list."""
    if not rows:
        return []
    # union of keys: mixed cardinalities mean per-row SOL-MAR[c] columns
    cols = list(dict.fromkeys(k for row in rows for k in row))
    for col in list(cols):
        if col.endswith("-Error"):
            key = lambda r, c=col: float(r[c])
        elif col.endswith("-Convergence"):
            ecol = col.replace("-Convergence", "-Error")
            if ecol in rows[0]:
                key = lambda r, c=col, e=ecol: (float(r[c]), float(r[e]))
            else:
                key = lambda r, c=col: float(r[c])
        else:
            continue
        rank_col = col + "-RANK"
        for rank, row in enumerate(sorted(rows, key=key), start=1):
            row[rank_col] = rank
        cols.append(rank_col)
    return cols


def process(lines: Iterable[str], out) -> int:
    rows = flatten(estimated_var_records(lines))
    cols = add_rank_columns(rows)
    if not rows:
        return 1
    writer = csv.DictWriter(out, fieldnames=sorted(cols), restval="")
    writer.writeheader()
    writer.writerows(rows)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        with open(argv[0]) as fh:
            return process(fh, sys.stdout)
    return process(sys.stdin, sys.stdout)


if __name__ == "__main__":
    sys.exit(main())
