"""UAI format writers: model files and MAR solution output.

The reference never writes UAI files (it only prints JSON traces), but a
complete framework needs round-trip I/O: test fixtures are generated with
:func:`write_model`, and :func:`write_mar` emits the standard competition
MAR result line so downstream tools (and our golden tests) can consume
estimates.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from grample_tpu_torch.pgm.discrete import DiscreteModel


def write_model(m: DiscreteModel) -> str:
    lines: List[str] = [m.type, str(m.num_vars), " ".join(str(int(c)) for c in m.cards)]
    lines.append(str(len(m.factors)))
    for f in m.factors:
        lines.append(f"{f.scope.size} " + " ".join(str(int(v)) for v in f.scope))
    for f in m.factors:
        if f.is_log:
            raise ValueError(f"factor {f.name} is in log space; write linear tables")
        lines.append("")
        lines.append(str(f.table.size))
        lines.append(" ".join(format(x, ".17g") for x in f.table))
    return "\n".join(lines) + "\n"


def write_mar(marginals: Sequence[np.ndarray]) -> str:
    """One-line MAR section: 'MAR <nvars> <card p...> ...'."""
    parts: List[str] = ["MAR", str(len(marginals))]
    for mar in marginals:
        mar = np.asarray(mar, dtype=np.float64)
        parts.append(str(mar.size))
        parts.extend(format(float(p), ".8g") for p in mar)
    return " ".join(parts) + "\n"


def write_evidence(assignments: dict) -> str:
    """Single-sample evidence file (2-line form)."""
    items = sorted(assignments.items())
    line = f"{len(items)} " + " ".join(f"{k} {v}" for k, v in items)
    return f"1\n{line.strip()}\n"
