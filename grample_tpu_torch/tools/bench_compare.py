"""A/B comparison of two bench result JSON lines.

The reference compares benchmark runs across revisions with
``script/bench-cmp`` (git stash + benchstat).  Here rounds persist their
bench output as JSON (``BENCH_r{N}.json``), so the A/B protocol is a
diff of artifacts:

    python -m grample_tpu_torch.tools.bench_compare BENCH_r01.json BENCH_r02.json
"""

from __future__ import annotations

import json
import sys


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = float(v)
    return out


def compare(a: dict, b: dict, out=sys.stdout) -> None:
    fa, fb = _flat(a), _flat(b)
    keys = sorted(set(fa) | set(fb))
    out.write(f"{'metric':<58} {'A':>14} {'B':>14} {'delta':>9}\n")
    for k in keys:
        va, vb = fa.get(k), fb.get(k)
        if va is None or vb is None:
            out.write(f"{k:<58} {va if va is not None else '-':>14} "
                      f"{vb if vb is not None else '-':>14} {'':>9}\n")
            continue
        delta = "" if va == 0 else f"{(vb - va) / abs(va) * 100:+8.1f}%"
        out.write(f"{k:<58} {va:>14,.4g} {vb:>14,.4g} {delta:>9}\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 2
    with open(argv[0]) as fa, open(argv[1]) as fb:
        compare(json.load(fa), json.load(fb))
    return 0


if __name__ == "__main__":
    sys.exit(main())
