"""Reference-300s operating-point analysis (VERDICT r3 #4).

Reads the 300 s acceptance rows (``results/ref300.jsonl``) and the
per-run experiment traces (``results/traces300/<net>_<mode>.trace``,
reference ``--experiment`` CSV schema ``cmd/root.go:457``) and writes a
markdown analysis: final scores vs merlin, the max-Hellinger time
series (plateau curves), and the adaptive-vs-plain comparison at the
reference operating point.

    python -m grample_tpu_torch.tools.ref300 [--rows results/ref300.jsonl]
        [--traces results/traces300] [--out results/ref300.md]
"""

from __future__ import annotations

import argparse
import json
import os


def parse_trace_csv(path: str):
    """[(runsecs, max_hell, max_js, ncollapsed)] from a trace file."""
    rows = []
    in_csv = False
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith("// EXPERIMENT RESULTS"):
                in_csv = True
                continue
            if not in_csv or line.startswith("RunSecs"):
                continue
            if line.startswith("//"):
                break
            parts = [p.strip() for p in line.split(",")]
            if len(parts) < 6:
                continue
            rows.append((float(parts[0]), float(parts[1]), float(parts[3]),
                         int(parts[5])))
    return rows


def sparkline(vals, width: int = 32) -> str:
    """Coarse text sparkline of a series (resampled to ``width``)."""
    if not vals:
        return ""
    blocks = "▁▂▃▄▅▆▇█"
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(blocks[int((v - lo) / span * 7)] for v in vals)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows", default="results/ref300.jsonl")
    ap.add_argument("--traces", default="results/traces300")
    ap.add_argument("--out", default="results/ref300.md")
    args = ap.parse_args(argv)

    rows = [json.loads(line) for line in open(args.rows)]
    by_key = {(r["net"], r["mode"]): r for r in rows if "error" not in r}

    with open(args.out, "w") as out:
        out.write(
            "# Reference 300 s operating point (script/experiment shape)\n\n"
            "| net | mode | meanHell | maxHell | merlin meanHell | "
            "collapsed | samples/s | aux s |\n|---|---|---|---|---|---|---|---|\n"
        )
        for r in rows:
            if "error" in r:
                out.write(f"| {r['net']} | {r['mode']} | ERROR: {r['error']} "
                          "| | | | | |\n")
                continue
            out.write(
                f"| {r['net']} | {r['mode']} | {r['mean_hellinger']:.4f} "
                f"| {r['max_hellinger']:.4f} "
                f"| {r.get('merlin_mean_hellinger', float('nan')):.4f} "
                f"| {r['collapsed']} | {r['samples_per_sec']:,.0f} "
                f"| {r.get('aux_secs', 0):.0f} |\n"
            )

        out.write("\n## Plateau curves (max Hellinger over run seconds)\n\n")
        for (net, mode), r in sorted(by_key.items()):
            tp = os.path.join(args.traces, f"{net}_{mode}.trace")
            if not os.path.exists(tp):
                continue
            series = parse_trace_csv(tp)
            if not series:
                continue
            mh = [s[1] for s in series]
            half = mh[len(mh) // 2]
            out.write(
                f"- **{net} {mode}**: `{sparkline(mh)}` "
                f"start {mh[0]:.3f} → half-budget {half:.3f} → "
                f"final {mh[-1]:.3f} "
                f"(ticks {len(mh)}, collapsed {series[-1][3]})\n"
            )

        out.write("\n## Adaptive vs plain at 300 s\n\n")
        for net in sorted({n for n, _ in by_key}):
            a = by_key.get((net, "adaptive"))
            p = by_key.get((net, "plain"))
            if not (a and p):
                continue
            verdict = "adaptive <= plain" if (
                a["max_hellinger"] <= p["max_hellinger"]) else "plain < adaptive"
            mer = a.get("merlin_mean_hellinger")
            beats = (
                f"; adaptive {'beats' if a['mean_hellinger'] <= mer else 'trails'}"
                f" merlin ({a['mean_hellinger']:.4f} vs {mer:.4f})"
                if mer is not None else ""
            )
            out.write(
                f"- **{net}**: max Hellinger adaptive {a['max_hellinger']:.4f}"
                f" vs plain {p['max_hellinger']:.4f} → {verdict}{beats}\n"
            )
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
