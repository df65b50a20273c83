"""The whole engine tick's share of the cards' peak: the span's least time
for its counted site updates over the span's wall times the cards, in %."""

from benchmark.count import least_seconds


def read(rec):
    span = rec["span"]
    if not span or not rec.get("peak_ops") or rec["span_sites"] <= 0:
        return None
    least, _ = least_seconds(rec["net"], rec["span_sites"], rec["cw_sweeps"],
                             rec["peak_ops"], rec["peak_bytes_per_s"])
    return 100.0 * least / (span["wall"] * rec["n_devices"])
