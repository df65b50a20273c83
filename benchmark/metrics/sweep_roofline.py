"""The span's least time (``benchmark.count.least_seconds`` for the span's
counted site updates, from the net) over the device time of the Gibbs
window kernels in the span, summed over the cards, in %."""

from benchmark.count import least_seconds


def read(rec):
    span = rec["span"]
    if not span or not span["gibbs_s"] or not rec.get("peak_ops") or rec["span_sites"] <= 0:
        return None
    least, _ = least_seconds(rec["net"], rec["span_sites"], rec["cw_sweeps"],
                             rec["peak_ops"], rec["peak_bytes_per_s"])
    return 100.0 * least / span["gibbs_s"]
