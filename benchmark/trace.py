"""The run's records: a monitor object handed to the engine, its log, and the
profiled span of a ``--trace 1`` run.

The engine calls ``update`` after burn-in and at each status tick, the
last time at the end of its loop.  :class:`SpanMonitor` keeps each call's
host time and counters, and at the first call the peak memory so far: the
peak of set-up and burn-in, which the sizes set and the clock does not
(no adapt step has run).  With ``profile`` set, ``torch.profiler`` records
CUDA activity alone (no host ops, stacks or shapes, which would slow the
host's ticks and so change the adapt schedule), kept in memory, from
before the engine's set-up.  Every call and every engine log line
enqueues a marker on the first card: a spin kernel of a few cycles, whose
place in the device's order the trace keeps, and whose label the monitor
keeps in the same order.  The span is the stretch between the first and
the last call's markers.  :func:`reduce_span` turns the trace into sums
clipped to the span: device time by kernel name, busy time (the union of
device intervals) by card, and the longest idle gaps of the first card,
each named by the log lines whose markers lie around it.
"""

from __future__ import annotations

import re
import sys
import time

import torch

#: a kernel of the Gibbs window (both forms: thread per chain and
#: site-parallel), by its name in the trace
GIBBS_KERNEL = re.compile(r"gibbs_window")
#: the marker kernel (``torch.cuda._sleep``), by its name in the trace
MARK_KERNEL = re.compile(r"spin_kernel")
MARK_CYCLES = 1000
TICK = "bench.tick"
LOG = "bench.log: "
ADAPT_LINE = re.compile(r"^ADAPT: .* in ([0-9.]+) s$")


class SpanMonitor:
    """The engine's monitor: host times and counters at each update, the
    engine's log lines, and (``profile``) the profiler, started here,
    before the engine's set-up: its own start takes seconds, which must not
    fall inside the sampling clock."""

    def __init__(self, devices, profile: bool = False):
        self.devices = list(devices)
        self.updates = []  # (host perf_counter, iterations) at each update
        self.lines = []  # (host perf_counter, engine log line)
        self.marks = []  # the label of each marker, in the order enqueued
        self.prof = None
        self._vars = {"iterations": 0}
        self.burnin_peak = 0  # max_memory_allocated over the cards at the first update
        if profile and self.devices:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()

    def update(self, **kw):
        self._vars.update(kw)
        self.updates.append((time.perf_counter(), int(self._vars["iterations"])))
        if len(self.updates) == 1:
            self.burnin_peak = max((torch.cuda.max_memory_allocated(d) for d in self.devices),
                                   default=0)
        self._mark(TICK)

    def log(self, line: str):
        self.lines.append((time.perf_counter(), line))
        self._mark(LOG + line[:80])
        print(line, file=sys.stderr, flush=True)

    def _mark(self, label: str):
        if self.prof is not None:
            with torch.cuda.device(self.devices[0]):
                torch.cuda._sleep(MARK_CYCLES)
            self.marks.append(label)

    def stop(self):
        """Stop the profiler (after the engine's run has returned)."""
        if self.prof is not None:
            for d in self.devices:
                torch.cuda.synchronize(d)
            self.prof.stop()

    def adapt_seconds(self) -> list:
        """Host seconds of each ``ADAPT: ... in X s`` line."""
        return [float(m.group(1)) for _, line in self.lines
                for m in [ADAPT_LINE.match(line)] if m]


def _union(intervals) -> list:
    """Disjoint sorted intervals covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_span(prof, n_devices: int, marks: list, top: int = 10) -> dict:
    """Sums of the profiled span, in seconds: ``wall``; ``gibbs_s`` (device
    time of the Gibbs window kernels, all cards); ``device_s`` (device time
    of every operation, all cards); ``busy_s`` by card (union of device
    intervals); ``ops`` (the ``top`` device operations by time); ``gaps``
    (the ``top`` longest idle gaps of the first card, each named by the
    engine log lines whose markers come last before it and first after its
    start).  ``marks`` are the markers' labels in the order enqueued; the
    marker kernels themselves count as no device time.  Empty where the
    trace lacks a marker."""
    stamps, dev = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        if MARK_KERNEL.search(e.name):
            stamps.append(start)
        else:
            dev.append((start, end, e.device_index, e.name))
    stamps.sort()
    if len(stamps) != len(marks) or not dev:
        return {}
    ticks = [t for t, label in zip(stamps, marks) if label == TICK]
    logs = [(t, label[len(LOG):]) for t, label in zip(stamps, marks) if label.startswith(LOG)]
    if len(ticks) < 2:
        return {}
    t0, t1 = ticks[0], ticks[-1]
    by_name, busy, per_card = {}, {}, {}
    for a, b, d, name in dev:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        per_card.setdefault(d, []).append((a, b))
    for d, iv in per_card.items():
        busy[d] = sum(b - a for a, b in _union(iv)) / 1e6
    first = _union(per_card.get(min(per_card), [])) if per_card else []
    edges = [t0] + [x for iv in first for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]

    def named(a):
        before = [line for t, line in logs if t < a]
        after = [line for t, line in logs if t >= a]

        def short(lines, i, none):
            return re.sub(r"\s+", " ", lines[i].strip())[:28] if lines else none

        return f"after '{short(before, -1, 'start')}', before '{short(after, 0, 'end')}'"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "wall": (t1 - t0) / 1e6,
        "gibbs_s": sum(s for n, s in by_name.items() if GIBBS_KERNEL.search(n)),
        "device_s": sum(by_name.values()),
        "busy_s": [busy.get(d, 0.0) for d in range(n_devices)],
        "ops": sorted(([n[:120], s] for n, s in by_name.items()), key=lambda x: -x[1])[:top],
        "gaps": [[named(a), (b - a) / 1e6] for a, b in gaps[:top]],
    }
