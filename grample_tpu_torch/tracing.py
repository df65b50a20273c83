"""The engine's tracer: named spans and counters, kept in memory.

One ``Tracer`` belongs to one engine run; its chain groups and the
adaptive controller record into it.  It is always on, and is the only
timing scheme on the engine's path: the budget clock, the ``ADAPT`` line's
seconds, the split group's aux seconds and the set-up parts all read it.

**Spans.**  ``tracer.span(name)`` starts a span and returns it; it ends at
``span.end()`` or, used as a context manager, at the end of the block.  A
span records its name, start and end (``time.perf_counter_ns``), its
parent (the span open when it started) and the engine tick it belongs to
(``tracer.tick``).  Per name the tracer keeps the count, the total, the
self time (duration less the time its child spans cover) and the longest,
and it keeps the raw events up to ``MAX_EVENTS`` (later ones are counted
under ``events.dropped``), so a long run holds bounded memory.

**Counters.**  ``tracer.add(name, n)``: named integers.

**No device sync.**  The module imports nothing from torch and waits for
no device: a span around asynchronous work measures its enqueue.  The
engine's spans that end in the program's own sync are ``tick.flush``,
``tick.aux`` (inside ``tick.flush``), ``tick.rb``, ``adapt.rank`` and
``setup.warmup``.

**The clock.**  ``perf_counter_ns`` reads CLOCK_MONOTONIC on Linux.
``torch.profiler``'s kineto timestamps are on the unix clock instead
(``time.time_ns``): ``calibrate`` reads the two clocks together and keeps
their difference, ``wall_offset_ns``, so that a span's ``start +
wall_offset_ns`` lies on a profiler trace's absolute time line.
"""

from __future__ import annotations

import time
from collections import namedtuple
from typing import Dict, List, Optional

#: raw events a tracer keeps; later ones are counted, not kept
MAX_EVENTS = 100_000

#: one finished span: ``id`` and ``parent`` (-1 for none) number spans in
#: the order they started; times in ``perf_counter_ns``
Event = namedtuple("Event", "id name start_ns end_ns parent tick")


def clock() -> float:
    """The tracer's clock in seconds: ``perf_counter_ns`` / 1e9."""
    return time.perf_counter_ns() / 1e9


class Span:
    """One open span; ``end()`` (or the end of its ``with`` block) closes it."""

    __slots__ = ("tracer", "name", "id", "parent", "tick", "start_ns", "end_ns", "child_ns")

    def __init__(self, tracer: "Tracer", name: str, parent: Optional["Span"]):
        self.tracer = tracer
        self.name = name
        self.id = tracer._next_id
        self.parent = parent
        self.tick = tracer.tick
        self.child_ns = 0
        self.end_ns: Optional[int] = None
        self.start_ns = time.perf_counter_ns()

    @property
    def seconds(self) -> float:
        """The span's duration (to now, while it is open)."""
        end = time.perf_counter_ns() if self.end_ns is None else self.end_ns
        return (end - self.start_ns) / 1e9

    def end(self) -> int:
        """Close the span (and any span opened inside it and left open);
        returns its end on the tracer's clock, in ns."""
        if self.end_ns is None:
            self.tracer._close(self, time.perf_counter_ns())
        return self.end_ns

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class Tracer:
    """Spans and counters of one run (see the module doc)."""

    def __init__(self):
        self.tick = 0  # the engine's tick index: 0 during set-up and burn-in
        self.counters: Dict[str, int] = {}
        self.events: List[Event] = []
        self.wall_offset_ns = 0
        self._agg: Dict[str, list] = {}  # name -> [n, total_ns, self_ns, max_ns]
        self._open: List[Span] = []
        self._next_id = 0

    # ---- spans -------------------------------------------------------------
    def span(self, name: str) -> Span:
        """Start span ``name``, a child of the innermost open span."""
        sp = Span(self, name, self._open[-1] if self._open else None)
        self._next_id += 1
        self._open.append(sp)
        return sp

    def _close(self, sp: Span, now: int) -> None:
        while self._open and self._open[-1] is not sp:
            self._open[-1].end()  # a child left open ends with its parent
        if self._open:
            self._open.pop()
        sp.end_ns = now
        dur = now - sp.start_ns
        if sp.parent is not None:
            sp.parent.child_ns += dur
        agg = self._agg.get(sp.name)
        if agg is None:
            agg = self._agg[sp.name] = [0, 0, 0, 0]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - sp.child_ns
        agg[3] = max(agg[3], dur)
        if len(self.events) < MAX_EVENTS:
            self.events.append(Event(sp.id, sp.name, sp.start_ns, now,
                                     -1 if sp.parent is None else sp.parent.id, sp.tick))
        else:
            self.add("events.dropped")

    def total(self, name: str) -> float:
        """Seconds of every finished span ``name`` (0 where none)."""
        agg = self._agg.get(name)
        return agg[1] / 1e9 if agg else 0.0

    def count(self, name: str) -> int:
        """Finished spans ``name``."""
        agg = self._agg.get(name)
        return agg[0] if agg else 0

    def spans(self) -> Dict[str, dict]:
        """Per span name: ``n``, ``total_s``, ``self_s`` and ``max_s``."""
        return {name: {"n": n, "total_s": tot / 1e9, "self_s": own / 1e9, "max_s": top / 1e9}
                for name, (n, tot, own, top) in self._agg.items()}

    # ---- counters and the clock --------------------------------------------
    def add(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def calibrate(self) -> int:
        """Read the unix clock and the tracer's together (the closest of a
        few pairs) and keep ``wall_offset_ns``, their difference."""
        best = None
        for _ in range(5):
            a = time.perf_counter_ns()
            wall = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, wall - (a + b) // 2)
        self.wall_offset_ns = best[1]
        return self.wall_offset_ns
