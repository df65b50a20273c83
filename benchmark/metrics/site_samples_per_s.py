"""Counted site updates over the engine's whole sampling clock: burn-in,
every tick, every adapt step and the aux group (``RunResult.samples /
RunResult.runtime``)."""


def read(rec):
    r = rec["result"]
    return r.samples / r.runtime if r.runtime > 0 else None
