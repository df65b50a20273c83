"""The split group's aux seconds over the sampling clock
(``RunResult.aux_secs / RunResult.runtime``)."""


def read(rec):
    r = rec["result"]
    return r.aux_secs / r.runtime if r.aux_secs > 0 and r.runtime > 0 else None
