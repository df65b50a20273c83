"""The greatest ``torch.cuda.max_memory_allocated()`` over the cell's
cards through set-up and burn-in, read at the engine's first monitor
update, before any adapt step, in GB (1e9 bytes).  On a mesh the whole
run's peak rides on which vars the clock-placed adapt steps collapse;
this stage's peak is set by the sizes alone.  The whole run's peak is the
line's ``device.memory_peak_bytes``."""


def read(rec):
    return rec["burnin_peak_bytes"] / 1e9 if rec.get("burnin_peak_bytes") else None
