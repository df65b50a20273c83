"""Seconds from before torch and the port are imported until the engine's
sampling clock starts: the wall to the engine's last tick, less
``RunResult.runtime``."""


def read(rec):
    return rec["setup_s"]
