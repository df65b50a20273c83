"""Device time of every operation other than the Gibbs window kernels
(the torch ops around a launch, copies, PSRF, the RB snapshot), over the
device time of every operation, in the span."""


def read(rec):
    span = rec["span"]
    if not span or not span["device_s"]:
        return None
    return (span["device_s"] - span["gibbs_s"]) / span["device_s"]
