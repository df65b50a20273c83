"""Seconds of the engine's set-up before its first launch: reading the net
(``setup.load``) and building the chain group (``setup.build``: caps,
encoding, the kernel's tensors, the copies to the card, the chains'
initial states), from the program's tracer (``RunResult.spans``)."""


def read(rec):
    spans = getattr(rec["result"], "spans", None)
    if not spans or "setup.build" not in spans:
        return None
    return spans.get("setup.load", {}).get("total_s", 0.0) + spans["setup.build"]["total_s"]
