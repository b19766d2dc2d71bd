"""Host milliseconds a frame inside the context steps' spans (``ctx``,
architectures/elic.py:ctx_spans) of the traced decode: the time the host
spends queueing ELIC's ten dependent steps and their K2 launches, over
the traced clip's frames.  None where the trace holds no such span (a
program without them)."""


def read(ctx):
    trace = ctx["trace"]
    part = trace and trace["decode"]
    if not part:
        return None
    spans = [(a, b) for name, a, b in part["spans"] if name == "ctx"]
    if not spans or not trace["frames"]:
        return None
    return sum(b - a for a, b in spans) / 1e3 / trace["frames"]
