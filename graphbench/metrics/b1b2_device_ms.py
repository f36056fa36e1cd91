"""B1/B2's device time a superstep over the traced polls, in ms: the
kernels' device time in the trace (`trace.b1b2_s`) over the supersteps
the traced polls ran."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("b1b2_s") or not t.get("supersteps"):
        return None
    return 1e3 * t["b1b2_s"] / t["supersteps"]
