"""Host ms a superstep inside `sess.run` (the drivers), over the measured
window, in which no profiler runs."""


def read(rec):
    if not rec["supersteps"] or "run" not in rec["spans"]:
        return None
    return 1e3 * rec["spans"]["run"][0] / rec["supersteps"]
