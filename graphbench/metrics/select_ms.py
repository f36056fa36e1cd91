"""Host ms a superstep in the policy's `select` (DO queues and the
global queue on the host), over the measured window, in which no
profiler runs.  Nothing for a policy that selects on the device."""


def read(rec):
    sp = rec["spans"].get("select")
    if not sp or not sp[1] or not rec["supersteps"]:
        return None
    return 1e3 * sp[0] / rec["supersteps"]
