"""Share of the measured window in which the device is idle: 1 less the
device's busy time a superstep in the traced stretch (the union of its
operations, from the profiler) over the window's wall time a superstep
(host clock, no profiler running)."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("has_device") or not t["supersteps"] \
            or not rec["supersteps"]:
        return None
    busy = t["busy_s"] / t["supersteps"]
    wall = rec["window_s"] / rec["supersteps"]
    return 100.0 * (1.0 - busy / wall)
