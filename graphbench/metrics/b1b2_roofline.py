"""B1/B2's share of their roofline over the traced polls: the least time
of every call (graphbench/roofline.py: the live pairs' tiles once, the
selected d rows and the state, against 2 x J x Vb^2 operations a live
pair) over the kernels' device time in the trace."""

from graphbench import roofline


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("b1b2_s"):
        return None
    nbytes = roofline.fused_bytes(
        rec["vb"], rec["capacity"], rec["num_blocks"], rec["semirings"],
        t["supersteps"], t["tile_loads"], t["tile_pair_loads"])
    flops = roofline.fused_flops(rec["vb"], rec["capacity"],
                                 t["tile_pair_loads"])
    least, _ = roofline.bound_s(nbytes, flops)
    return 100.0 * least / t["b1b2_s"]
