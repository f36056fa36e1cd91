"""The B1/B2 (fused superstep) roofline of a stretch of supersteps.

Frozen from `chip_smoke.py`'s `live_bound` and the program's
`launch/cost.py` (`fused_live_bytes`, `fused_live_flops`); nothing of
the program is imported.  The least bytes a call moves: the tiles of its
live pairs (a live pair's source block was selected), each read once,
the d rows of the selected source blocks, and the [J, B_N, Vb] state in
and out (plus-times: base and out; min-plus: base, values and both
outputs) with the [J, B_N] (node_un, p_sum) it writes.  The src array,
run and chunk tables and the [B_N] mask are left out (under 1% of a
call's bytes at either width), so the bound can only read low.
Operations: a [Vb] row times a [Vb, Vb] tile for every job slot of the
view and every live pair.

The bound is the larger of bytes over the HBM rate and operations over
the float32 rate outside the tensor cores, both the published peaks of
one H100 SXM (NVIDIA's data sheet, 700 W).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: state tensors a call reads and writes, by semiring
STATE_TENSORS = {"plus_times": 2, "min_plus": 4}


def fused_bytes(vb: int, jobs: int, num_blocks: int, semirings,
                supersteps: int, tile_loads: int,
                tile_pair_loads: int) -> int:
    """Bytes of every B1/B2 call of `supersteps` shared supersteps: one
    call a view (`semirings`, one entry a view) a superstep, `tile_loads`
    selected source blocks summed over the supersteps, and
    `tile_pair_loads` live pairs summed over supersteps and views."""
    tiles = 4 * vb * vb * tile_pair_loads
    d_rows = 4 * jobs * vb * tile_loads * len(semirings)
    state = supersteps * sum(
        4 * jobs * num_blocks * vb * STATE_TENSORS[s] + 8 * jobs * num_blocks
        for s in semirings)
    return tiles + d_rows + state


def fused_flops(vb: int, jobs: int, tile_pair_loads: int) -> float:
    return 2.0 * jobs * vb * vb * tile_pair_loads


def bound_s(nbytes: float, flops: float):
    """(least seconds, "bytes" or "operations", whichever bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
