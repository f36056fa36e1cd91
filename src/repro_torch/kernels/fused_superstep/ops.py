"""Wrappers around the fused superstep kernels.

`fused_push` mirrors the engine shared-mode push exactly (consume the
selected blocks' pending deltas, push for every job, fold values), with
the push and the priority update in ONE kernel call over the view's
destination-sorted `BlockPairs`.  The fold / consume bookkeeping stays in
plain tensor ops; selection enters the kernel as identity-masked operand
rows (so padded selection slots aliasing block 0 cannot re-push it) and
as the `src_live` mask of the same blocks, whose pairs alone the kernel
stages; the jobs with a live row of those operands enter as `job_live`,
computed on the device from the very rows the kernel gets.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_superstep.kernel import fused_superstep_call


def job_live(d: torch.Tensor, semiring: str) -> torch.Tensor:
    """[J] bool: the jobs of d [J, B_N, Vb] with a row that is not the
    semiring identity (plus-times: a nonzero; min-plus: a finite value).
    A job without one contributes the identity, so the kernel skips it
    exactly.  On the device, no host read."""
    flat = d.reshape(d.shape[0], -1)
    if semiring == "plus_times":
        return flat.ne(0).any(1)
    return flat.amin(1) < float("inf")


def block_mask(sel_ids: torch.Tensor, sel_mask: torch.Tensor,
               num_blocks: int) -> torch.Tensor:
    """[q] ids + validity mask -> dense [B_N] bool (an integer scatter-max:
    torch has no bool scatter_reduce).  A padded slot (mask 0) aliasing a
    selected block leaves it selected."""
    m = torch.zeros(num_blocks, dtype=torch.int32, device=sel_ids.device)
    m.scatter_reduce_(0, sel_ids.long(), (sel_mask > 0).to(torch.int32),
                      reduce="amax")
    return m > 0


def fused_push(values: torch.Tensor, deltas: torch.Tensor, pairs,
               sel_ids: torch.Tensor, sel_mask: torch.Tensor,
               push_scale: torch.Tensor, *, semiring: str = "plus_times",
               tolerance: float = 1e-6, with_pairs: bool = False,
               gate: torch.Tensor | None = None):
    """Kernel-backed CAJS push. values/deltas [J, B_N, Vb].

    `pairs` is the view's `graph.structure.BlockPairs`.  Returns updated
    (values, deltas); with_pairs=True additionally returns the fused
    priority-pair outputs (node_un, p_sum) [J, B_N] of the POST-push
    state, zeroed on untouched destination blocks.  `gate` (a 0-dim
    device bool, None: open) reaches the kernel: a closed gate leaves
    the returned state undefined, for a caller that discards it."""
    bn = values.shape[1]
    live = block_mask(sel_ids, sel_mask, bn)
    selb = live[None, :, None]
    touched = pairs.dst_touched[None, :, None]
    meta = dict(run_start=pairs.run_start, chunk_start=pairs.chunk_start,
                chunk_run=pairs.chunk_run, src_live=live, gate=gate,
                arrivals=pairs.arrivals(), semiring=semiring,
                tolerance=tolerance)
    if semiring == "plus_times":
        raw = torch.where(selb, deltas, 0.0)
        d = raw * push_scale[:, None, None]
        base = deltas - raw
        out, nu, ps = fused_superstep_call(
            pairs.src, pairs.dst, pairs.first, pairs.last, d, base,
            pairs.tiles, job_live=job_live(d, semiring), **meta)
        values = values + raw
        deltas = torch.where(touched, out, base)
    else:
        pend = torch.where(selb, deltas, float("inf"))
        base = torch.where(selb, float("inf"), deltas)
        vout, dout, nu, ps = fused_superstep_call(
            pairs.src, pairs.dst, pairs.first, pairs.last, pend, base,
            pairs.tiles, values=values, job_live=job_live(pend, semiring),
            **meta)
        values = torch.where(touched, vout, values)
        deltas = torch.where(touched, dout, base)
    if with_pairs:
        tz = pairs.dst_touched[None, :]
        return (values, deltas, torch.where(tz, nu, 0.0),
                torch.where(tz, ps, 0.0))
    return values, deltas

