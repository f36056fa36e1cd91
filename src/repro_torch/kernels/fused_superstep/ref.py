"""Plain PyTorch version of the fused superstep (what the CUDA kernels
compute), written as gather / scatter reductions.

The CPU route runs it; on a CUDA device it serves only to check the
kernels.  Same contract as `kernel.fused_superstep_call`.  Destination
ids outside [0, B_loc) are dropped, as the reference's ``mode="drop"``
scatters drop them.  The min-plus form walks the pairs in chunks so its
[J, chunk, Vb, Vb] temporary stays bounded (the unchunked form would be
[J, P, Vb, Vb]: 8.7 GB at 2^16 vertices, Vb=64, J=4).
"""

from __future__ import annotations

import torch

#: elements of the min-plus [J, chunk, Vb, Vb] temporary (64 MB of f32)
MIN_PLUS_CHUNK_ELEMS = 2**24


def _sink_index(dst: torch.Tensor, bn: int) -> torch.Tensor:
    """int64 destination ids with out-of-range ids sent to row `bn` (a
    sink row the caller appends and drops)."""
    dst = dst.long()
    return torch.where((dst >= 0) & (dst < bn), dst, bn)


def scatter_add_drop(base: torch.Tensor, dst: torch.Tensor,
                     contrib: torch.Tensor) -> torch.Tensor:
    """base [J, B, Vb] + contrib [J, M, Vb] added at rows dst [M];
    out-of-range rows are dropped.  Returns a new tensor."""
    j, bn, vb = base.shape
    ext = torch.cat([base, base.new_zeros(j, 1, vb)], dim=1)
    ext.index_add_(1, _sink_index(dst, bn), contrib)
    return ext[:, :bn]


def pair_products(d_src: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """[J, P, Vb] source rows times their pair tiles [P, Vb, Vb] ->
    [J, P, Vb], one job at a time: a GEMM batched over the jobs would
    pick its blocking (and so a job's summation order) by J, and a job's
    sums must not depend on how many jobs share the call (a job mesh
    splits the jobs across ranks and must equal one device bit for
    bit)."""
    return torch.stack([torch.bmm(d_src[j].unsqueeze(1), tiles).squeeze(1)
                        for j in range(d_src.shape[0])])


def _flush_pairs(pr: torch.Tensor):
    nu = (pr > 0.0).sum(-1).to(torch.float32)
    return nu, pr.sum(-1)


def fused_superstep_ref(src, dst, first, last, d, base, tiles, *,
                        values=None, run_start=None, chunk_start=None,
                        chunk_run=None, arrivals=None, src_live=None,
                        job_live=None, gate=None,
                        semiring: str = "plus_times",
                        tolerance: float = 1e-6):
    """The kernels' function.  The work-item arguments (run_start, the
    chunk table, arrivals) and `gate` do not change it and are ignored;
    `src_live` masks the rows of `d` of other sources to the semiring
    identity, and a job outside `job_live` keeps its base (min-plus: its
    values and base), as the kernels write it through; both are no-ops
    under the kernels' preconditions, up to the sign of a zero in
    plus-times."""
    del first, last, run_start, chunk_start, chunk_run, arrivals, gate
    j, _, vb = d.shape
    bn = base.shape[1]
    ident = 0.0 if semiring == "plus_times" else float("inf")
    if src_live is not None:
        d = torch.where(src_live.bool()[None, :, None], d, ident)
    if job_live is not None:
        d = torch.where(job_live.bool()[:, None, None], d, ident)
    src = src.long()
    if semiring == "plus_times":
        contrib = pair_products(d[:, src, :], tiles)
        out = scatter_add_drop(base, dst, contrib)
        if job_live is not None:
            out = torch.where(job_live.bool()[:, None, None], out, base)
        a = out.abs()
        pr = torch.where(a >= tolerance, a, 0.0)
        nu, ps = _flush_pairs(pr)
        return out, nu, ps
    if values is None:
        raise ValueError("the min-plus fused call needs `values`")
    p = src.shape[0]
    idx = _sink_index(dst, bn)
    cand = torch.full((j, bn + 1, vb), float("inf"), dtype=torch.float32,
                      device=d.device)
    chunk = max(1, MIN_PLUS_CHUNK_ELEMS // (j * vb * vb))
    for c0 in range(0, p, chunk):
        c1 = min(p, c0 + chunk)
        cand_p = (d[:, src[c0:c1], :, None] + tiles[None, c0:c1]).amin(2)
        cand.scatter_reduce_(
            1, idx[c0:c1][None, :, None].expand(j, c1 - c0, vb), cand_p,
            reduce="amin")
    cand = cand[:, :bn]
    v_new = torch.minimum(values, cand)
    d_new = torch.minimum(base, torch.where(v_new < values, v_new,
                                            float("inf")))
    pr = torch.where(torch.isfinite(d_new), 1.0 / (1.0 + d_new), 0.0)
    nu, ps = _flush_pairs(pr)
    return v_new, d_new, nu, ps
