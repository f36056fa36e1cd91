"""Dirty-state invalidation: re-seed just enough job state after an
edge-update batch that every job converges to the NEW graph's fixpoint.

Per semiring (the reference's `repro.stream.invalidate`, whose notes
this keeps):

PLUS_TIMES — the delta-accumulative iteration conserves the invariant
    phi = v + (I - A)^{-1} d
(one push moves mass from d into v and scatters A*d back into d; phi is
the job's final answer from step 0).  A matrix change A -> A' therefore
has an EXACT local correction: the new deltas must satisfy
    v + (I - A')^{-1} d' = (I - A')^{-1} b      (b = the init deltas)
    =>  d' = b - (I - A') v = d + (A' - A) v    (using the invariant)
so we adjust d by the sparse difference matrix (A' - A) applied to the
current values — nonzero only on the updated rows.  (Symmetrized
plus-times views have no cheap row diff; `full_reseed_plus_times`
recomputes d' = b - v + A'v with one matvec over all tiles + overlay.)

MIN_PLUS — monotone fast path vs support-test reseed:
  * relaxations (insert / reweight-down) cannot invalidate any distance:
    re-activate the source vertex (deltas[u] = min(deltas[u], values[u]))
    and let the ordinary push relax the new edge — no reseed;
  * breaks (delete / reweight-up) may orphan distances downstream.  The
    affected set is computed per job with the support test on the host
    (numpy): a vertex is affected iff it cannot justify its current
    distance by its init value or by an UNaffected in-neighbour under the
    new weights.  Views with zero-weight edges (WCC) fall back to
    conservative reachability from the broken edges' heads.  Affected
    vertices re-seed to their init state and their unaffected
    in-neighbours re-activate.

Job state lives on the session's device; the scatters below sum
(`index_add`) and min (`minimum` / `scatter_reduce` "amin") repeated
indices, as the reference's `.at[].add` / `.at[].min` do.
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np
import torch

INF = float("inf")


def host_to(like: torch.Tensor, a, dtype=torch.int64) -> torch.Tensor:
    """Host values as a tensor on `like`'s device."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# plus-times
# ---------------------------------------------------------------------------


def adjust_plus_times(grp, u_idx: np.ndarray, dst_idx: np.ndarray,
                      dw: np.ndarray) -> None:
    """d += (A' - A) v via the row-difference COO (padded flat indices).

    Free slots hold all-zero values, so the adjustment is a no-op there —
    the whole padded job axis is updated in one scatter.  `dst_idx`
    repeats whenever two sources feed one vertex: those terms sum."""
    if len(u_idx) == 0:
        return
    cap = grp.values.shape[0]
    shape = grp.deltas.shape
    v_flat = grp.values.reshape(cap, -1)
    d_flat = grp.deltas.reshape(cap, -1)
    vals = (grp.push_scale[:, None] * v_flat[:, host_to(v_flat, u_idx)]
            * host_to(v_flat, dw, torch.float32)[None, :])
    grp.deltas = d_flat.index_add(1, host_to(v_flat, dst_idx),
                                  vals).reshape(shape)


def full_reseed_plus_times(grp, shards=None) -> None:
    """Exact d' = b - v + A'v for every active job (symmetrized-view
    fallback: stages all tiles + overlay once).

    `shards`: a `dist.mesh2d.PairShards` of the view's pair tiles, for
    a view whose ELL tiles are not built (the whole pair view as one
    shard) or, on a mesh, are sliced (this rank's shard, with the
    group's WHOLE job state in place, `dist.mesh2d.whole_job_state`).
    The matvec then runs over the shard's pairs and is complete only on
    the shard's own destination rows, the ones the rank keeps (its sum
    order differs from the ELL sweep's: plus-times tolerance)."""
    g, ov = grp.graph, grp.overlay
    bn, vb = g.num_blocks, g.block_size
    cap = grp.capacity
    xs = grp.values * grp.push_scale[:, None, None]            # [J, B_N, Vb]
    if shards is None:
        contrib = torch.einsum("jbv,bkvw->jbkw", xs, g.tiles)
        mv = torch.zeros_like(grp.values).index_add(
            1, g.nbr_ids.reshape(-1).long(), contrib.reshape(cap, -1, vb))
    else:
        lp = shards.local
        contrib = torch.einsum("jpv,pvw->jpw", xs[:, lp.src.long()],
                               lp.tiles)
        mv = torch.zeros_like(grp.values).index_add(
            1, lp.dst.long() + shards.shard * shards.blocks_per_shard,
            contrib)
    if ov.capacity:
        rows = torch.arange(bn, device=xs.device)[:, None]
        sel = xs[:, rows, ov.src_u.long()] * ov.w * ov.mask     # [J, B_N, C]
        mv = mv.reshape(cap, -1).index_add(
            1, ov.dst.reshape(-1).long(),
            sel.reshape(cap, -1)).reshape(mv.shape)
    zeros = torch.zeros((bn, vb), dtype=torch.float32, device=xs.device)
    init_d = [grp.algs[j].init(g)[1] if grp.active[j] else zeros
              for j in range(cap)]
    d_new = torch.stack(init_d) - grp.values + mv
    act = host_to(grp.values, grp.active, torch.bool)[:, None, None]
    grp.deltas = torch.where(act, d_new, grp.deltas)


# ---------------------------------------------------------------------------
# min-plus
# ---------------------------------------------------------------------------


def reactivate_sources(grp, sources: List[int]) -> None:
    """Monotone fast path: pending = min(pending, current) at `sources`
    (padded ids) for every job at once (inert slots stay inf)."""
    if not sources:
        return
    vb = grp.graph.block_size
    s = np.asarray(sorted(set(sources)), dtype=np.int64)
    bs, us = host_to(grp.values, s // vb), host_to(grp.values, s % vb)
    d = grp.deltas.clone()
    d[:, bs, us] = torch.minimum(d[:, bs, us], grp.values[:, bs, us])
    grp.deltas = d


def _affected_support(n: int, fwd, rev, dist: np.ndarray,
                      init_v: np.ndarray, seeds: List[int]) -> np.ndarray:
    """Support-test affected set (positive weights): [n] bool.

    fwd/rev are (indptr, indices, weights) CSR/CSC of the NEW view.  A
    candidate re-enters the worklist whenever one of its supporters falls,
    so the deque order never under-invalidates (the affected set grows
    monotonically to its fixpoint)."""
    f_ptr, f_idx, f_w = fwd
    r_ptr, r_idx, r_w = rev
    affected = np.zeros(n, dtype=bool)
    queued = np.zeros(n, dtype=bool)
    cand = deque()
    for s in seeds:
        if not queued[s]:
            queued[s] = True
            cand.append(s)
    while cand:
        x = cand.popleft()
        queued[x] = False
        if affected[x] or not np.isfinite(dist[x]):
            continue
        if init_v[x] == dist[x]:     # self-supported (source / own label)
            continue
        lo, hi = r_ptr[x], r_ptr[x + 1]
        ins, ws = r_idx[lo:hi], r_w[lo:hi]
        ok = (~affected[ins]) & np.isfinite(dist[ins]) \
            & (dist[ins] + ws == dist[x])
        if ok.any():
            continue
        affected[x] = True
        lo, hi = f_ptr[x], f_ptr[x + 1]
        outs, ws = f_idx[lo:hi], f_w[lo:hi]
        dep = (~affected[outs]) & np.isfinite(dist[outs]) \
            & (dist[outs] == dist[x] + ws)
        for y in outs[dep]:
            if not queued[y]:
                queued[y] = True
                cand.append(int(y))
    return affected


def _affected_reachable(n: int, fwd, seeds: List[int]) -> np.ndarray:
    """Conservative fallback (zero-weight views): everything reachable
    from the broken edges' heads in the new view."""
    f_ptr, f_idx, _ = fwd
    affected = np.zeros(n, dtype=bool)
    stack = sorted(set(seeds))  # RPA007: hash order must not reach state
    for s in stack:
        affected[s] = True
    while stack:
        x = stack.pop()
        nbrs = f_idx[f_ptr[x]:f_ptr[x + 1]]
        new = nbrs[~affected[nbrs]]
        affected[new] = True
        stack.extend(int(y) for y in new)
    return affected


def reseed_min_plus(grp, fwd, rev, seeds: List[int],
                    exact: bool) -> Tuple[int, np.ndarray]:
    """Per active job: compute the affected set, re-seed it to the job's
    init state, re-activate its unaffected in-neighbours.  Returns
    (#re-seeded (job, vertex) pairs, union of affected vertices)."""
    g = grp.graph
    n, vb = g.n_real, g.block_size
    r_ptr, r_idx, _ = rev
    reseeded = 0
    union = np.zeros(n, dtype=bool)
    # one read of every job's values (not one per active job)
    values_h = grp.values.cpu().numpy()
    values, deltas = grp.values.clone(), grp.deltas.clone()
    for j in range(grp.capacity):
        if not grp.active[j]:
            continue
        dist = values_h[j].reshape(-1)[:n]
        init_v, init_d = grp.algs[j].init(g)
        iv = init_v.cpu().numpy().reshape(-1)[:n]  # noqa: RPT002 - a reseeded job's init
        if exact:
            aff = _affected_support(n, fwd, rev, dist, iv, seeds)
        else:
            aff = _affected_reachable(n, fwd, seeds)
            aff &= iv != dist    # self-supported state needs no reseed
        idx = np.nonzero(aff)[0]
        if len(idx) == 0:
            continue
        reseeded += len(idx)
        union |= aff
        id_ = init_d.cpu().numpy().reshape(-1)[:n]  # noqa: RPT002 - a reseeded job's init
        bs, us = host_to(values, idx // vb), host_to(values, idx % vb)
        values[j, bs, us] = host_to(values, iv[idx], torch.float32)
        deltas[j, bs, us] = host_to(values, id_[idx], torch.float32)
        # boundary re-activation: unaffected in-neighbours of the region
        # re-push their (still-correct) values into it
        nbrs = np.unique(np.concatenate(
            [r_idx[r_ptr[x]:r_ptr[x + 1]] for x in idx]
            or [np.zeros(0, np.int32)]))
        nbrs = nbrs[~aff[nbrs]]
        if len(nbrs):
            nb, nu = host_to(values, nbrs // vb), host_to(values, nbrs % vb)
            deltas[j, nb, nu] = torch.minimum(deltas[j, nb, nu],
                                              values[j, nb, nu])
    grp.values, grp.deltas = values, deltas
    return reseeded, union
