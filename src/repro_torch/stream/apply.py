"""Session-level application of an UpdateBatch: the evolving-graph core.

One call absorbs a batch into EVERY layer of a running GraphSession:

  1. the shared CSR updates exactly (`updates.apply_to_csr` — the source
     of truth every compaction rebuilds from);
  2. every view group maps the batch into its own weight space
     (symmetrize mirror, normalization, degree rescale) and edits its
     device structure IN PLACE: dense-tile writes for block pairs that
     own a tile slot, the bounded per-block delta-COO overlay for
     structurally-new pairs.  A full overlay row triggers COMPACTION —
     the view's BlockedGraph is rebuilt from the updated CSR,
     bit-identical to a from-scratch build, and the overlay empties;
  3. every job's state is invalidated just enough to reconverge to the
     new graph's fixpoint (stream.invalidate: exact delta
     correction for plus-times, monotone re-activation / support-test
     reseed for min-plus);
  4. update-affected blocks are recorded as a pending PRIORITY INJECTION:
     the next run()'s first superstep boosts their P_mean in every job's
     DO queue (host and device backends alike), so the two-level
     scheduler steers all concurrent jobs at the dirty region first.

Counters accumulate on the session and drain into the next run()'s
RunMetrics (`updates_applied`, `dirty_blocks`, `reseed_fraction`).

The port of `repro.stream.apply`: the host bookkeeping is the
reference's; the tiles, the overlay and the job state are edited on the
session's device.  The edited tiles and overlay arrays equal the
reference's bit for bit after every batch (the degree rescale's ratio is
computed in numpy as the reference does, then multiplied in float32; the
writes are deduplicated first).  Every batch drops the view's cached
`BlockPairs`, so the next run rebuilds the pair tiles, run and chunk
tables and arrival counters the fused kernels read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.algorithms.base import PLUS_TIMES
from repro_torch.graph.structure import build_blocked, empty_overlay
from repro_torch.stream import invalidate as inval
from repro_torch.stream.invalidate import host_to
from repro_torch.stream.updates import UpdateBatch, apply_to_csr

# P_mean boost injected for dirty blocks (large enough to outrank any
# organic mean priority; only reorders blocks that already pend work)
DIRTY_BOOST = 1e6


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """What one apply_updates() call did (also drained into RunMetrics)."""

    updates_applied: int
    dirty_blocks: int
    reseed_fraction: float
    compacted_views: int


# ---------------------------------------------------------------------------
# view-space weights
# ---------------------------------------------------------------------------


def _raw_weight(csr, u: int, v: int, symmetrize: bool) -> Optional[float]:
    w = csr.edge_weight(u, v)
    if symmetrize:
        w2 = csr.edge_weight(v, u)
        w = w2 if w is None else (w if w2 is None else min(w, w2))
    return w


def _norm_weight(w: Optional[float], u: int, normalize: Optional[str],
                 deg: Optional[np.ndarray]) -> Optional[float]:
    if w is None:
        return None
    if normalize == "unit":
        return 1.0
    if normalize == "zero":
        return 0.0
    if normalize == "out_degree":
        return w / max(int(deg[u]), 1)
    return w


def _view_degrees(csr, symmetrize: bool) -> np.ndarray:
    return np.diff((csr.symmetrized() if symmetrize else csr).indptr)


def _view_edges(csr, normalize: Optional[str], symmetrize: bool):
    """(src, dst, w) arrays of the view graph (normalization applied)."""
    g = csr.symmetrized() if symmetrize else csr
    src = np.repeat(np.arange(g.n, dtype=np.int64), g.out_degree)
    w = g.weights.astype(np.float32).copy()
    if normalize == "out_degree":
        deg = np.maximum(g.out_degree, 1).astype(np.float32)
        w = w / deg[src]
    elif normalize == "unit":
        w = np.ones_like(w)
    elif normalize == "zero":
        w = np.zeros_like(w)
    return src, g.indices.astype(np.int64), w


def _csr_arrays(n: int, src, dst, w):
    """(indptr, indices, weights) from COO, sorted by (src, dst)."""
    order = np.lexsort((dst, src))
    src, dst, w = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return indptr, dst.astype(np.int32), w.astype(np.float32)


# ---------------------------------------------------------------------------
# per-group mirrors of the blocked structure (host side)
# ---------------------------------------------------------------------------


def _ensure_mirrors(grp) -> None:
    if grp.pair_slot is not None:
        return
    # one read of the ELL metadata (B_N x K slots), not one per slot
    ids = grp.graph.nbr_ids.cpu().numpy()
    msk = grp.graph.nbr_mask.cpu().numpy()
    sb, slot = np.nonzero(msk)
    grp.pair_slot = dict(zip(zip(sb.tolist(), ids[sb, slot].tolist()),
                             slot.tolist()))
    cap = grp.overlay.capacity
    grp.ov_used = np.zeros((ids.shape[0], cap), dtype=bool)
    grp.ov_entry = {}


def _grow_overlay(grp, capacity: int) -> None:
    ov = grp.overlay
    pad = capacity - ov.capacity

    def grown(a):
        return torch.cat([a, a.new_zeros((a.shape[0], pad))], dim=1)

    grp.overlay = dataclasses.replace(
        ov, capacity=capacity, src_u=grown(ov.src_u), dst=grown(ov.dst),
        w=grown(ov.w), mask=grown(ov.mask))
    grp.ov_used = np.pad(grp.ov_used, ((0, 0), (0, pad)))


def compact_group(sess, grp) -> None:
    """Rebuild the view's BlockedGraph from the updated CSR — by
    construction bit-identical to a from-scratch build — and empty the
    overlay.  Job state is untouched (same logical operator).  The stale
    pair view is released before the rebuild, the old tiles after it."""
    semiring, fill, normalize, symmetrize = grp.key
    grp.pairs = None      # block-pair view follows the rebuilt tiles
    csr_view = sess._csr.symmetrized() if symmetrize else sess._csr
    g = build_blocked(csr_view, sess.block_size, fill=fill,
                      normalize=normalize, device=sess.device)
    if g.num_blocks != grp.graph.num_blocks:
        raise ValueError("compaction changed the block count")
    grp.graph = g
    grp.overlay = empty_overlay(g.num_blocks, device=sess.device)
    grp.pair_slot = None
    grp.ov_used = None
    grp.ov_entry = None
    sess.trace.instant("compact", cat="stream", view=str(grp.key))


# ---------------------------------------------------------------------------
# per-group application
# ---------------------------------------------------------------------------


def _group_touched_pairs(batch: UpdateBatch,
                         symmetrize: bool) -> List[Tuple[int, int]]:
    pairs = []
    seen = set()
    for u, v in zip(batch.src, batch.dst):
        for a in (((int(u), int(v)), (int(v), int(u))) if symmetrize
                  else ((int(u), int(v)),)):
            if a not in seen:
                seen.add(a)
                pairs.append(a)
    return pairs


def _apply_structure(sess, grp, pairs, new_w: Dict,
                     deg_o: Optional[np.ndarray],
                     deg_n: Optional[np.ndarray]) -> bool:
    """Tile / overlay edits for the touched pairs; returns True when the
    group compacted instead (overlay row overflow)."""
    g = grp.graph
    vb = g.block_size
    normalize = grp.key[2]
    _ensure_mirrors(grp)

    # out-degree normalization: a changed degree rescales the source's
    # whole row (tiles + overlay); touched entries are overwritten with
    # exact values below, so drift only ever sits on untouched entries
    # until the next compaction makes the tiles bit-exact again
    if normalize == "out_degree":
        srcs = sorted({u for u, _ in pairs if deg_o[u] != deg_n[u]})
        if srcs:
            s = np.asarray(srcs, dtype=np.int64)
            ratio = (np.maximum(deg_o[s], 1)
                     / np.maximum(deg_n[s], 1)).astype(np.float32)
            sb, su = host_to(g.tiles, s // vb), host_to(g.tiles, s % vb)
            g.tiles[sb, :, su, :] *= host_to(g.tiles, ratio,
                                         torch.float32)[:, None, None]
            by_src = {int(x): float(r) for x, r in zip(s, ratio)}
            hits = [(b, col, by_src[eu])
                    for (eu, ev), (b, col) in grp.ov_entry.items()
                    if eu in by_src]
            if hits:
                ob, oc, orat = map(np.asarray, zip(*hits))
                w = grp.overlay.w
                w[host_to(w, ob), host_to(w, oc)] *= host_to(
                    w, orat, torch.float32)

    t_b, t_s, t_u, t_v, t_w = [], [], [], [], []
    # pending overlay writes keyed on (block, col): a slot freed by a
    # delete can be reclaimed by a later insert in the SAME batch, and a
    # duplicate index in one scatter-set has unspecified order — last
    # logical write must win, so dedupe here
    ov_writes: Dict[Tuple[int, int], Tuple[int, int, float, float]] = {}
    for (u, v) in pairs:
        w = new_w[(u, v)]
        sb, uo = divmod(u, vb)
        db, vo = divmod(v, vb)
        ent = grp.ov_entry.get((u, v))
        if ent is not None:
            if w is None:                     # delete an overlay edge
                grp.ov_used[ent] = False
                del grp.ov_entry[(u, v)]
                ov_writes[ent] = (0, 0, 0.0, 0.0)
            else:                             # reweight in place
                ov_writes[ent] = (uo, v, w, 1.0)
            continue
        slot = grp.pair_slot.get((sb, db))
        if slot is not None:                  # dense-tile write
            t_b.append(sb)
            t_s.append(slot)
            t_u.append(uo)
            t_v.append(vo)
            t_w.append(g.fill if w is None else w)
            continue
        if w is None:                         # deleting a non-edge
            continue
        # structurally-new block pair: overlay append
        if grp.overlay.capacity == 0:
            _grow_overlay(grp, sess.overlay_capacity)
        free = np.nonzero(~grp.ov_used[sb])[0]
        if len(free) == 0:                    # bounded: compact instead
            compact_group(sess, grp)
            return True
        col = int(free[0])
        grp.ov_used[sb, col] = True
        grp.ov_entry[(u, v)] = (sb, col)
        ov_writes[(sb, col)] = (uo, v, w, 1.0)

    if t_b:
        idx = tuple(host_to(g.tiles, a) for a in (t_b, t_s, t_u, t_v))
        g.tiles[idx] = host_to(g.tiles, t_w, torch.float32)
    if ov_writes:
        ov = grp.overlay
        b, c = map(np.asarray, zip(*ov_writes))
        at = (host_to(ov.w, b), host_to(ov.w, c))
        for arr, vals, dt in zip(
                (ov.src_u, ov.dst, ov.w, ov.mask), zip(*ov_writes.values()),
                (torch.int32, torch.int32, torch.float32, torch.float32)):
            arr[at] = host_to(arr, vals, dt)
    return False


def _apply_to_group(sess, grp, batch: UpdateBatch, csr_old, csr_new,
                    dirty: np.ndarray, stats: Dict) -> None:
    semiring, fill, normalize, symmetrize = grp.key
    # any batch may edit tiles (in place or via compaction): drop the
    # cached block-pair view so the next run rebuilds it from the edited
    # tiles (the pair tiles are a copy, not an alias)
    grp.pairs = None
    pairs = _group_touched_pairs(batch, symmetrize)
    deg_o = deg_n = None
    if normalize == "out_degree":
        deg_o = _view_degrees(csr_old, symmetrize)
        deg_n = _view_degrees(csr_new, symmetrize)
    old_w = {(u, v): _norm_weight(_raw_weight(csr_old, u, v, symmetrize),
                                  u, normalize, deg_o)
             for u, v in pairs}
    new_w = {(u, v): _norm_weight(_raw_weight(csr_new, u, v, symmetrize),
                                  u, normalize, deg_n)
             for u, v in pairs}
    if _apply_structure(sess, grp, pairs, new_w, deg_o, deg_n):
        stats["compacted"] += 1

    vb = grp.graph.block_size
    for u, v in pairs:
        if old_w[(u, v)] is not None or new_w[(u, v)] is not None:
            dirty[u // vb] = True
            dirty[v // vb] = True

    n = grp.graph.n_real
    if semiring == PLUS_TIMES:
        if symmetrize:
            # the view row of u is raw-out ∪ raw-in: no cheap row diff —
            # recompute the deltas exactly with one full matvec instead
            inval.full_reseed_plus_times(grp)
            stats["reseed_num"] += grp.num_active * n
        else:
            u_idx, dst_idx, dw = [], [], []
            for u in sorted({u for u, _ in pairs}):
                row: Dict[int, float] = {}
                for vv, ww in zip(*csr_old.row(u)):
                    w_o = _norm_weight(float(ww), u, normalize, deg_o)
                    row[int(vv)] = -w_o
                for vv, ww in zip(*csr_new.row(u)):
                    w_n = _norm_weight(float(ww), u, normalize, deg_n)
                    row[int(vv)] = row.get(int(vv), 0.0) + w_n
                for vv, d in row.items():
                    if d != 0.0:
                        u_idx.append(u)
                        dst_idx.append(vv)
                        dw.append(d)
                        dirty[vv // vb] = True
            inval.adjust_plus_times(grp, np.asarray(u_idx, np.int64),
                                    np.asarray(dst_idx, np.int64),
                                    np.asarray(dw, np.float32))
    else:
        relax, seeds = [], []
        for (u, v) in pairs:
            wo, wn = old_w[(u, v)], new_w[(u, v)]
            if wn is not None and (wo is None or wn <= wo):
                if wo is None or wn < wo:
                    relax.append(u)        # monotone: re-activate, no reseed
            elif wo is not None:
                seeds.append(v)            # break: support-test downstream
        inval.reactivate_sources(grp, relax)
        if seeds:
            src, dst, w = _view_edges(csr_new, normalize, symmetrize)
            fwd = _csr_arrays(n, src, dst, w)
            rev = _csr_arrays(n, dst, src, w)
            exact = bool(len(w) == 0 or w.min() > 0.0)
            reseeded, union = inval.reseed_min_plus(grp, fwd, rev, seeds,
                                                    exact)
            stats["reseed_num"] += reseeded
            for b in np.unique(np.nonzero(union)[0] // vb):
                dirty[b] = True
    stats["reseed_den"] += grp.num_active * n


# ---------------------------------------------------------------------------
# the session entry point
# ---------------------------------------------------------------------------


def apply_updates_to_session(sess, batch: UpdateBatch) -> StreamStats:
    if sess._csr is None:
        raise ValueError(
            "apply_updates needs the session-owned CSRGraph (sessions "
            "adopted from a legacy ConcurrentRun have none)")
    if not isinstance(batch, UpdateBatch):
        raise TypeError(f"expected an UpdateBatch, got {type(batch)}")
    if not sess.groups:
        # no views yet: just advance the CSR — the first submit builds
        # its view from the updated graph
        sess._csr = apply_to_csr(sess._csr, batch)
        sess._stream_pending["updates_applied"] += len(batch)
        return StreamStats(len(batch), 0, 0.0, 0)
    csr_old = sess._csr
    csr_new = apply_to_csr(csr_old, batch)
    sess._csr = csr_new
    bn = sess.scheduler.num_blocks
    dirty = np.zeros(bn, dtype=bool)
    stats = {"reseed_num": 0, "reseed_den": 0, "compacted": 0}
    with sess.trace.span("apply_updates", cat="stream", updates=len(batch)):
        for grp in sess.view_groups():
            _apply_to_group(sess, grp, batch, csr_old, csr_new, dirty, stats)

    boost = np.where(dirty, np.float32(DIRTY_BOOST), np.float32(0.0))
    if sess._dirty_boost is None:
        sess._dirty_boost = boost
    else:
        sess._dirty_boost = np.maximum(sess._dirty_boost, boost)
    p = sess._stream_pending
    p["updates_applied"] += len(batch)
    p["dirty_blocks"] += int(dirty.sum())
    p["reseed_num"] += stats["reseed_num"]
    p["reseed_den"] += stats["reseed_den"]
    den = stats["reseed_den"]
    return StreamStats(
        updates_applied=len(batch),
        dirty_blocks=int(dirty.sum()),
        reseed_fraction=stats["reseed_num"] / den if den else 0.0,
        compacted_views=stats["compacted"])
