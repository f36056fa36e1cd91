"""Push primitives (PyTorch).

A "push" processes the selected adjacency blocks: it consumes the
pending deltas of the selected blocks and scatters their contributions
into the neighbours' deltas (paper Eq. 3, both semirings).  `push_*_one`
push one job [B_N, Vb]; the session's callables (`shared_push_fn`,
`indep_push_fn`) write the job axis [J, B_N, Vb] out where the reference
vmaps.

Scatters drop out-of-range destination ids, as the reference's
``mode="drop"`` scatters do: an out-of-range id is sent to a sink row
that is appended and dropped (no host sync, unlike boolean masking).

Evolving graphs (`repro_torch.stream`) stage a bounded per-block
delta-COO overlay alongside each tile (`graph.structure.TileOverlay`): a
push of block b consumes b's pending deltas through the base tile AND
through b's overlay edges in the same staging.  Every push takes the
overlay as its trailing argument; the capacity-0 overlay of a
never-updated view is skipped.  The overlay ride-along is plain PyTorch
on every route (the kernel route runs it around the fused kernel, on the
deltas as they were before the kernel consumed them).  Its scatters sum
(`index_add`) and min (`scatter_reduce` "amin") repeated destinations,
as the reference's `.at[].add` / `.at[].min` do.
"""

from __future__ import annotations

import torch

from repro_torch.algorithms.base import Algorithm
from repro_torch.core import priority as prio
from repro_torch.graph.structure import TileOverlay
from repro_torch.kernels.fused_superstep import ops as fused_ops
from repro_torch.kernels.fused_superstep.ref import (_sink_index,
                                                     pair_products,
                                                     scatter_add_drop)

__all__ = [
    "push_plus_one", "push_min_one", "compute_pairs",
    "shared_push_fn", "indep_push_fn", "reads_ell",
    "overlay_push_plus", "overlay_push_min",
]

INF = float("inf")
_block_mask = fused_ops.block_mask


def _rides(ov) -> bool:
    """True when `ov` holds overlay slots the push must consume."""
    return ov is not None and ov.capacity > 0


def _overlay_rows(ov: TileOverlay, sel_ids: torch.Tensor):
    """Gather the overlay rows of the selected blocks: [q, C] each."""
    s = sel_ids.long()
    return ov.src_u[s].long(), ov.dst[s].long(), ov.w[s], ov.mask[s]


def _pick_sources(d_sel: torch.Tensor, src_u: torch.Tensor) -> torch.Tensor:
    """d_sel [J, q, Vb] at each overlay entry's source lane -> [J, q, C]
    (the reference's d_sel[arange(q)[:, None], src_u])."""
    j = d_sel.shape[0]
    return torch.gather(d_sel, 2, src_u[None].expand(j, -1, -1))


def overlay_push_plus(deltas: torch.Tensor, d_sel: torch.Tensor,
                      ov: TileOverlay, sel_ids: torch.Tensor) -> torch.Tensor:
    """Scatter the selected blocks' overlay contributions into `deltas`.

    deltas [B_N, Vb] with d_sel [q, Vb] (one job, the reference's
    signature) or deltas [J, B_N, Vb] with d_sel [J, q, Vb].  d_sel must
    be the SAME consumed-and-scaled deltas the base tile push used
    (pre-consumption values), so an overlay edge pushes exactly once per
    staging, in lockstep with the tile.  Repeated destinations sum."""
    if ov.capacity == 0:
        return deltas
    if deltas.dim() == 2:
        return overlay_push_plus(deltas[None], d_sel[None], ov, sel_ids)[0]
    src_u, dst, w, mask = _overlay_rows(ov, sel_ids)          # [q, C]
    j = deltas.shape[0]
    contrib = _pick_sources(d_sel, src_u) * w * mask          # [J, q, C]
    flat = deltas.reshape(j, -1).index_add(1, dst.reshape(-1),
                                           contrib.reshape(j, -1))
    return flat.reshape(deltas.shape)


def overlay_push_min(values: torch.Tensor, deltas: torch.Tensor,
                     d_sel: torch.Tensor, ov: TileOverlay,
                     sel_ids: torch.Tensor):
    """Min-plus analogue: relax the selected blocks' overlay edges.

    Shapes as in `overlay_push_plus`.  d_sel is the consumed pending
    distance of the selected blocks (inf where nothing pends / the slot
    is padded).  Every destination's old value is read before the min and
    its new value after it, so repeated destinations see the same
    old/new pair the reference's gather-min-gather does."""
    if ov.capacity == 0:
        return values, deltas
    if values.dim() == 2:
        v, d = overlay_push_min(values[None], deltas[None], d_sel[None], ov,
                                sel_ids)
        return v[0], d[0]
    src_u, dst, w, mask = _overlay_rows(ov, sel_ids)          # [q, C]
    j = values.shape[0]
    cand = torch.where(mask > 0, _pick_sources(d_sel, src_u) + w,
                       INF).reshape(j, -1)
    idx = dst.reshape(-1)
    ix = idx[None].expand(j, -1)
    v_flat, d_flat = values.reshape(j, -1), deltas.reshape(j, -1)
    old = v_flat[:, idx]
    v_flat = v_flat.scatter_reduce(1, ix, cand, reduce="amin",
                                   include_self=True)
    new = v_flat[:, idx]
    d_flat = d_flat.scatter_reduce(1, ix, torch.where(new < old, new, INF),
                                   reduce="amin", include_self=True)
    return v_flat.reshape(values.shape), d_flat.reshape(deltas.shape)


def _overlay_d_sel(semiring: str, deltas, sel, msk, scales):
    """[J, q, Vb] the selected blocks' deltas as the overlay ride-along
    reads them, gathered BEFORE a push consumes them: plus-times scaled
    and slot-masked, min-plus inf where the slot is off."""
    consumed = _block_mask(sel, msk, deltas.shape[1])[None, :, None]
    s = sel.long()
    if semiring == "plus_times":
        raw = torch.where(consumed, deltas, 0.0)
        return raw[:, s] * scales[:, None, None] * msk[None, :, None]
    d_sel = torch.where(consumed, deltas, INF)[:, s]
    return torch.where(msk[None, :, None] > 0, d_sel, INF)


def _push_plus_jobs(values, deltas, tiles, nbr_ids, sel, msk, scales,
                    overlay):
    """PLUS_TIMES push of every job [J, B_N, Vb] over ONE shared [q]
    selection through the block-ELL tiles, then the overlay ride-along."""
    j, bn, vb = values.shape
    consumed = _block_mask(sel, msk, bn)[None, :, None]
    raw = torch.where(consumed, deltas, 0.0)
    sel = sel.long()
    # mask padded selection slots: a padded slot aliases block 0 and must
    # not re-push block 0's delta when block 0 is itself selected
    d_sel = raw[:, sel] * scales[:, None, None] * msk[None, :, None]
    contrib = torch.einsum("jqv,qkvw->jqkw", d_sel, tiles[sel])
    values = values + raw
    deltas = deltas - raw
    dst = nbr_ids[sel].reshape(-1)                           # [q*K]
    deltas = scatter_add_drop(deltas, dst, contrib.reshape(j, -1, vb))
    if _rides(overlay):
        deltas = overlay_push_plus(deltas, d_sel, overlay, sel)
    return values, deltas


def _push_min_jobs(values, deltas, tiles, nbr_ids, sel, msk, overlay):
    """MIN_PLUS push of every job [J, B_N, Vb] over ONE shared [q]
    selection: a loop over the K ELL slots (the reference's lax.scan),
    then the overlay ride-along."""
    j, bn, vb = values.shape
    consumed = _block_mask(sel, msk, bn)[None, :, None]
    sel = sel.long()
    d_sel = torch.where(consumed, deltas, INF)[:, sel]       # [J, q, Vb]
    d_sel = torch.where(msk[None, :, None] > 0, d_sel, INF)
    deltas = torch.where(consumed, INF, deltas)
    t_sel = tiles[sel]                                       # [q, K, Vb, Vb]
    nbr_sel = _sink_index(nbr_ids[sel], bn)                  # [q, K]
    q = sel.shape[0]
    sink = torch.full((j, 1, vb), INF, dtype=values.dtype,
                      device=values.device)
    v = torch.cat([values, sink], dim=1)
    dl = torch.cat([deltas, sink], dim=1)
    for k in range(t_sel.shape[1]):
        contrib = (d_sel[:, :, :, None] + t_sel[None, :, k]).amin(2)
        idx = nbr_sel[:, k]
        ix = idx[None, :, None].expand(j, q, vb)
        old = v[:, idx]
        v.scatter_reduce_(1, ix, contrib, reduce="amin")
        new = v[:, idx]
        dl.scatter_reduce_(1, ix, torch.where(new < old, new, INF),
                           reduce="amin")
    values, deltas = v[:, :bn], dl[:, :bn]
    if _rides(overlay):
        values, deltas = overlay_push_min(values, deltas, d_sel, overlay,
                                          sel)
    return values, deltas


def push_plus_one(values: torch.Tensor, deltas: torch.Tensor,
                  tiles: torch.Tensor, nbr_ids: torch.Tensor,
                  sel_ids: torch.Tensor, sel_mask: torch.Tensor,
                  push_scale, overlay: TileOverlay = None):
    """One job, PLUS_TIMES semiring. values/deltas [B_N, Vb]."""
    scale = torch.as_tensor(push_scale, dtype=torch.float32,
                            device=values.device).reshape(1)
    v, d = _push_plus_jobs(values[None], deltas[None], tiles, nbr_ids,
                           sel_ids, sel_mask, scale, overlay)
    return v[0], d[0]


def push_min_one(values: torch.Tensor, deltas: torch.Tensor,
                 tiles: torch.Tensor, nbr_ids: torch.Tensor,
                 sel_ids: torch.Tensor, sel_mask: torch.Tensor,
                 push_scale, overlay: TileOverlay = None):
    """One job, MIN_PLUS semiring (push_scale unused, kept for signature)."""
    del push_scale
    v, d = _push_min_jobs(values[None], deltas[None], tiles, nbr_ids,
                          sel_ids, sel_mask, overlay)
    return v[0], d[0]


def compute_pairs(alg: Algorithm, values: torch.Tensor, deltas: torch.Tensor):
    """[J, B_N, Vb] -> (node_un [J,B_N], p_mean [J,B_N])."""
    return prio.block_pairs(alg.vertex_priority(values, deltas))


def reads_ell(semiring: str, use_pallas: bool, shared: bool = True) -> bool:
    """Whether a one-device push route reads the view's ELL tiles (the
    drivers hand them over only then, so a view builds them on demand):
    the per-job selection route (`indep_push_fn`) and the plain min-plus
    route do; the kernel route and the plain plus-times pair sweep read
    the pair view alone."""
    return not shared or not (use_pallas or semiring == "plus_times")


def shared_push_fn(semiring: str, push_one, use_pallas: bool):
    """Stacked-job CAJS push callable: all jobs process the same [q]
    selection (one staging serves every job).  The ONE place the
    kernel-vs-plain route choice lives.

    Returns fn(values, deltas, tiles, nbr_ids, sel, msk, scales, overlay,
    pairs, gate=None) with `pairs` the view's `graph.BlockPairs`:

      use_pallas=True   the fused superstep kernel sweeps the destination-
                        sorted pairs (push + priority in one launch; on CPU
                        tensors its plain version).  `gate`, a 0-dim
                        device bool, reaches the kernel: a closed gate
                        skips its work and leaves the result undefined,
                        for a caller that discards it (the device
                        driver's gated supersteps).  The other routes
                        ignore it.
      use_pallas=False  plus-times sweeps the same pairs with per-(job,
                        pair) products (`pair_products`) + scatter-add; min-plus keeps the
                        per-job ELL push with its sequential slot loop.
      pairs=None        the block-ELL push, for callers without a pair view.
    """
    del push_one                       # the semiring picks the ELL push

    def ell(values, deltas, tiles, nbr_ids, sel, msk, scales, overlay):
        if semiring == "plus_times":
            return _push_plus_jobs(values, deltas, tiles, nbr_ids, sel, msk,
                                   scales, overlay)
        return _push_min_jobs(values, deltas, tiles, nbr_ids, sel, msk,
                              overlay)

    if use_pallas:
        def fn(values, deltas, tiles, nbr_ids, sel, msk, scales, overlay,
               pairs, gate=None):
            if pairs is None:
                return ell(values, deltas, tiles, nbr_ids, sel, msk, scales,
                           overlay)
            # the overlay must see the PRE-consumption deltas, gathered
            # before the kernel consumes them
            ride = _rides(overlay)
            if ride:
                d_sel = _overlay_d_sel(semiring, deltas, sel, msk, scales)
            values, deltas = fused_ops.fused_push(
                values, deltas, pairs, sel, msk, scales, semiring=semiring,
                gate=gate)
            if ride and semiring == "plus_times":
                deltas = overlay_push_plus(deltas, d_sel, overlay, sel)
            elif ride:
                values, deltas = overlay_push_min(values, deltas, d_sel,
                                                  overlay, sel)
            return values, deltas

        return fn

    if semiring != "plus_times":
        def fn(values, deltas, tiles, nbr_ids, sel, msk, scales, overlay,
               pairs, gate=None):
            return ell(values, deltas, tiles, nbr_ids, sel, msk, scales,
                       overlay)

        return fn

    def fn(values, deltas, tiles, nbr_ids, sel, msk, scales, overlay,
           pairs, gate=None):
        if pairs is None:
            return ell(values, deltas, tiles, nbr_ids, sel, msk, scales,
                       overlay)
        bn = values.shape[1]
        selb = _block_mask(sel, msk, bn)[None, :, None]
        raw = torch.where(selb, deltas, 0.0)
        d = raw * scales[:, None, None]
        base = deltas - raw
        contrib = pair_products(d[:, pairs.src.long(), :], pairs.tiles)
        deltas = scatter_add_drop(base, pairs.dst, contrib)
        if _rides(overlay):
            d_sel = d[:, sel.long(), :] * msk[None, :, None]   # [J, q, Vb]
            deltas = overlay_push_plus(deltas, d_sel, overlay, sel)
        return values + raw, deltas

    return fn


def indep_push_fn(push_one):
    """Per-job-selection push callable: job j processes its own sel[j]
    [q] (the redundancy baseline), one job after another."""
    def fn(values, deltas, tiles, nbr_ids, sel, msk, scales, overlay):
        outs = [push_one(values[j], deltas[j], tiles, nbr_ids, sel[j],
                         msk[j], scales[j], overlay)
                for j in range(values.shape[0])]
        return (torch.stack([v for v, _ in outs]),
                torch.stack([d for _, d in outs]))

    return fn
