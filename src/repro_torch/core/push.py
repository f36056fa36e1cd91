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

Every push takes the live-update overlay as its trailing argument.  The
port carries only the capacity-0 overlay of a never-updated view, which
is an exact no-op; a non-empty overlay raises (ROADMAP A8).
"""

from __future__ import annotations

import torch

from repro_torch.algorithms.base import Algorithm
from repro_torch.core import priority as prio
from repro_torch.graph.structure import TileOverlay
from repro_torch.kernels.fused_superstep import ops as fused_ops
from repro_torch.kernels.fused_superstep.ref import (_sink_index,
                                                     scatter_add_drop)

__all__ = [
    "push_plus_one", "push_min_one", "compute_pairs",
    "shared_push_fn", "indep_push_fn",
    "overlay_push_plus", "overlay_push_min",
]

INF = float("inf")
_block_mask = fused_ops.block_mask


def _no_overlay(ov) -> None:
    if ov is not None and ov.capacity:
        raise NotImplementedError(
            "a non-empty TileOverlay (live graph updates) is not ported "
            "yet: ROADMAP A8, evolving graphs")


def overlay_push_plus(deltas: torch.Tensor, d_sel: torch.Tensor,
                      ov: TileOverlay, sel_ids: torch.Tensor) -> torch.Tensor:
    """Scatter the selected blocks' overlay contributions into `deltas`
    (capacity 0: an exact no-op)."""
    if ov.capacity == 0:
        return deltas
    _no_overlay(ov)


def overlay_push_min(values: torch.Tensor, deltas: torch.Tensor,
                     d_sel: torch.Tensor, ov: TileOverlay,
                     sel_ids: torch.Tensor):
    """Min-plus analogue of `overlay_push_plus`."""
    if ov.capacity == 0:
        return values, deltas
    _no_overlay(ov)


def _push_plus_jobs(values, deltas, tiles, nbr_ids, sel, msk, scales,
                    overlay):
    """PLUS_TIMES push of every job [J, B_N, Vb] over ONE shared [q]
    selection through the block-ELL tiles."""
    _no_overlay(overlay)
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
    return values, deltas


def _push_min_jobs(values, deltas, tiles, nbr_ids, sel, msk, overlay):
    """MIN_PLUS push of every job [J, B_N, Vb] over ONE shared [q]
    selection: a loop over the K ELL slots (the reference's lax.scan)."""
    _no_overlay(overlay)
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
    return v[:, :bn], dl[:, :bn]


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
      use_pallas=False  plus-times sweeps the same pairs with a per-(job,
                        pair) einsum + scatter-add; min-plus keeps the
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
            _no_overlay(overlay)
            return fused_ops.fused_push(values, deltas, pairs, sel, msk,
                                        scales, semiring=semiring, gate=gate)

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
        _no_overlay(overlay)
        bn = values.shape[1]
        selb = _block_mask(sel, msk, bn)[None, :, None]
        raw = torch.where(selb, deltas, 0.0)
        d = raw * scales[:, None, None]
        base = deltas - raw
        contrib = torch.einsum("jpv,pvw->jpw", d[:, pairs.src.long(), :],
                               pairs.tiles)
        return values + raw, scatter_add_drop(base, pairs.dst, contrib)

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
