"""Wrappers around the mj_spmm kernel and a kernel-backed engine push.

`push_shared` mirrors the engine's shared-mode push exactly (after
`repro/kernels/mj_spmm/ops.py`), with the contribution compute (the hot
loop) in the kernel.  The kernel reads the selected rows' tiles straight
from the block-ELL array through `tile_index`, so the [q, K, Vb, Vb]
gathered copy the reference materialises is never written.  The fold /
consume / scatter bookkeeping stays in plain tensor ops.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.fused_superstep.ops import block_mask
from repro_torch.kernels.fused_superstep.ref import (_sink_index,
                                                     scatter_add_drop)
from repro_torch.kernels.mj_spmm.kernel import mj_spmm_call

INF = float("inf")


def mj_spmm(d_sel: torch.Tensor, tiles_sel: torch.Tensor,
            semiring: str = "plus_times", *,
            tile_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """d_sel [q, J, Vb], tiles_sel [q, K, Vb, Vb] -> contribs [q, K, J, Vb].

    With `tile_index` [q], `tiles_sel` is the whole [B_N, K, Vb, Vb] ELL
    array and row i reads tiles_sel[tile_index[i]].  The kernel takes its
    own passes of min(J, JR) jobs (`kernel.pass_jobs`)."""
    if tile_index is not None:
        tile_index = tile_index.to(torch.int32).contiguous()
    return mj_spmm_call(d_sel.to(torch.float32).contiguous(),
                        tiles_sel.to(torch.float32).contiguous(),
                        tile_index=tile_index, semiring=semiring)


def fold_min(values: torch.Tensor, deltas: torch.Tensor,
             contrib: torch.Tensor, nbr_sel: torch.Tensor):
    """Min-plus bookkeeping after the product, in one pass.

    contrib [q, K, J, Vb] is min-folded into values [J, B_N, Vb] at the
    destination blocks nbr_sel [q, K]; ids outside [0, B_N) are dropped.
    The reference folds K scatter-mins one after another and lowers each
    improved destination's delta to its new value; min-folds of exact
    values are order-free, and the smallest improved value is the final
    one, so one scatter-min and
    deltas = min(deltas, v_new < v_old ? v_new : inf) are bit-equal."""
    j, bn, vb = values.shape
    idx = _sink_index(nbr_sel.reshape(-1), bn)                  # [q*K]
    src = contrib.permute(2, 0, 1, 3).reshape(j, -1, vb)        # [J, q*K, Vb]
    ext = torch.cat([values, values.new_full((j, 1, vb), INF)], dim=1)
    ext.scatter_reduce_(1, idx[None, :, None].expand_as(src), src,
                        reduce="amin")
    v_new = ext[:, :bn]
    d_new = torch.minimum(deltas, torch.where(v_new < values, v_new, INF))
    return v_new, d_new


def push_shared(values: torch.Tensor, deltas: torch.Tensor,
                tiles: torch.Tensor, nbr_ids: torch.Tensor,
                sel_ids: torch.Tensor, sel_mask: torch.Tensor,
                push_scale: torch.Tensor, *, semiring: str = "plus_times"):
    """Kernel-backed CAJS push. values/deltas [J, B_N, Vb]; tiles [B_N, K,
    Vb, Vb] and nbr_ids [B_N, K] the block-ELL view; sel_ids/sel_mask [q]
    the shared selection.  Returns the updated (values, deltas).

    Out-of-range neighbour ids are dropped (the reference's mode="drop");
    a padded slot (mask 0) aliasing a selected block pushes nothing."""
    j, bn, vb = values.shape
    consumed = block_mask(sel_ids, sel_mask, bn)[None, :, None]
    sel = sel_ids.long()
    nbr_sel = nbr_ids[sel]                                      # [q, K]
    if semiring == "plus_times":
        raw = torch.where(consumed, deltas, 0.0)
        d_sel = (raw[:, sel, :] * push_scale[:, None, None]
                 * sel_mask[None, :, None])                     # [J, q, Vb]
        contrib = mj_spmm(d_sel.transpose(0, 1), tiles, semiring,
                          tile_index=sel_ids)                   # [q, K, J, Vb]
        values = values + raw
        deltas = deltas - raw
        upd = contrib.permute(2, 0, 1, 3).reshape(j, -1, vb)
        return values, scatter_add_drop(deltas, nbr_sel.reshape(-1), upd)
    if semiring != "min_plus":
        raise ValueError(f"unknown semiring {semiring!r}")
    d_sel = torch.where(consumed, deltas, INF)[:, sel, :]
    d_sel = torch.where(sel_mask[None, :, None] > 0, d_sel, INF)
    deltas = torch.where(consumed, INF, deltas)
    contrib = mj_spmm(d_sel.transpose(0, 1), tiles, semiring,
                      tile_index=sel_ids)
    return fold_min(values, deltas, contrib, nbr_sel)
