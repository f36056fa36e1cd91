"""Carry a reference run's graph and job state into the port.

This system has no weights; what a run carries is its graph and the
mid-run job state, and on an evolving graph the view's live-update
overlay and its host mirrors.  These functions take the reference's
fields as numpy arrays (from `repro.graph.CSRGraph`, `BlockedGraph`,
`BlockPairs`, `TileOverlay` and a `repro.core.GraphSession` view group)
and build the port's objects on a device, so a run begun in the
reference can continue in the port, mid-stream included.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.session import GraphSession, ViewGroup
from repro_torch.graph.structure import (BlockedGraph, BlockPairs, CSRGraph,
                                         TileOverlay, chunk_table, run_starts)
from repro_torch.kernels.common import resolve_device
from repro_torch.stream.apply import _ensure_mirrors


def _tensor(a, dtype, device) -> torch.Tensor:
    """A device tensor holding a copy of `a` (the reference's arrays are
    read-only, and the port updates some of them in place)."""
    return torch.from_numpy(np.array(a, dtype)).to(device)


def csr_from_arrays(n: int, indptr, indices, weights) -> CSRGraph:
    """A CSRGraph from the reference's (n, indptr, indices, weights)."""
    return CSRGraph(n=int(n), indptr=np.array(indptr, dtype=np.int64),
                    indices=np.array(indices, dtype=np.int32),
                    weights=np.array(weights, dtype=np.float32))


def blocked_from_arrays(n_real: int, block_size: int, num_blocks: int,
                        max_nbr_blocks: int, fill: float, nbr_ids, nbr_mask,
                        tiles, vertex_mask, *, device=None) -> BlockedGraph:
    """A BlockedGraph from the reference's fields (numpy arrays)."""
    dev = resolve_device(device)
    return BlockedGraph(
        n_real=int(n_real), block_size=int(block_size),
        num_blocks=int(num_blocks), max_nbr_blocks=int(max_nbr_blocks),
        fill=float(fill), nbr_ids=_tensor(nbr_ids, np.int32, dev),
        nbr_mask=_tensor(nbr_mask, bool, dev),
        tiles=_tensor(tiles, np.float32, dev),
        vertex_mask=_tensor(vertex_mask, bool, dev))


def pairs_from_arrays(num_pairs: int, block_size: int, num_blocks: int,
                      src, dst, slot, first, last, src_nnz, dst_touched,
                      tiles, dense_op=None, *, device=None) -> BlockPairs:
    """A BlockPairs from the reference's fields (numpy arrays); the port's
    extra `run_start` is derived from `first`, and its chunk table from
    `run_start`."""
    dev = resolve_device(device)

    def t(a, dtype=np.int32):
        return _tensor(a, dtype, dev)

    rs = run_starts(first)
    chunk_start, chunk_run = chunk_table(rs)
    return BlockPairs(
        num_pairs=int(num_pairs), block_size=int(block_size),
        num_blocks=int(num_blocks), src=t(src), dst=t(dst), slot=t(slot),
        first=t(first), last=t(last), src_nnz=t(src_nnz),
        dst_touched=t(dst_touched, bool), tiles=t(tiles, np.float32),
        run_start=t(rs),
        dense_op=None if dense_op is None else t(dense_op, np.float32),
        chunk_start=t(chunk_start), chunk_run=t(chunk_run))


def load_group_state(sess: GraphSession, view_key: tuple, values, deltas,
                     push_scale, active,
                     rng_state: Optional[dict] = None) -> ViewGroup:
    """Install a reference session's mid-run job state into `sess`.

    values/deltas [J, B_N, Vb] and push_scale [J] are the reference view
    group's arrays, `active` its [J] slot mask.  The port's group for
    `view_key` must already exist (submit the same jobs first) and is
    grown to J slots; every slot marked active must hold a submitted job.
    `rng_state` (a `np.random.Generator.bit_generator.state`) continues
    the reference scheduler's stream."""
    grp = sess.groups.get(tuple(view_key))
    if grp is None:
        raise KeyError(f"no view group {view_key!r}: submit its jobs first")
    j = np.shape(values)[0]
    while grp.capacity < j:
        sess._grow(grp)
    if grp.capacity != j:
        raise ValueError(f"state holds {j} slots, the group {grp.capacity}")
    active = np.asarray(active, bool)
    missing = [s for s in np.flatnonzero(active) if grp.algs[s] is None]
    if missing:
        raise ValueError(f"active slots {missing} hold no submitted job")
    dev = sess.device
    grp.values = _tensor(values, np.float32, dev)
    grp.deltas = _tensor(deltas, np.float32, dev)
    grp.push_scale = _tensor(push_scale, np.float32, dev)
    grp.active = active.copy()
    if rng_state is not None:
        sess.scheduler.rng.bit_generator.state = rng_state
    return grp


def load_overlay(sess: GraphSession, view_key: tuple, capacity: int, src_u,
                 dst, w, mask, ov_used=None,
                 ov_entry: Optional[Dict[Tuple[int, int],
                                         Tuple[int, int]]] = None, *,
                 graph: Optional[BlockedGraph] = None) -> ViewGroup:
    """Install a reference view group's live-update state into `sess`.

    src_u/dst/w/mask [B_N, capacity] are the reference's `TileOverlay`
    arrays; `ov_used` [B_N, capacity] bool and `ov_entry` {(u, v):
    (block, col)} its group's host mirrors (None where the reference has
    not built them yet).  `graph` (from `blocked_from_arrays`) replaces
    the group's BlockedGraph when the reference's tiles were edited by
    earlier batches.  The group's (src block, dst block) -> slot mirror
    is rebuilt from its graph and its pair view dropped, so the next run
    rebuilds it.  The group for `view_key` must already exist."""
    grp = sess.groups.get(tuple(view_key))
    if grp is None:
        raise KeyError(f"no view group {view_key!r}: submit its jobs first")
    if graph is not None:
        grp.graph = graph
    bn = grp.graph.num_blocks
    capacity = int(capacity)
    dev = sess.device
    arrays = [np.asarray(a) for a in (src_u, dst, w, mask)]
    for a in arrays:
        if a.shape != (bn, capacity):
            raise ValueError(f"overlay array {a.shape} != {(bn, capacity)}")
    grp.overlay = TileOverlay(
        capacity=capacity,
        src_u=_tensor(arrays[0], np.int32, dev),
        dst=_tensor(arrays[1], np.int32, dev),
        w=_tensor(arrays[2], np.float32, dev),
        mask=_tensor(arrays[3], np.float32, dev))
    grp.pairs = None
    grp.pair_slot = grp.ov_used = grp.ov_entry = None
    if ov_used is not None:
        _ensure_mirrors(grp)
        used = np.array(ov_used, dtype=bool)
        if used.shape != (bn, capacity):
            raise ValueError(f"ov_used {used.shape} != {(bn, capacity)}")
        grp.ov_used = used
        grp.ov_entry = {(int(u), int(v)): (int(b), int(c))
                        for (u, v), (b, c) in (ov_entry or {}).items()}
    return grp
