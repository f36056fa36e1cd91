"""Graph structures: host CSR + device block-ELL dense tiles (PyTorch).

Same layout as the reference (`repro.graph.structure`): for each source
block we keep up to K neighbouring destination blocks (block-ELL), each a
dense [Vb, Vb] tile

  tiles[b, k, u, v] = weight of edge  (b*Vb + u)  ->  (nbr_ids[b, k]*Vb + v)

with `fill` (0.0 for plus-times, +inf for min-plus) where no edge exists.
The host enumeration is numpy, copied from the reference so every array
equals it; the tiles are filled on the requested device by one scatter
of the edges (no host copy of them is made).

A session's view (`build_view`) holds its destination-sorted pair tiles
(`BlockPairs`) alone, built straight from the host block adjacency: the
kernel route reads nothing else.  Its `BlockedGraph` keeps the block
metadata (nbr_ids, nbr_mask, vertex_mask, K) and builds the ELL tiles
only when a route that reads them asks (`BlockedGraph.tiles`), by one
scatter of the pair tiles; they then stay with the view.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR over out-edges (numpy)."""

    n: int
    indptr: np.ndarray  # [n+1] int64
    indices: np.ndarray  # [nnz] int32 destination vertex
    weights: np.ndarray  # [nnz] float32

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> "CSRGraph":
        """Build CSR from an edge list; duplicate edges keep the min weight.
        Accepts any array-like input and the empty edge list."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weights is None:
            weights = np.ones(len(src), dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        if not (len(src) == len(dst) == len(weights)):
            raise ValueError(
                f"ragged edge list: {len(src)}/{len(dst)}/{len(weights)}")
        if len(src) and (src.min() < 0 or src.max() >= n
                         or dst.min() < 0 or dst.max() >= n):
            raise ValueError(f"edge endpoints out of range for n={n}")
        # dedupe (src, dst), keep min weight (matters for SSSP correctness)
        key = src * n + dst
        order = np.lexsort((weights, key))
        key, src, dst, weights = key[order], src[order], dst[order], weights[order]
        keep = np.ones(len(key), dtype=bool)
        keep[1:] = key[1:] != key[:-1]
        src, dst, weights = src[keep], dst[keep], weights[keep]
        counts = np.bincount(src, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(n=n, indptr=indptr, indices=dst.astype(np.int32),
                        weights=weights.astype(np.float32))

    def symmetrized(self) -> "CSRGraph":
        """Union of edges and reverse edges (antiparallel pairs keep the
        min weight on both directions)."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.out_degree)
        all_src = np.concatenate([src, self.indices])
        all_dst = np.concatenate([self.indices, src])
        all_w = np.concatenate([self.weights, self.weights])
        return CSRGraph.from_edges(self.n, all_src, all_dst, all_w)

    def row(self, u: int) -> tuple:
        """(dst indices, weights) of u's out-row, dst-ascending."""
        lo, hi = int(self.indptr[u]), int(self.indptr[u + 1])
        return self.indices[lo:hi], self.weights[lo:hi]

    def edge_weight(self, u: int, v: int) -> Optional[float]:
        """Weight of edge (u, v), or None when absent (rows are
        dst-sorted, so this is a binary search)."""
        lo, hi = int(self.indptr[u]), int(self.indptr[u + 1])
        i = lo + int(np.searchsorted(self.indices[lo:hi], v))
        if i < hi and int(self.indices[i]) == v:
            return float(self.weights[i])
        return None


@dataclasses.dataclass
class BlockedGraph:
    """Device-side block-ELL dense-tile layout (see module docstring).

    `ell` holds the [B_N, K, Vb, Vb] tiles, or None where they are built
    on demand: `tiles` then calls `build_ell` once and keeps the result
    in `ell` until the view is rebuilt."""

    n_real: int          # number of real vertices
    block_size: int      # Vb
    num_blocks: int      # B_N
    max_nbr_blocks: int  # K
    fill: float          # 0.0 (plus-times) or +inf (min-plus)
    nbr_ids: torch.Tensor   # [B_N, K] int32, padded entries point at block 0
    nbr_mask: torch.Tensor  # [B_N, K] bool, True where the tile is real
    ell: Optional[torch.Tensor]  # [B_N, K, Vb, Vb] float32, None unbuilt
    vertex_mask: torch.Tensor  # [B_N, Vb] bool, True for real vertices
    build_ell: Optional[Callable[[], torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def tiles(self) -> torch.Tensor:
        """The ELL tiles, built on first use where the view holds none."""
        if self.ell is None:
            if self.build_ell is None:
                raise RuntimeError("the view holds no ELL tiles and has "
                                   "no way to build them")
            self.ell = self.build_ell()
        return self.ell

    @tiles.setter
    def tiles(self, value: torch.Tensor) -> None:
        self.ell = value

    @property
    def ell_bytes(self) -> int:
        """Bytes of the ELL tiles the view holds (0 while unbuilt)."""
        return 0 if self.ell is None else int(self.ell.numel()) * 4

    @property
    def n_padded(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def device(self) -> torch.device:
        return self.nbr_ids.device


@dataclasses.dataclass
class BlockPairs:
    """Destination-sorted sparse block-pair view of a BlockedGraph.

    Only the nonzero (src_block, dst_block) pairs, sorted by destination,
    so each destination block is one contiguous run of pairs:

      src   [P] int32    source block of each pair
      dst   [P] int32    destination block, NON-DECREASING
      slot  [P] int32    the pair's ELL slot k (tiles[src, slot] is its tile)
      first [P] int32    1 at the first pair of each dst run
      last  [P] int32    1 at the last pair of each dst run
      run_start [R+1] int32  pair offset of each dst run (R runs), then P;
                             run r covers pairs run_start[r]:run_start[r+1]
      chunk_start [n_chunks+1] int32, chunk_run [n_chunks] int32
                             the runs cut into work items of at most
                             `PAIR_CHUNK` consecutive pairs (`chunk_table`):
                             chunk c covers pairs
                             chunk_start[c]:chunk_start[c+1] of run
                             chunk_run[c] (what the CUDA kernels hand one
                             thread block)
      src_nnz [B_N] int32   real pairs per SOURCE block (tile_pair_loads)
      dst_touched [B_N] bool  blocks that appear as a destination
      tiles [P, Vb, Vb] f32   contiguous dst-sorted copy of the pair tiles
      dense_op  [B_N*Vb, B_N*Vb] f32 or None — the full adjacency operator,
                built only for plus-times views dense enough to fit the
                byte cap; a reference view for tests.

    An edgeless graph keeps P >= 1 with one inert pad pair (src=dst=0,
    all-`fill` tile — an exact no-op in both semirings, src_nnz all 0).
    """

    num_pairs: int
    block_size: int
    num_blocks: int
    src: torch.Tensor
    dst: torch.Tensor
    slot: torch.Tensor
    first: torch.Tensor
    last: torch.Tensor
    src_nnz: torch.Tensor
    dst_touched: torch.Tensor
    tiles: torch.Tensor
    run_start: torch.Tensor
    chunk_start: torch.Tensor
    chunk_run: torch.Tensor
    dense_op: Optional[torch.Tensor] = None
    _arrivals: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def num_runs(self) -> int:
        return int(self.run_start.shape[0]) - 1

    def arrivals(self) -> torch.Tensor:
        """The CUDA kernels' per-run arrival counters, [R] int32, zeroed
        once on first use.  Each kernel call leaves them at zero again
        (the last work item of a run resets its counter), so the view
        keeps one array for all its calls."""
        if self._arrivals is None:
            self._arrivals = torch.zeros(self.num_runs, dtype=torch.int32,
                                         device=self.run_start.device)
        return self._arrivals


#: build_block_pairs materializes `dense_op` only when the block graph is
#: at least this dense (P / B_N^2) AND the operator stays under the byte cap
DENSE_OP_MIN_DENSITY = 0.25
DENSE_OP_MAX_BYTES = 64 * 2**20


#: pairs per work item of the fused superstep kernels (`chunk_table`);
#: chosen on the H100 from {32, 64, 128, whole run} (PERF.md)
PAIR_CHUNK = 64


def run_starts(first: np.ndarray) -> np.ndarray:
    """[P] first-of-run flags -> [R+1] int32 run offsets (last entry P)."""
    first = np.asarray(first)
    return np.append(np.flatnonzero(first),
                     len(first)).astype(np.int32)


def chunk_table(run_start, chunk: Optional[int] = PAIR_CHUNK):
    """Cut destination runs into work items of at most `chunk` consecutive
    pairs (None: one item per run).

    run_start [R+1] run offsets -> (chunk_start [n_chunks+1] int32,
    chunk_run [n_chunks] int32), numpy: chunk c covers pairs
    chunk_start[c]:chunk_start[c+1] of run chunk_run[c]; the chunks of a
    run are consecutive and in pair order.  Runs the kernels drop (a
    destination outside [0, B_loc)) keep their chunks: those blocks
    return at entry."""
    rs = np.asarray(run_start, dtype=np.int64)
    lens = np.diff(rs)
    per = (np.ones_like(lens) if chunk is None
           else np.maximum(1, -(-lens // int(chunk))))
    chunk_run = np.repeat(np.arange(len(lens)), per)
    first_chunk = np.cumsum(per) - per              # per run
    k = np.arange(len(chunk_run)) - np.repeat(first_chunk, per)
    step = lens if chunk is None else np.full_like(lens, int(chunk))
    starts = rs[chunk_run] + k * np.repeat(step, per)
    chunk_start = np.append(starts, rs[-1]).astype(np.int32)
    return chunk_start, chunk_run.astype(np.int32)


def build_block_pairs(g: BlockedGraph, *,
                      dense_min_density: float = DENSE_OP_MIN_DENSITY,
                      dense_max_bytes: int = DENSE_OP_MAX_BYTES
                      ) -> BlockPairs:
    """Destination-sorted real-pair view of `g` (see BlockPairs), on g's
    device.  The enumeration reads the [B_N, K] ELL metadata on the host;
    the pair tiles are gathered on the device (a copy, not an alias)."""
    dev = g.device
    ids = g.nbr_ids.cpu().numpy()
    msk = g.nbr_mask.cpu().numpy()
    bn, vb = g.num_blocks, g.block_size

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    sb, slot = np.nonzero(msk)
    db = ids[sb, slot]
    src_nnz = np.bincount(sb, minlength=bn).astype(np.int32)
    if len(sb) == 0:
        # inert pad pair: an all-fill tile is an exact no-op (plus-times
        # adds 0.0, min-plus mins +inf), so P stays >= 1
        return BlockPairs(
            num_pairs=1, block_size=vb, num_blocks=bn,
            src=t([0]), dst=t([0]), slot=t([0]), first=t([1]), last=t([1]),
            src_nnz=t(src_nnz),
            dst_touched=torch.zeros(bn, dtype=torch.bool, device=dev),
            tiles=torch.full((1, vb, vb), g.fill, dtype=torch.float32,
                             device=dev),
            run_start=t([0, 1]), chunk_start=t([0, 1]), chunk_run=t([0]))
    order = np.lexsort((sb, db))          # dst-major, src ascending within
    sb, db, slot = sb[order], db[order], slot[order]
    first = np.ones(len(sb), np.int32)
    first[1:] = (db[1:] != db[:-1]).astype(np.int32)
    last = np.ones(len(sb), np.int32)
    last[:-1] = first[1:]
    touched = np.zeros(bn, bool)
    touched[db] = True
    tiles = g.tiles[t(sb, torch.int64), t(slot, torch.int64)]   # [P, Vb, Vb]
    rs = run_starts(first)
    chunk_start, chunk_run = chunk_table(rs)
    bp = BlockPairs(
        num_pairs=len(sb), block_size=vb, num_blocks=bn,
        src=t(sb), dst=t(db), slot=t(slot), first=t(first), last=t(last),
        src_nnz=t(src_nnz), dst_touched=t(touched, torch.bool),
        tiles=tiles, run_start=t(rs),
        chunk_start=t(chunk_start), chunk_run=t(chunk_run))
    bp.dense_op = _dense_op(bp, g.fill, dense_min_density, dense_max_bytes)
    return bp


def _dense_op(bp: BlockPairs, fill: float, min_density: float,
              max_bytes: int) -> Optional[torch.Tensor]:
    """The full [B_N*Vb, B_N*Vb] operator of a plus-times pair view at
    least `min_density` dense (P / B_N^2) whose operator fits
    `max_bytes`; None otherwise (and for the edgeless pad view)."""
    bn, vb = bp.num_blocks, bp.block_size
    if (fill != 0.0 or (bn * vb) ** 2 * 4 > max_bytes
            or bp.tiles.device.type == "meta"):
        return None
    real = int(bp.src_nnz.sum())          # 0 for the edgeless pad view
    if not real or real / float(bn * bn) < min_density:
        return None
    op = torch.zeros((bn, vb, bn, vb), dtype=torch.float32,
                     device=bp.tiles.device)
    op[bp.src.long(), :, bp.dst.long(), :] = bp.tiles
    return op.reshape(bn * vb, bn * vb)


@dataclasses.dataclass
class TileOverlay:
    """Bounded per-block delta-COO staged alongside the base tiles.

    Evolving graphs mutate while jobs run (`repro_torch.stream`).  Most
    edge updates edit the dense base tile in place (the (src block, dst
    block) pair already owns a tile slot); an insert that creates a NEW
    block pair has nowhere to land in the block-ELL layout, so it goes
    into this overlay: for each source block, up to `capacity` explicit
    COO edges, on the session's device.  A push of block b consumes b's
    pending deltas through its tiles AND its overlay row (one
    `tile_loads` unit: the overlay rides along).  When a block's overlay
    row fills up, the owning view COMPACTS: the BlockedGraph is rebuilt
    from the updated CSR (bit-identical to a from-scratch build) and the
    overlay empties.

    Entries with mask 0 are inert by construction (plus-times adds an
    exact 0.0, min-plus mins an inf), and the capacity-0 overlay of a
    never-updated view is skipped outright.

      src_u [B_N, C] int32   source vertex offset within the block
      dst   [B_N, C] int32   destination vertex, global padded index
      w     [B_N, C] float32 edge weight in the VIEW's weight space
                             (normalization already applied)
      mask  [B_N, C] float32 1.0 where the entry is a real edge
    """

    capacity: int
    src_u: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    mask: torch.Tensor


def empty_overlay(num_blocks: int, capacity: int = 0,
                  device=None) -> TileOverlay:
    """All-inert overlay; capacity 0 is the no-updates-yet default."""
    dev = resolve_device(device)
    shape = (num_blocks, capacity)
    return TileOverlay(
        capacity=capacity,
        src_u=torch.zeros(shape, dtype=torch.int32, device=dev),
        dst=torch.zeros(shape, dtype=torch.int32, device=dev),
        w=torch.zeros(shape, dtype=torch.float32, device=dev),
        mask=torch.zeros(shape, dtype=torch.float32, device=dev))


@dataclasses.dataclass
class BlockAdjacency:
    """A view's block-level structure on the host (numpy), what every
    slice of it is cut from: the view's edges, their tile, and each
    tile's (source block, destination block, ELL slot).

      src, dst [E] int64, w [E] float32   the view's edges (normalization
                                          applied), CSR order
      edge_tile [E] int64                 each edge's tile
      tile_sb, tile_db [T] int64          the tiles' blocks, (sb, db)-sorted
      tile_slot [T] int64                 the tile's ELL slot in row sb
                                          (its rank among row sb's tiles)
      k_max                               K, the widest ELL row (>= 1)
    """

    n: int
    block_size: int
    num_blocks: int
    k_max: int
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    edge_tile: np.ndarray
    tile_sb: np.ndarray
    tile_db: np.ndarray
    tile_slot: np.ndarray


def block_adjacency(csr: CSRGraph, block_size: int,
                    normalize: Optional[str] = None) -> BlockAdjacency:
    """The view of `csr` at `block_size` as a `BlockAdjacency` (see
    `build_blocked` for `normalize`)."""
    n = csr.n
    vb = block_size
    bn = -(-n // vb)  # ceil

    src = np.repeat(np.arange(n, dtype=np.int64), csr.out_degree)
    dst = csr.indices.astype(np.int64)
    w = csr.weights.astype(np.float32).copy()
    if normalize == "out_degree":
        deg = np.maximum(csr.out_degree, 1).astype(np.float32)
        w = w / deg[src]
    elif normalize == "unit":
        w = np.ones_like(w)
    elif normalize == "zero":
        w = np.zeros_like(w)
    elif normalize is not None:
        raise ValueError(f"unknown normalize={normalize!r}")

    # distinct (src block, dst block) tiles, sorted; a tile's slot is its
    # rank among its source block's tiles (destination-ascending)
    keys, edge_tile = np.unique((src // vb) * bn + dst // vb,
                                return_inverse=True)
    tile_sb, tile_db = keys // bn, keys % bn
    counts = np.bincount(tile_sb, minlength=bn)
    row_start = np.cumsum(counts) - counts
    return BlockAdjacency(
        n=n, block_size=vb, num_blocks=bn,
        k_max=max(int(counts.max(initial=0)), 1), src=src, dst=dst, w=w,
        edge_tile=edge_tile.reshape(-1), tile_sb=tile_sb, tile_db=tile_db,
        tile_slot=np.arange(len(keys)) - row_start[tile_sb])


def _scatter_tiles(dev: torch.device, shape, fill: float, flat: np.ndarray,
                   w: np.ndarray) -> torch.Tensor:
    """[shape] float32 tiles on `dev`, filled with `fill` and w[i] written
    at flat index flat[i] (int64: a view's tiles pass 2^31 floats), in one
    scatter on the device; no host copy of the tiles is made.  On the
    meta device they are allocated there and never filled (a dry run
    reads their shape only)."""
    tiles = torch.empty(shape, dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return tiles
    tiles.fill_(fill)
    if len(flat):
        tiles.view(-1)[torch.as_tensor(flat, device=dev)] = \
            torch.as_tensor(w, dtype=torch.float32, device=dev)
    return tiles


def _ell_fill(adj: BlockAdjacency, fill: float, b0: int, b_loc: int,
              dev: torch.device) -> torch.Tensor:
    """The ELL tiles of source blocks [b0, b0 + b_loc), from the
    adjacency: each edge written into its tile's slot."""
    vb, k = adj.block_size, adj.k_max
    sb = adj.src // vb
    e = np.flatnonzero((sb >= b0) & (sb < b0 + b_loc))
    flat = ((((sb[e] - b0) * k + adj.tile_slot[adj.edge_tile[e]]) * vb
             + adj.src[e] % vb) * vb + adj.dst[e] % vb)
    return _scatter_tiles(dev, (b_loc, k, vb, vb), fill, flat, adj.w[e])


def _ell_from_pairs(pairs: BlockPairs, b0: int, b_loc: int, k: int,
                    fill: float) -> torch.Tensor:
    """The ELL tiles of source blocks [b0, b0 + b_loc) from a pair view
    holding every pair of those rows: each pair's tile scattered to its
    (source block, slot), so the ELL equals the pairs' tiles as they are
    now, stream edits included."""
    vb = pairs.block_size
    dev = pairs.tiles.device
    tiles = torch.empty((b_loc, k, vb, vb), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return tiles
    tiles.fill_(fill)
    src, slot = pairs.src.long() - b0, pairs.slot.long()
    if b0 == 0 and b_loc >= int(pairs.src_nnz.shape[0]):
        tiles[src, slot] = pairs.tiles
    else:
        keep = torch.nonzero((src >= 0) & (src < b_loc)).reshape(-1)
        tiles[src[keep], slot[keep]] = pairs.tiles.index_select(0, keep)
    return tiles


def _ell_rows(adj: BlockAdjacency, fill: float, b0: int, b_loc: int,
              dev: torch.device, tiles: bool = True) -> BlockedGraph:
    """The ELL rows of source blocks [b0, b0 + b_loc) as a BlockedGraph
    whose other fields (num_blocks, K, vertex_mask) are the view's; with
    `tiles` False its tiles are left unbuilt (the caller sets how they
    are built)."""
    vb, bn = adj.block_size, adj.num_blocks
    nbr_ids = np.zeros((b_loc, adj.k_max), dtype=np.int32)
    nbr_mask = np.zeros((b_loc, adj.k_max), dtype=bool)
    t = np.flatnonzero((adj.tile_sb >= b0) & (adj.tile_sb < b0 + b_loc))
    nbr_ids[adj.tile_sb[t] - b0, adj.tile_slot[t]] = adj.tile_db[t]
    nbr_mask[adj.tile_sb[t] - b0, adj.tile_slot[t]] = True

    vmask = np.zeros((bn, vb), dtype=bool)
    vmask.reshape(-1)[:adj.n] = True
    return BlockedGraph(
        n_real=adj.n, block_size=vb, num_blocks=bn, max_nbr_blocks=adj.k_max,
        fill=float(fill),
        nbr_ids=torch.from_numpy(nbr_ids).to(dev),
        nbr_mask=torch.from_numpy(nbr_mask).to(dev),
        ell=_ell_fill(adj, fill, b0, b_loc, dev) if tiles else None,
        vertex_mask=torch.from_numpy(vmask).to(dev))


def _pair_slice(adj: BlockAdjacency, fill: float, n_shards: int,
                shard: int, dev: torch.device):
    """(pairs, shard_pairs): the dst-sorted pairs whose destinations fall
    in block shard `shard` of `n_shards` as one BlockPairs (src global,
    dst local to the shard, the shard's run and chunk tables, src_nnz
    global, dst_touched [B_loc]; an empty shard keeps one inert pad),
    and the real pairs of every shard."""
    vb, bn = adj.block_size, adj.num_blocks
    b_loc = bn // n_shards
    lo_b = shard * b_loc

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    order = np.lexsort((adj.tile_sb, adj.tile_db))   # dst-major, src asc.
    db = adj.tile_db[order]
    bounds = np.searchsorted(db, np.arange(n_shards + 1) * b_loc)
    counts = tuple(int(x) for x in np.diff(bounds))
    lo, hi = int(bounds[shard]), int(bounds[shard + 1])
    src_nnz = t(np.bincount(adj.tile_sb, minlength=bn))
    touched = np.zeros(b_loc, bool)
    if hi == lo:
        # inert pad pair: an all-fill tile is an exact no-op (plus-times
        # adds 0.0, min-plus mins +inf), so P stays >= 1
        return BlockPairs(
            num_pairs=1, block_size=vb, num_blocks=b_loc,
            src=t([0]), dst=t([0]), slot=t([0]), first=t([1]), last=t([1]),
            src_nnz=src_nnz, dst_touched=t(touched, torch.bool),
            tiles=torch.full((1, vb, vb), fill, dtype=torch.float32,
                             device=dev),
            run_start=t([0, 1]), chunk_start=t([0, 1]),
            chunk_run=t([0])), counts
    sel = order[lo:hi]
    sb, dl = adj.tile_sb[sel], db[lo:hi] - lo_b
    first = np.ones(len(sel), np.int32)
    first[1:] = (dl[1:] != dl[:-1]).astype(np.int32)
    last = np.ones(len(sel), np.int32)
    last[:-1] = first[1:]
    touched[dl] = True
    rs = run_starts(first)
    chunk_start, chunk_run = chunk_table(rs)

    # each edge of the shard's pairs lands in its pair's tile
    pos = np.full(len(adj.tile_sb), -1, dtype=np.int64)
    pos[sel] = np.arange(len(sel))
    p = pos[adj.edge_tile]
    e = np.flatnonzero(p >= 0)
    flat = (p[e] * vb + adj.src[e] % vb) * vb + adj.dst[e] % vb
    tiles_t = _scatter_tiles(dev, (len(sel), vb, vb), fill, flat, adj.w[e])
    return BlockPairs(
        num_pairs=len(sel), block_size=vb, num_blocks=b_loc,
        src=t(sb), dst=t(dl), slot=t(adj.tile_slot[sel]), first=t(first),
        last=t(last), src_nnz=src_nnz, dst_touched=t(touched, torch.bool),
        tiles=tiles_t, run_start=t(rs), chunk_start=t(chunk_start),
        chunk_run=t(chunk_run)), counts


def build_blocked(csr: CSRGraph, block_size: int, *,
                  fill: float = 0.0,
                  normalize: Optional[str] = None,
                  device=None) -> BlockedGraph:
    """Partition a CSR graph into dense [Vb, Vb] tiles, block-ELL layout,
    on `device` (None: CUDA), its tiles built at once.

    normalize:
      None          - raw edge weights
      "out_degree"  - weight / out_degree(src)   (PageRank-style stochastic)
      "unit"        - every present edge gets weight 1.0
      "zero"        - every present edge gets weight 0.0 (min-plus label prop)
    """
    dev = resolve_device(device)
    adj = block_adjacency(csr, block_size, normalize)
    return _ell_rows(adj, fill, 0, adj.num_blocks, dev)


def build_view(csr: CSRGraph, block_size: int, *, fill: float = 0.0,
               normalize: Optional[str] = None, device=None):
    """A session's view of `csr` as (graph, pairs), built straight from
    the host block adjacency: `pairs` equals `build_block_pairs(
    build_blocked(...))` field by field, and `graph` holds the block
    metadata with its ELL tiles unbuilt; asked for, they are scattered
    from `pairs` (`BlockedGraph.tiles`).  No [B_N, K, Vb, Vb] tensor is
    made on the way."""
    dev = resolve_device(device)
    adj = block_adjacency(csr, block_size, normalize)
    pairs, _ = _pair_slice(adj, fill, 1, 0, dev)
    pairs.dense_op = _dense_op(pairs, fill, DENSE_OP_MIN_DENSITY,
                               DENSE_OP_MAX_BYTES)
    g = _ell_rows(adj, fill, 0, adj.num_blocks, dev, tiles=False)
    g.build_ell = functools.partial(_ell_from_pairs, pairs, 0,
                                    adj.num_blocks, adj.k_max, float(fill))
    return g, pairs


def build_view_shard(csr: CSRGraph, block_size: int, n_shards: int = 1,
                     shard: int = 0, *, fill: float = 0.0,
                     normalize: Optional[str] = None, device=None):
    """Block shard `shard` of `n_shards` of the view `build_blocked` would
    build, built straight from the CSR without the whole view: (graph,
    pairs, shard_pairs).

      graph        the ELL rows of source blocks [s*B_loc, (s+1)*B_loc)
                   (nbr_ids, nbr_mask [B_loc, K]; num_blocks, K and
                   vertex_mask those of the whole view), their tiles
                   unbuilt: asked for, they are scattered from `pairs`
                   where it is the whole view (one shard), else written
                   from the CSR's adjacency at this build (so a caller
                   that edits the tiles builds them first)
      pairs        the dst-sorted `BlockPairs` slice whose destinations
                   fall in the same range, as `dist.mesh2d.
                   partition_block_pairs` cuts `build_block_pairs` of the
                   whole view (without its dense operator)
      shard_pairs  the real pairs of every shard

    Bit-equal to slicing the whole build; only the host's block-level
    adjacency of the whole view is computed, the tiles only for the
    shard.  B_N must divide into `n_shards`."""
    dev = resolve_device(device)
    adj = block_adjacency(csr, block_size, normalize)
    bn = adj.num_blocks
    if bn % n_shards:
        raise ValueError(
            f"B_N={bn} does not divide into {n_shards} block shards")
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    b_loc = bn // n_shards
    pairs, counts = _pair_slice(adj, fill, n_shards, shard, dev)
    g = _ell_rows(adj, fill, shard * b_loc, b_loc, dev, tiles=False)
    g.build_ell = (
        functools.partial(_ell_from_pairs, pairs, 0, bn, adj.k_max,
                          float(fill)) if n_shards == 1
        else functools.partial(_ell_fill, adj, float(fill), shard * b_loc,
                               b_loc, dev))
    return g, pairs, counts
