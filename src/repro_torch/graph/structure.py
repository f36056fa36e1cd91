"""Graph structures: host CSR + device block-ELL dense tiles (PyTorch).

Same layout as the reference (`repro.graph.structure`): for each source
block we keep up to K neighbouring destination blocks (block-ELL), each a
dense [Vb, Vb] tile

  tiles[b, k, u, v] = weight of edge  (b*Vb + u)  ->  (nbr_ids[b, k]*Vb + v)

with `fill` (0.0 for plus-times, +inf for min-plus) where no edge exists.
The host enumeration is numpy, copied from the reference so every array
equals it; the tensors move to the requested device at the end and the
numpy copies are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    """Device-side block-ELL dense-tile layout (see module docstring)."""

    n_real: int          # number of real vertices
    block_size: int      # Vb
    num_blocks: int      # B_N
    max_nbr_blocks: int  # K
    fill: float          # 0.0 (plus-times) or +inf (min-plus)
    nbr_ids: torch.Tensor   # [B_N, K] int32, padded entries point at block 0
    nbr_mask: torch.Tensor  # [B_N, K] bool, True where the tile is real
    tiles: torch.Tensor     # [B_N, K, Vb, Vb] float32
    vertex_mask: torch.Tensor  # [B_N, Vb] bool, True for real vertices

    @property
    def n_padded(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def device(self) -> torch.device:
        return self.tiles.device


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
    _arrivals: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def num_runs(self) -> int:
        return int(self.run_start.shape[0]) - 1

    def arrivals(self, job_chunks: int) -> torch.Tensor:
        """The CUDA kernels' per-(run, job chunk) arrival counters,
        [R * job_chunks] int32, zeroed once on first use.  Each kernel
        call leaves them at zero again (the last thread block of a run
        resets its counter), so the view keeps one array per job-chunk
        count for all its calls."""
        t = self._arrivals.get(job_chunks)
        if t is None:
            t = torch.zeros(self.num_runs * job_chunks, dtype=torch.int32,
                            device=self.run_start.device)
            self._arrivals[job_chunks] = t
        return t


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
    dense_op = None
    density = len(sb) / float(bn * bn)
    if (g.fill == 0.0 and density >= dense_min_density
            and (bn * vb) ** 2 * 4 <= dense_max_bytes):
        op = torch.zeros((bn, vb, bn, vb), dtype=torch.float32, device=dev)
        op[t(sb, torch.int64), :, t(db, torch.int64), :] = tiles
        dense_op = op.reshape(bn * vb, bn * vb)
    rs = run_starts(first)
    chunk_start, chunk_run = chunk_table(rs)
    return BlockPairs(
        num_pairs=len(sb), block_size=vb, num_blocks=bn,
        src=t(sb), dst=t(db), slot=t(slot), first=t(first), last=t(last),
        src_nnz=t(src_nnz), dst_touched=t(touched, torch.bool),
        tiles=tiles, run_start=t(rs), dense_op=dense_op,
        chunk_start=t(chunk_start), chunk_run=t(chunk_run))


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


def build_blocked(csr: CSRGraph, block_size: int, *,
                  fill: float = 0.0,
                  normalize: Optional[str] = None,
                  device=None) -> BlockedGraph:
    """Partition a CSR graph into dense [Vb, Vb] tiles, block-ELL layout,
    on `device` (None: CUDA).

    normalize:
      None          - raw edge weights
      "out_degree"  - weight / out_degree(src)   (PageRank-style stochastic)
      "unit"        - every present edge gets weight 1.0
      "zero"        - every present edge gets weight 0.0 (min-plus label prop)
    """
    dev = resolve_device(device)
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

    sb, db = src // vb, dst // vb
    su, dv = src % vb, dst % vb

    # enumerate distinct (src block, dst block) tile pairs
    pair_key = sb * bn + db
    order = np.argsort(pair_key, kind="stable")
    pair_key_s = pair_key[order]
    uniq_keys, first_idx = np.unique(pair_key_s, return_index=True)
    tile_sb = (uniq_keys // bn).astype(np.int32)
    tile_db = (uniq_keys % bn).astype(np.int32)

    # per-src-block neighbour count -> K
    counts = np.bincount(tile_sb, minlength=bn)
    k_max = max(int(counts.max(initial=0)), 1)

    nbr_ids = np.zeros((bn, k_max), dtype=np.int32)
    nbr_mask = np.zeros((bn, k_max), dtype=bool)
    tiles = np.full((bn, k_max, vb, vb), fill, dtype=np.float32)

    # slot index of each tile within its src block row
    slot_of_key = {}
    next_slot = np.zeros(bn, dtype=np.int64)
    for tkey, tsb, tdb in zip(uniq_keys, tile_sb, tile_db):
        s = next_slot[tsb]
        slot_of_key[int(tkey)] = int(s)
        nbr_ids[tsb, s] = tdb
        nbr_mask[tsb, s] = True
        next_slot[tsb] += 1

    slots = np.fromiter((slot_of_key[int(k)] for k in pair_key),
                        dtype=np.int64, count=len(pair_key))
    tiles[sb, slots, su, dv] = w

    vmask = np.zeros((bn, vb), dtype=bool)
    vmask.reshape(-1)[:n] = True

    # the ELL tiles dominate host memory (15 GB per view at 2^16 vertices,
    # Vb=64): move them and drop the numpy copy before returning
    tiles_t = torch.from_numpy(tiles).to(dev)
    del tiles
    return BlockedGraph(
        n_real=n, block_size=vb, num_blocks=bn, max_nbr_blocks=k_max,
        fill=float(fill),
        nbr_ids=torch.from_numpy(nbr_ids).to(dev),
        nbr_mask=torch.from_numpy(nbr_mask).to(dev),
        tiles=tiles_t, vertex_mask=torch.from_numpy(vmask).to(dev))
