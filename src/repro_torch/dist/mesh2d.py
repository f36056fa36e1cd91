"""jobs x blocks mesh: shard the graph, not just the jobs.

A ("jobs", "blocks") `DeviceMesh` of Dj x S ranks composes the job-axis
placement (`dist.graph`) with a partition of each view's destination-
sorted `BlockPairs` into S contiguous destination ranges:

  * block shard s owns block rows [s*B_loc, (s+1)*B_loc) of every job's
    values/deltas, of the view's ELL tiles, and the pair slice whose
    destinations fall there (pairs are dst-sorted, so the slice is
    contiguous and its run flags stay valid: a run never spans shards);
  * each rank therefore holds about P/S pair tiles and B_N/S ELL rows;
  * every superstep the shards exchange only the FRONTIER, the consumed
    deltas of the <= q selected blocks ([J_loc, q, Vb]), with one
    `all_reduce` over the blocks axis (SUM for plus-times, MIN for
    min-plus).  Each block is owned by one shard; the others contribute
    the semiring's identity, so the collective is exact.
    `RunMetrics.halo_bytes` counts this payload: occupied selection slots
    x Vb x itemsize x live jobs (plus 8 x B_N bytes of queue metadata per
    TwoLevel superstep), never whole tiles.

The reference (`repro.dist.mesh2d`) runs this as one `shard_map` program;
here every rank is a process holding its own slice, and each collective
of the reference is an `all_reduce` on the axis's process group.  A
gather (the reference's `all_gather`) is an `all_reduce(MAX)` of a
buffer filled with -inf into which each rank writes its own entries:
exact, and what gloo takes on CUDA tensors as well as on the CPU.

Scheduling stays one global two-level decision.  Per-(job, shard) DO
queues sample each shard's LOCAL blocks, drawing from the stream
position, the view group, the block shard and the GLOBAL job index; the
queues' rank weights are summed into the global [B_N] priority over the
whole mesh (integers below 2^24, so the sum is exact in any order), and
`synthesize_topq` computes the same global queue on every rank.  The
host driver gathers the global pairs and runs the identical numpy
scheduler on every rank, so its schedule is the one-device schedule.
Min-plus fixpoints are bit-identical to one device; plus-times within
tolerance (bit-identical on the host driver, where only the exchange,
which is exact, separates it from one device).

A job mesh is the same program with one block shard (`dist.graph`): no
frontier exchange, every rank holds the whole view and a slice of the
jobs, and the schedule and the results equal one device bit for bit.

`compress_halo=True` (plus-times groups under shared selections) sends
each owner's rows int8-quantized against a per-(job, slot) scale with
error feedback (`dist.compression.quantize_ef`); the residual stays on
the owned block rows until the block is selected again.  As in the
reference, the payload is counted at one byte an element while the
collective itself moves the dequantized float32 rows.

Groups whose job axis does not divide the jobs axis, or whose B_N does
not divide the blocks axis, fall back to replication along that axis
(identical math, a one-time `MeshLayoutWarning` naming the layout).

A placed session changes like a one-device one.  A view built on the
mesh (a new view, a compaction) is built as this rank's slices alone,
straight from the CSR (`build_group_slices`); `repro_torch.stream` edits
the ELL rows and the pair shard in place and runs its invalidation on
the group's whole job state (`whole_job_state`); growth gathers, grows
and re-slices the job rows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.algorithms.base import PLUS_TIMES
from repro_torch.core.do_select import (do_select_device, step_key,
                                        uniform_noise)
from repro_torch.core.global_q import accumulate_priority, synthesize_topq
from repro_torch.core.push import compute_pairs
from repro_torch.dist import comm
from repro_torch.dist.compression import quantize_ef
from repro_torch.graph.structure import (DENSE_OP_MAX_BYTES,
                                         DENSE_OP_MIN_DENSITY, BlockedGraph,
                                         BlockPairs, _dense_op,
                                         _ell_from_pairs, build_view_shard,
                                         chunk_table, run_starts)
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.fused_superstep import kernel as fk
from repro_torch.kernels.fused_superstep.kernel import fused_superstep_call
from repro_torch.kernels.fused_superstep.ops import block_mask, job_live
from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref
from repro_torch.obs.telemetry import (SERIES_FIELDS, device_buffers,
                                       device_rows, device_write,
                                       series_from_rows)

JOBS_AXIS, BLOCKS_AXIS = "jobs", "blocks"
INF = float("inf")
SUM, MIN, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX

#: this process's collectives since the last `reset_collectives` (the
#: drivers reset it at the start of a run and read it at the end)
COLLECTIVES = {"count": 0, "seconds": 0.0}


def reset_collectives() -> None:
    COLLECTIVES["count"] = 0
    COLLECTIVES["seconds"] = 0.0

__all__ = [
    "Mesh2DSpec", "GroupLayout", "MeshLayoutWarning", "PairShards",
    "make_mesh2d", "partition_block_pairs", "place_pair_shards",
    "shard_session_2d", "unshard_session", "place_group",
    "build_group_slices", "gather_group_state", "whole_job_state",
    "build_device_step_2d",
    "device_inputs_2d", "finish_device_2d", "shared_push_fn_2d",
    "indep_push_fn_2d", "host_halo_bytes", "reset_layout_warnings", "warn_layout_once",
    "check_mesh",
]


class MeshLayoutWarning(UserWarning):
    """A view group could not shard along a requested mesh axis and fell
    back to replication there (identical math, more memory/compute)."""


_LAYOUT_WARNED: set = set()


def reset_layout_warnings() -> None:
    """Forget which fallback layouts have been warned about (tests)."""
    _LAYOUT_WARNED.clear()


def warn_layout_once(view_key, axis_name: str, n_shard: int, size: int,
                     chosen: str) -> None:
    """One-time MeshLayoutWarning naming the layout actually chosen."""
    tag = (tuple(view_key), axis_name, n_shard, size, chosen)
    if tag in _LAYOUT_WARNED:
        return
    _LAYOUT_WARNED.add(tag)
    warnings.warn(
        f"view {view_key}: size {size} does not divide mesh axis "
        f"'{axis_name}' ({n_shard} shards) — falling back to layout "
        f"'{chosen}' (replicated along '{axis_name}'; identical math)",
        MeshLayoutWarning, stacklevel=3)


def check_mesh(mesh) -> DeviceMesh:
    """`mesh` if it is a DeviceMesh over every rank of an initialized
    default process group, else raise (TypeError / RuntimeError /
    ValueError)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh= takes a torch.distributed.device_mesh.DeviceMesh "
            "(dist.graph.make_job_mesh, dist.mesh2d.make_mesh2d), got "
            f"{type(mesh).__name__}")
    if not dist.is_initialized():
        raise RuntimeError(
            "mesh= needs an initialized default process group: call "
            "torch.distributed.init_process_group in every rank first "
            "(dist.world.run_world starts ranks that have one)")
    if mesh.size() != dist.get_world_size():
        raise ValueError(
            f"the mesh spans {mesh.size()} ranks, the world "
            f"{dist.get_world_size()}: a session's mesh spans every rank")
    return mesh


def make_mesh2d(jobs: int = 1, blocks: int = 1, *,
                jobs_axis: str = JOBS_AXIS, blocks_axis: str = BLOCKS_AXIS,
                device_type: Optional[str] = None) -> DeviceMesh:
    """(jobs x blocks) DeviceMesh over the ranks of the default process
    group, which must number jobs * blocks.  `device_type` None means
    CUDA and raises without a card (pass "cpu")."""
    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        raise RuntimeError("make_mesh2d needs an initialized default "
                           "process group (dist.world.run_world)")
    n = jobs * blocks
    if n != dist.get_world_size():
        raise ValueError(f"a {jobs} x {blocks} mesh needs {n} ranks, the "
                         f"world has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(jobs, blocks),
                      mesh_dim_names=(jobs_axis, blocks_axis))


# ---------------------------------------------------------------------------
# placement spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupLayout:
    """Per-view-group placement decision on a mesh."""

    jobs_sharded: bool
    blocks_sharded: bool


@dataclasses.dataclass
class Mesh2DSpec:
    """A session's placement on a mesh: (jobs x blocks), or a job mesh
    (`blocks_axis=None`: one block shard).

    Held on the session as `sess._mesh2d`; its signature() joins the
    step-function cache key, so entering, leaving and re-entering a mesh
    reuses one entry per (policy, placement).  Its collectives are
    counted and timed in `COLLECTIVES`."""

    mesh: DeviceMesh
    jobs_axis: Optional[str] = JOBS_AXIS
    blocks_axis: Optional[str] = BLOCKS_AXIS
    compress_halo: bool = False
    bits: int = 8

    def _size(self, axis: Optional[str]) -> int:
        if axis is None:
            return 1
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(axis)))

    def _index(self, axis: Optional[str]) -> int:
        return 0 if axis is None else int(self.mesh.get_local_rank(axis))

    @property
    def jobs_shards(self) -> int:
        return self._size(self.jobs_axis)

    @property
    def block_shards(self) -> int:
        return self._size(self.blocks_axis)

    @property
    def jobs_index(self) -> int:
        return self._index(self.jobs_axis)

    @property
    def blocks_index(self) -> int:
        return self._index(self.blocks_axis)

    @property
    def blocks_group(self):
        return self.mesh.get_group(self.blocks_axis)

    def signature(self) -> tuple:
        return ("mesh2d" if self.blocks_axis else "jobs", self.jobs_shards,
                self.block_shards, self.jobs_axis, self.blocks_axis,
                bool(self.compress_halo), int(self.bits))

    def layout(self, grp, warn: bool = False) -> GroupLayout:
        """Shard along an axis iff the group's extent divides it."""
        return self.layout_of(grp.key, grp.capacity, grp.graph.num_blocks,
                              warn)

    def layout_of(self, key, cap: int, bn: int,
                  warn: bool = False) -> GroupLayout:
        """`layout` of a view `key` with `cap` job slots over `bn`
        blocks (a group that does not exist yet)."""
        js = cap % self.jobs_shards == 0
        bs = bn % self.block_shards == 0
        if warn and not js and self.jobs_shards > 1:
            warn_layout_once(key, self.jobs_axis, self.jobs_shards, cap,
                             "jobs-replicated")
        if warn and not bs and self.block_shards > 1:
            warn_layout_once(key, self.blocks_axis, self.block_shards, bn,
                             "blocks-replicated")
        return GroupLayout(jobs_sharded=js, blocks_sharded=bs)

    def pair_shard(self, lay: GroupLayout) -> Tuple[int, int]:
        """(shards, this rank's shard) of a group's pair view: its block
        shard of a blocks-sharded group, else the whole view."""
        if lay.blocks_sharded and self.block_shards > 1:
            return self.block_shards, self.blocks_index
        return 1, 0

    def job_range(self, cap: int, lay: GroupLayout) -> Tuple[int, int]:
        """(first global job slot, local job count) of this rank."""
        if not lay.jobs_sharded:
            return 0, cap
        n = cap // self.jobs_shards
        return self.jobs_index * n, n

    def block_range(self, bn: int, lay: GroupLayout) -> Tuple[int, int]:
        """(first global block, local block count) of this rank."""
        if not lay.blocks_sharded:
            return 0, bn
        n = bn // self.block_shards
        return self.blocks_index * n, n

    def exchanges(self, lay: GroupLayout) -> bool:
        """Whether the group's frontier crosses block shards."""
        return lay.blocks_sharded and self.block_shards > 1

    def counted(self, lay: GroupLayout) -> bool:
        """Whether this rank's share of a (jobs, blocks)-sliced quantity
        counts in a world sum: every rank holding a distinct slice does,
        of replicas along an axis only index 0 (the reference's
        `_sum_unique` gate)."""
        return ((lay.jobs_sharded or self.jobs_index == 0)
                and (lay.blocks_sharded or self.blocks_index == 0))

    def counted_rows(self, lay: GroupLayout) -> bool:
        """Whether this rank's share of a per-job quantity that every
        block shard holds whole counts in a world sum."""
        return ((lay.jobs_sharded or self.jobs_index == 0)
                and self.blocks_index == 0)

    @property
    def counted_once(self) -> bool:
        """Whether this rank counts a quantity every rank holds whole."""
        return self.jobs_index == 0 and self.blocks_index == 0

    def all_reduce(self, t: torch.Tensor, op, group=None) -> torch.Tensor:
        """`dist.all_reduce` in place (world by default), counted and
        timed on the host, and listed in `dist.comm.record()`'s open
        lists with its dtype, shape and group."""
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=group)
        COLLECTIVES["seconds"] += time.perf_counter() - t0
        COLLECTIVES["count"] += 1
        if comm.recording():
            ranks = (tuple(range(dist.get_world_size())) if group is None
                     else tuple(dist.get_process_group_ranks(group)))
            comm.add_call(comm.Call("all-reduce",
                                    t.numel() * t.element_size(), ranks,
                                    str(t.dtype), tuple(t.shape)))
        return t


# ---------------------------------------------------------------------------
# PairShards: the dst-partitioned BlockPairs view, this rank's slice
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PairShards:
    """`BlockPairs` partitioned into S contiguous destination ranges, as
    one rank holds it: its own shard's slice in `local`.

      local       the shard's pairs as a `BlockPairs`: src GLOBAL source
                  blocks, dst LOCAL destination blocks (minus the shard's
                  offset), run flags, run offsets and chunk table, the
                  shard's tiles, dst_touched [B_loc]; `local.num_blocks`
                  is B_loc.  An empty shard keeps one inert pad (src 0,
                  dst 0, an all-`fill` tile: an exact no-op in both
                  semirings).
      src_nnz     [B_N] int32 GLOBAL real pairs per source block (the
                  tile_pair_loads count does not depend on the placement)
      shard_pairs real pairs of every shard; pair_cap is the largest.

    The reference pads every shard to pair_cap for shard_map's uniform
    shapes; a rank's slice needs no common shape, so only an empty shard
    is padded."""

    num_shards: int
    pair_cap: int
    block_size: int
    num_blocks: int
    blocks_per_shard: int
    fill: float
    shard: int
    shard_pairs: Tuple[int, ...]
    local: BlockPairs
    src_nnz: torch.Tensor
    # host keys of the real pairs (dst_local * B_N + src, ascending), read
    # once for the stream's in-place edits; the structure never changes
    # in place (a compaction builds a new PairShards)
    _keys: Optional[np.ndarray] = dataclasses.field(default=None,
                                                    repr=False,
                                                    compare=False)

    def signature(self) -> tuple:
        return (self.num_shards, self.pair_cap, self.block_size,
                self.num_blocks, self.blocks_per_shard, self.fill,
                self.shard, self.local.num_pairs)

    @property
    def tile_bytes(self) -> int:
        """Bytes of this rank's pair tiles."""
        return int(self.local.tiles.numel()) * 4

    def _host_keys(self) -> np.ndarray:
        if self._keys is None:
            n = self.shard_pairs[self.shard]     # the inert pad excluded
            src = self.local.src[:n].cpu().numpy().astype(np.int64)
            dst = self.local.dst[:n].cpu().numpy().astype(np.int64)
            self._keys = dst * self.num_blocks + src
        return self._keys

    def pair_index(self, sb, db) -> np.ndarray:
        """Local index of the pair (source block sb, GLOBAL destination
        block db) for each entry, -1 where this shard does not hold it."""
        sb = np.asarray(sb, dtype=np.int64)
        dl = np.asarray(db, dtype=np.int64) - self.shard * \
            self.blocks_per_shard
        keys = self._host_keys()
        if len(keys) == 0:
            return np.full(sb.shape, -1, dtype=np.int64)
        key = dl * self.num_blocks + sb
        i = np.minimum(np.searchsorted(keys, key), len(keys) - 1)
        hit = (dl >= 0) & (dl < self.blocks_per_shard) & (keys[i] == key)
        return np.where(hit, i, -1)

    def pairs_of_sources(self, sb) -> Tuple[np.ndarray, np.ndarray]:
        """(local pair indices, which entry of `sb` each belongs to): every
        pair of this shard whose source block is in `sb`."""
        sb = np.asarray(sb, dtype=np.int64)
        src = self._host_keys() % self.num_blocks
        order = np.argsort(src, kind="stable")
        lo = np.searchsorted(src[order], sb, side="left")
        n = np.searchsorted(src[order], sb, side="right") - lo
        which = np.repeat(np.arange(len(sb)), n)
        k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        return order[np.repeat(lo, n) + k], which


def partition_block_pairs(bp: BlockPairs, n_shards: int, fill: float,
                          shard: int = 0) -> PairShards:
    """Shard `shard` of a dst-sorted `BlockPairs` split into `n_shards`
    contiguous destination ranges (num_blocks % n_shards == 0), on bp's
    device.  One shard is `bp` itself."""
    bn, vb = bp.num_blocks, bp.block_size
    if bn % n_shards:
        raise ValueError(
            f"B_N={bn} does not divide into {n_shards} block shards")
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    b_loc = bn // n_shards
    real = int(bp.src_nnz.sum())          # 0 for the edgeless pad view
    if n_shards == 1:
        local = dataclasses.replace(bp, dense_op=None)
        return PairShards(1, max(1, real), vb, bn, bn, float(fill), 0,
                          (real,), local, bp.src_nnz)
    dst = bp.dst.cpu().numpy() if real else np.zeros(0, np.int32)
    bounds = np.searchsorted(dst, np.arange(n_shards + 1) * b_loc,
                             side="left")
    counts = tuple(int(x) for x in np.diff(bounds))
    lo, hi = int(bounds[shard]), int(bounds[shard + 1])
    dev = bp.tiles.device
    dst_touched = bp.dst_touched[shard * b_loc:(shard + 1) * b_loc].clone()
    if hi > lo:
        first = bp.first[lo:hi].clone()
        rs = run_starts(first.cpu().numpy())
        cs, cr = chunk_table(rs)
        local = BlockPairs(
            num_pairs=hi - lo, block_size=vb, num_blocks=b_loc,
            src=bp.src[lo:hi].clone(),
            dst=(bp.dst[lo:hi] - shard * b_loc).to(torch.int32),
            slot=bp.slot[lo:hi].clone(), first=first,
            last=bp.last[lo:hi].clone(), src_nnz=bp.src_nnz,
            dst_touched=dst_touched, tiles=bp.tiles[lo:hi].clone(),
            run_start=torch.as_tensor(rs, device=dev),
            chunk_start=torch.as_tensor(cs, device=dev),
            chunk_run=torch.as_tensor(cr, device=dev))
    else:
        def t(a):
            return torch.as_tensor(a, dtype=torch.int32, device=dev)

        local = BlockPairs(
            num_pairs=1, block_size=vb, num_blocks=b_loc, src=t([0]),
            dst=t([0]), slot=t([0]), first=t([1]), last=t([1]),
            src_nnz=bp.src_nnz, dst_touched=dst_touched,
            tiles=torch.full((1, vb, vb), fill, dtype=torch.float32,
                             device=dev),
            run_start=t([0, 1]), chunk_start=t([0, 1]), chunk_run=t([0]))
    return PairShards(n_shards, max(1, max(counts)), vb, bn, b_loc,
                      float(fill), shard, counts, local, bp.src_nnz)


def place_pair_shards(spec: Mesh2DSpec, bp: BlockPairs, fill: float,
                      blocks_sharded: bool) -> PairShards:
    """This rank's PairShards of `bp` on `spec`: its block shard's slice,
    or the whole view (one shard) for a blocks-replicated group."""
    if blocks_sharded and spec.block_shards > 1:
        return partition_block_pairs(bp, spec.block_shards, fill,
                                     spec.blocks_index)
    return partition_block_pairs(bp, 1, fill, 0)


# ---------------------------------------------------------------------------
# gathers: all_reduce(MAX) of -inf-filled buffers (exact)
# ---------------------------------------------------------------------------


def _gather_max(spec: Mesh2DSpec, local: torch.Tensor, shape,
                index) -> torch.Tensor:
    """The full tensor of `shape` whose `index` slice this rank holds as
    `local`, gathered over the world (float32; replicas write the same
    entries)."""
    buf = torch.full(shape, -INF, dtype=torch.float32, device=local.device)
    buf[index] = local.to(torch.float32)
    return spec.all_reduce(buf, MAX)


def gather_group_state(spec: Mesh2DSpec, grp):
    """A group's whole (values, deltas) [cap, B_N, Vb] and push_scale
    [cap] from this rank's slices, in one collective (every rank calls
    it)."""
    lay = spec.layout(grp)
    cap, bn, vb = grp.capacity, grp.graph.num_blocks, grp.graph.block_size
    j0, jl = spec.job_range(cap, lay)
    b0, bl = spec.block_range(bn, lay)
    n = cap * bn * vb
    buf = torch.full((2 * n + cap,), -INF, dtype=torch.float32,
                     device=grp.values.device)
    st = buf[:2 * n].view(2, cap, bn, vb)
    st[0, j0:j0 + jl, b0:b0 + bl] = grp.values
    st[1, j0:j0 + jl, b0:b0 + bl] = grp.deltas
    buf[2 * n + j0:2 * n + j0 + jl] = grp.push_scale
    spec.all_reduce(buf, MAX)
    return st[0].clone(), st[1].clone(), buf[2 * n:].clone()


def slice_job_state(spec: Mesh2DSpec, grp) -> None:
    """Keep this rank's slices of a group's whole job state: job rows
    [j0, j0 + J_loc) of values/deltas/push_scale and block rows
    [b0, b0 + B_loc) of values/deltas, under the group's layout."""
    lay = spec.layout(grp)
    j0, jl = spec.job_range(grp.capacity, lay)
    b0, bl = spec.block_range(grp.graph.num_blocks, lay)
    grp.values = grp.values[j0:j0 + jl, b0:b0 + bl].contiguous()
    grp.deltas = grp.deltas[j0:j0 + jl, b0:b0 + bl].contiguous()
    grp.push_scale = grp.push_scale[j0:j0 + jl].contiguous()


@contextlib.contextmanager
def whole_job_state(spec: Mesh2DSpec, grp):
    """The group's whole job state on every rank inside the block (one
    gather, a collective, where the layout slices it), this rank's slices
    of it again after: one-device code that reads any job at any vertex
    runs unchanged inside, and every rank keeps what it computed for its
    own slice."""
    lay = spec.layout(grp)
    bn = grp.graph.num_blocks
    if (spec.job_range(grp.capacity, lay)[1] == grp.capacity
            and spec.block_range(bn, lay)[1] == bn):
        yield
        return
    grp.values, grp.deltas, grp.push_scale = gather_group_state(spec, grp)
    try:
        yield
    finally:
        slice_job_state(spec, grp)


def gather_block_adjacency(spec: Mesh2DSpec, grp):
    """The whole view's ELL metadata (nbr_ids [B_N, K] int32, nbr_mask
    [B_N, K] bool, numpy) from this rank's ELL rows (a collective; the
    ids are below 2^24, exact in float32)."""
    g = grp.graph
    bn, k = g.num_blocks, g.nbr_ids.shape[1]
    b0, bl = spec.block_range(bn, spec.layout(grp))
    buf = torch.full((2, bn, k), -INF, dtype=torch.float32,
                     device=g.nbr_ids.device)
    buf[0, b0:b0 + bl] = g.nbr_ids.to(torch.float32)
    buf[1, b0:b0 + bl] = g.nbr_mask.to(torch.float32)
    host = spec.all_reduce(buf, MAX).cpu().numpy()
    return host[0].astype(np.int32), host[1] > 0


def gather_job(spec: Mesh2DSpec, grp, slot: int) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """One job's full (values, deltas) [B_N, Vb] (a collective)."""
    lay = spec.layout(grp)
    bn, vb = grp.graph.num_blocks, grp.graph.block_size
    j0, jl = spec.job_range(grp.capacity, lay)
    b0, bl = spec.block_range(bn, lay)
    buf = torch.full((2, bn, vb), -INF, dtype=torch.float32,
                     device=grp.values.device)
    if j0 <= slot < j0 + jl:
        buf[0, b0:b0 + bl] = grp.values[slot - j0]
        buf[1, b0:b0 + bl] = grp.deltas[slot - j0]
    spec.all_reduce(buf, MAX)
    return buf[0], buf[1]


def gather_counts(spec: Mesh2DSpec, grp, counts: torch.Tensor,
                  resid: Optional[torch.Tensor] = None):
    """[cap] global unconverged counts (float64, on the host) from this
    rank's [J_loc] per-shard counts, and the group's max residual when
    `resid` is given: one collective."""
    lay = spec.layout(grp)
    cap = grp.capacity
    j0, jl = spec.job_range(cap, lay)
    s = spec.block_shards if lay.blocks_sharded else 1
    sidx = spec.blocks_index if lay.blocks_sharded else 0
    buf = torch.full((cap * s + 1,), -INF, dtype=torch.float32,
                     device=counts.device)
    view = buf[:cap * s].view(cap, s)
    view[j0:j0 + jl, sidx] = counts.to(torch.float32)
    if resid is not None:
        buf[-1] = resid
    host = spec.all_reduce(buf, MAX).cpu().numpy()
    tot = host[:cap * s].reshape(cap, s).astype(np.float64).sum(-1)
    return tot, (float(host[-1]) if resid is not None else None)


def host_pairs(spec: Mesh2DSpec, grp, node_un: torch.Tensor,
               p_mean: torch.Tensor, resid: Optional[torch.Tensor] = None):
    """The host driver's ONE read of a group per superstep on a mesh: the
    global [cap, B_N] pairs gathered from every rank's [J_loc, B_loc]
    slice in one collective, then read to the host; with telemetry the
    group's max residual rides along (returned third)."""
    lay = spec.layout(grp)
    cap, bn = grp.capacity, grp.graph.num_blocks
    j0, jl = spec.job_range(cap, lay)
    b0, bl = spec.block_range(bn, lay)
    n = cap * bn
    buf = torch.full((2 * n + 1,), -INF, dtype=torch.float32,
                     device=node_un.device)
    pairs = buf[:2 * n].view(2, cap, bn)
    pairs[0, j0:j0 + jl, b0:b0 + bl] = node_un
    pairs[1, j0:j0 + jl, b0:b0 + bl] = p_mean
    if resid is not None:
        buf[-1] = resid
    host = spec.all_reduce(buf, MAX).cpu().numpy()
    nu = host[:n].reshape(cap, bn)
    pm = host[n:2 * n].reshape(cap, bn)
    if resid is None:
        return nu, pm
    return nu, pm, float(host[-1])


# ---------------------------------------------------------------------------
# shard-local primitives
# ---------------------------------------------------------------------------


def _exchange_shared(spec: Mesh2DSpec, lay: GroupLayout, semiring: str,
                     deltas, sel, msk, boff: int, b_loc: int, bn: int, err,
                     compress: bool, bits: int):
    """Consume the selected blocks' local deltas and exchange the
    frontier: every shard contributes its OWNED rows of the [J, q, Vb]
    selection (the semiring identity elsewhere) and an all_reduce over
    the blocks axis hands every shard the full frontier.  Returns (raw,
    base, d_sel, err): raw the consumed local rows, base the post-consume
    local deltas, d_sel the exchanged frontier (plus-times UNSCALED;
    min-plus inf on invalid slots), err the updated error-feedback
    residual (compress only)."""
    selb = block_mask(sel, msk, bn)                        # [B_N] global
    consumed = selb[boff:boff + b_loc][None, :, None]
    s = sel.long()
    lidx = torch.clamp(s - boff, 0, b_loc - 1)
    owned = (s >= boff) & (s < boff + b_loc) & (msk > 0)
    if semiring == PLUS_TIMES:
        raw = torch.where(consumed, deltas, 0.0)
        t = raw[:, lidx, :]                                # [J, q, Vb]
        if compress:
            t = t + err[:, lidx, :]
            deq, res = quantize_ef(t, bits=bits, axis=-1)
            # drain the residual of re-selected owned rows; pads and
            # unowned slots scatter into a sink row that is dropped
            j, _, vb = err.shape
            ext = torch.cat([err, err.new_zeros(j, 1, vb)], dim=1)
            ext[:, torch.where(owned, lidx, b_loc), :] = torch.where(
                owned[None, :, None], res, 0.0)
            err = ext[:, :b_loc]
            t = deq
        contrib = torch.where(owned[None, :, None], t, 0.0)
        if spec.exchanges(lay):
            spec.all_reduce(contrib, SUM, spec.blocks_group)
        return raw, deltas - raw, contrib, err
    raw = torch.where(consumed, deltas, INF)
    contrib = torch.where(owned[None, :, None], raw[:, lidx, :], INF)
    if spec.exchanges(lay):
        spec.all_reduce(contrib, MIN, spec.blocks_group)
    d_sel = torch.where(msk[None, :, None] > 0, contrib, INF)
    return raw, torch.where(consumed, INF, deltas), d_sel, err


def _exchange_indep(spec: Mesh2DSpec, lay: GroupLayout, semiring: str,
                    deltas, sel, msk, boff: int, b_loc: int, bn: int):
    """Per-job-selection analogue of `_exchange_shared` (sel/msk
    [J, q']); no compression (error feedback is defined per owned block
    row, which per-job consumption would couple across jobs)."""
    j = deltas.shape[0]
    s = sel.long()
    selb = torch.zeros((j, bn), dtype=torch.int32, device=deltas.device)
    selb.scatter_reduce_(1, s, (msk > 0).to(torch.int32), reduce="amax")
    consumed = (selb[:, boff:boff + b_loc] > 0)[:, :, None]
    lidx = torch.clamp(s - boff, 0, b_loc - 1)             # [J, q']
    owned = (s >= boff) & (s < boff + b_loc) & (msk > 0)
    vb = deltas.shape[-1]
    gidx = lidx[:, :, None].expand(-1, -1, vb)
    if semiring == PLUS_TIMES:
        raw = torch.where(consumed, deltas, 0.0)
        contrib = torch.where(owned[:, :, None], raw.gather(1, gidx), 0.0)
        if spec.exchanges(lay):
            spec.all_reduce(contrib, SUM, spec.blocks_group)
        return raw, deltas - raw, contrib
    raw = torch.where(consumed, deltas, INF)
    contrib = torch.where(owned[:, :, None], raw.gather(1, gidx), INF)
    if spec.exchanges(lay):
        spec.all_reduce(contrib, MIN, spec.blocks_group)
    d_sel = torch.where(msk[:, :, None] > 0, contrib, INF)
    return raw, torch.where(consumed, INF, deltas), d_sel


def _widen(semiring: str, d_sel, sel, bn: int, shared: bool):
    """Scatter the exchanged [J, q', Vb] frontier into a [J, B_N, Vb]
    operand indexed by GLOBAL source block (what the pair sweep reads).
    Padded slots alias block 0 with the identity, so they cannot re-push
    it."""
    j, _, vb = d_sel.shape
    s = sel.long()
    if semiring == PLUS_TIMES:
        wide = torch.zeros((j, bn, vb), dtype=torch.float32,
                           device=d_sel.device)
        if shared:
            return wide.index_add_(1, s, d_sel)
        return wide.scatter_add_(1, s[:, :, None].expand(-1, -1, vb), d_sel)
    wide = torch.full((j, bn, vb), INF, dtype=torch.float32,
                      device=d_sel.device)
    idx = (s[None, :, None].expand(j, -1, vb) if shared
           else s[:, :, None].expand(-1, -1, vb))
    return wide.scatter_reduce_(1, idx, d_sel, reduce="amin")


def _overlay_local(ov, sel, d_sel, boff: int, b_loc: int, vb: int,
                   shared: bool):
    """The selected blocks' overlay entries: (picked source deltas, w,
    mask, local flat destination with out-of-shard entries sent to the
    sink b_loc*Vb, in-shard flag), each [J, q', C]."""
    s = sel.long()
    j = d_sel.shape[0]
    src_u, dst = ov.src_u[s].long(), ov.dst[s].long()
    w, mask = ov.w[s], ov.mask[s]
    if shared:                               # [q, C] rows, shared by jobs
        src_u, dst, w, mask = (x[None].expand(j, -1, -1)
                               for x in (src_u, dst, w, mask))
    picked = torch.gather(d_sel, 2, src_u)
    ldst = dst - boff * vb
    ok = (ldst >= 0) & (ldst < b_loc * vb)
    return picked, w, mask, torch.where(ok, ldst, b_loc * vb), ok


def _overlay_plus_local(deltas, d_sel, ov, sel, boff: int, b_loc: int,
                        shared: bool):
    """Scatter the selected blocks' overlay contributions into the LOCAL
    deltas: only entries whose destination vertex falls in this shard's
    rows land (others drop), so overlay updates route to owning shards."""
    if ov is None or ov.capacity == 0:
        return deltas
    j, _, vb = deltas.shape
    picked, w, mask, idx, ok = _overlay_local(ov, sel, d_sel, boff, b_loc,
                                              vb, shared)
    contrib = torch.where(ok & (mask > 0), picked * w * mask, 0.0)
    flat = torch.cat([deltas.reshape(j, -1), deltas.new_zeros(j, 1)], 1)
    flat.scatter_add_(1, idx.reshape(j, -1), contrib.reshape(j, -1))
    # contiguous: the host driver hands it to the next kernel call as is
    return flat[:, :-1].reshape(deltas.shape).contiguous()


def _overlay_min_local(values, d_sel, ov, sel, boff: int, b_loc: int,
                       shared: bool):
    """Scatter-min the selected blocks' overlay relaxations into the
    LOCAL values (the improvement bookkeeping happens once, in the
    caller)."""
    if ov is None or ov.capacity == 0:
        return values
    j, _, vb = values.shape
    picked, w, mask, idx, ok = _overlay_local(ov, sel, d_sel, boff, b_loc,
                                              vb, shared)
    cand = torch.where(ok & (mask > 0), picked + w, INF)
    flat = torch.cat([values.reshape(j, -1),
                      values.new_full((j, 1), INF)], 1)
    flat.scatter_reduce_(1, idx.reshape(j, -1), cand.reshape(j, -1),
                         reduce="amin")
    return flat[:, :-1].reshape(values.shape).contiguous()


def _apply_pairs_local(semiring: str, values, base, raw, d_wide, d_sel,
                       sel, ps: PairShards, scales, msk, overlay,
                       boff: int, b_loc: int, shared: bool,
                       use_kernel: bool, gate=None, src_live=None):
    """One shard's pair run: push the exchanged frontier through the
    LOCAL dst-sorted pair slice (plus the overlay ride-along), with the
    one-shot improvement bookkeeping of the sequential sweep (min is
    order-independent, and deltas[v] = min(base, new value) iff a
    candidate improved).

    use_kernel: `fused_superstep_call` sweeps the slice (the CUDA kernels
    on CUDA tensors at the width contract: d at B_N, base/values and the
    outputs at B_loc; its plain version on CPU tensors), reading `gate`,
    staging only the pairs of `src_live` sources and pushing only the
    rank's jobs with a live row (`job_live`).  Otherwise the plain
    version, `fused_superstep_ref`."""
    lp = ps.local
    touched = lp.dst_touched[None, :, None]
    d_push = (d_wide * scales[:, None, None] if semiring == PLUS_TIMES
              else d_wide)
    if use_kernel:
        call = fused_superstep_call
        meta = dict(run_start=lp.run_start, chunk_start=lp.chunk_start,
                    chunk_run=lp.chunk_run, arrivals=lp.arrivals(),
                    src_live=src_live, job_live=job_live(d_push, semiring),
                    gate=gate, semiring=semiring)
    else:
        call = fused_superstep_ref
        meta = dict(src_live=src_live, semiring=semiring)
    if semiring == PLUS_TIMES:
        out = call(lp.src, lp.dst, lp.first, lp.last, d_push, base,
                   lp.tiles, **meta)[0]
        out = torch.where(touched, out, base)
        d_ov = d_sel * scales[:, None, None] * (
            msk[None, :, None] if shared else msk[:, :, None])
        out = _overlay_plus_local(out, d_ov, overlay, sel, boff, b_loc,
                                  shared)
        return values + raw, out
    vo, do = call(lp.src, lp.dst, lp.first, lp.last, d_push, base,
                  lp.tiles, values=values, **meta)[:2]
    v1 = torch.where(touched, vo, values)
    d1 = torch.where(touched, do, base)
    v2 = _overlay_min_local(v1, d_sel, overlay, sel, boff, b_loc, shared)
    return v2, torch.minimum(d1, torch.where(v2 < v1, v2, INF))


# ---------------------------------------------------------------------------
# device superstep on a mesh: both scheduling levels + exchange + push
# ---------------------------------------------------------------------------


def _policy_mode(policy) -> str:
    from repro_torch.core.policy import AllBlocks, Independent, TwoLevel
    if isinstance(policy, Independent):
        return "indep"
    if isinstance(policy, AllBlocks):
        return "all"
    if isinstance(policy, TwoLevel):
        return "two"
    raise NotImplementedError(
        f"policy {type(policy).__name__} has no mesh device path — run it "
        "on the host backend")


def _compress_flags(spec: Mesh2DSpec, groups, lays, mode: str) -> List[bool]:
    return [spec.compress_halo and g.semiring == PLUS_TIMES
            and mode != "indep" and spec.exchanges(lay)
            for g, lay in zip(groups, lays)]


def build_device_step_2d(policy, sess, spec: Mesh2DSpec):
    """The session's superstep for `policy` on `spec`, as one chunk
    function with the contract of `core.policy.build_device_step`:

        step_fn(state, scales, overlays, pair_shards, max_steps, seed,
                stream_pos) -> (state, unconverged_total)

    state = (it, values, deltas, loads, pushes, pair_loads, iters, boost,
    telemetry rows or None, halo, residuals).  Each rank holds its
    slices of values/deltas/iters/residuals and its PARTIAL totals: the
    share of loads/pushes/pair_loads/halo (and of the telemetry row's
    summed columns) that counts once in a world sum (`Mesh2DSpec.
    counted`); `finish_device_2d` sums them once at the end of the run.

    Per superstep on every rank: pairs of the local slice; ONE world
    all_reduce of the per-job unconverged counts with (TwoLevel) the
    queues' rank weights and heads; the global queue; per group the
    frontier exchange over the blocks axis (none on a job mesh) and the
    shard's pair run through the fused kernels (`gate = live & group
    active`, `src_live` the selected blocks).  A gloo collective on a
    CUDA tensor waits for the stream, so every collective is also a host
    sync; `RunMetrics.host_syncs` still counts chunks, and the
    collectives are counted apart.  Cache via session._device_step_fn."""
    groups = sess.view_groups()
    n_groups = len(groups)
    algs = [g.alg for g in groups]
    lays = [spec.layout(g, warn=True) for g in groups]
    mode = _policy_mode(policy)
    q, alpha, samples = int(sess.q), float(sess.alpha), int(sess.samples)
    bn = int(sess.scheduler.num_blocks)
    from repro_torch.core.policy import INF_CHUNK, _pairs_and_resid
    chunk = (INF_CHUNK if policy.steps_per_sync == math.inf
             else int(policy.steps_per_sync))
    needs_pairs = policy.needs_pairs
    tel_cap = sess.series_capacity
    use_kernel = bool(sess.use_pallas)
    caps = [g.capacity for g in groups]
    offs = np.cumsum([0] + caps).tolist()
    jr = [spec.job_range(c, lay) for c, lay in zip(caps, lays)]
    br = [spec.block_range(bn, lay) for lay in lays]
    vbs = [int(g.graph.block_size) for g in groups]
    compress = _compress_flags(spec, groups, lays, mode)
    any_x = any(spec.exchanges(lay) for lay in lays)
    w_cnt = [float(spec.counted(lay)) for lay in lays]
    w_rows = [float(spec.counted_rows(lay)) for lay in lays]
    once = int(spec.counted_once)
    shard_key = [spec.blocks_index if spec.exchanges(lay) else None
                 for lay in lays]

    def sample(gi, nu, pm, key):
        noise = uniform_noise(key, gi, tuple(nu.shape), nu.device,
                              job0=jr[gi][0], shard=shard_key[gi])
        sel, msk = do_select_device(nu, pm, q, noise, samples)
        return sel + br[gi][0], msk

    def counts_and_priority(node_uns, sels, msks, dev):
        """ONE world all_reduce: every job's global unconverged count at
        its global position, then (TwoLevel) the [B_N] rank-weight sum
        and head flags."""
        tot = offs[-1]
        extra = 2 * bn if mode == "two" else 0
        buf = torch.zeros(tot + extra, dtype=torch.float64, device=dev)  # noqa: RPT006 - exact sum
        for gi in range(n_groups):
            j0, jl = jr[gi]
            buf[offs[gi] + j0:offs[gi] + j0 + jl] = (
                node_uns[gi].sum(-1).to(torch.float64) * w_cnt[gi])  # noqa: RPT006 - exact sum
        if mode == "two":
            pri = torch.zeros(bn, dtype=torch.float32, device=dev)
            heads = torch.zeros(bn, dtype=torch.bool, device=dev)
            for gi in range(n_groups):
                p_l, h_l = accumulate_priority(
                    torch.zeros(bn, dtype=torch.float32, device=dev),
                    torch.zeros(bn, dtype=torch.bool, device=dev),
                    sels[gi], msks[gi], q)
                pri = pri + p_l * w_cnt[gi]
                heads = heads | (h_l & bool(w_cnt[gi]))
            buf[tot:tot + bn] = pri.to(torch.float64)  # noqa: RPT006 - exact world sum
            buf[tot + bn:] = heads.to(torch.float64)  # noqa: RPT006 - exact world sum
        return spec.all_reduce(buf, SUM)

    def unconverged_total(vs, ds):
        dev = vs[0].device
        buf = torch.zeros(1, dtype=torch.float64, device=dev)  # noqa: RPT006 - exact world sum
        for gi in range(n_groups):
            buf += algs[gi].unconverged(vs[gi], ds[gi]).sum() * w_cnt[gi]
        return spec.all_reduce(buf, SUM)[0]

    def superstep(carry, scales, ovs, prs, max_steps, seed, stream_pos):
        (it, vs, ds, loads, pushes, pair_loads, iters, boost, tel, halo,
         errs) = carry
        dev = it.device
        node_uns, p_means, resids = [], [], []
        for gi in range(n_groups):
            b0, bl = br[gi]
            if needs_pairs:
                if tel_cap:
                    nu, pm, resid = _pairs_and_resid(algs[gi], vs[gi],
                                                     ds[gi])
                    resids.append(resid)
                else:
                    nu, pm = compute_pairs(algs[gi], vs[gi], ds[gi])
                pm = pm + boost[b0:b0 + bl][None, :] * (nu > 0)
            else:
                un = algs[gi].unconverged(vs[gi], ds[gi])
                nu = un.sum(-1).to(torch.float32)
                pm = None
                if tel_cap:
                    resids.append(algs[gi].vertex_priority(
                        vs[gi], ds[gi]).max())
            node_uns.append(nu)
            p_means.append(pm)
        key = step_key(seed, stream_pos + it)
        lsels, lmsks = [], []
        if mode != "all":
            for gi in range(n_groups):
                sel, msk = sample(gi, node_uns[gi], p_means[gi], key)
                lsels.append(sel)
                lmsks.append(msk)
        buf = counts_and_priority(node_uns, lsels, lmsks, dev)
        tot = offs[-1]
        live = (buf[:tot].sum() > 0) & (it < max_steps)
        counts_g = [buf[offs[gi]:offs[gi + 1]] for gi in range(n_groups)]
        act_loc = [counts_g[gi][jr[gi][0]:jr[gi][0] + jr[gi][1]] > 0
                   for gi in range(n_groups)]
        n_lives = [(c > 0).sum() for c in counts_g]

        # -- selection ----------------------------------------------------
        if mode == "two":
            gsel, gmsk = synthesize_topq(buf[tot:tot + bn].to(torch.float32),
                                         buf[tot + bn:] > 0, q, alpha)
            on = gmsk > 0
            tile_loads = on.sum() * once
            sel_pushes = torch.zeros((), dtype=torch.int64, device=dev)
            for gi in range(n_groups):
                b0, bl = br[gi]
                s = gsel.long()
                own = (s >= b0) & (s < b0 + bl) & on
                lsel = torch.clamp(s - b0, 0, bl - 1)
                sel_pushes = sel_pushes + (
                    (node_uns[gi][:, lsel] > 0) & own[None, :]
                ).sum() * int(w_cnt[gi])
            sels, msks = [gsel] * n_groups, [gmsk] * n_groups
            shared = True
        elif mode == "all":
            gsel = torch.arange(bn, dtype=torch.int32, device=dev)
            gmsk = torch.ones(bn, dtype=torch.float32, device=dev)
            tile_loads = torch.full((), bn * once, dtype=torch.int64,
                                    device=dev)
            sel_pushes = bn * sum(n_lives) * once
            sels, msks = [gsel] * n_groups, [gmsk] * n_groups
            shared = True
        else:   # indep: per-(job, shard) queues, gathered over blocks
            sels, msks = [], []
            tile_loads = torch.zeros((), dtype=torch.int64, device=dev)
            for gi in range(n_groups):
                sel, msk = lsels[gi], lmsks[gi]
                if spec.exchanges(lays[gi]):
                    s_n = spec.block_shards
                    g = torch.full((2, s_n) + tuple(sel.shape), -INF,
                                   dtype=torch.float32, device=dev)
                    g[0, spec.blocks_index] = sel.to(torch.float32)
                    g[1, spec.blocks_index] = msk
                    spec.all_reduce(g, MAX, spec.blocks_group)
                    jl = sel.shape[0]
                    sel = g[0].transpose(0, 1).reshape(jl, -1).to(
                        torch.int32)
                    msk = g[1].transpose(0, 1).reshape(jl, -1)
                sels.append(sel)
                msks.append(msk)
                tile_loads = tile_loads + (msk > 0).sum() * int(w_rows[gi])
            sel_pushes = tile_loads
            shared = False

        # -- exchange + per-shard pair runs --------------------------------
        new_vs, new_ds, new_iters, new_errs = [], [], [], []
        pair_step = torch.zeros((), dtype=torch.int64, device=dev)
        halo_step = torch.zeros((), dtype=torch.int64, device=dev)
        for gi in range(n_groups):
            g, lay = groups[gi], lays[gi]
            b0, bl = br[gi]
            sel, msk = sels[gi], msks[gi]
            keep = n_lives[gi] > 0
            upd = live & keep
            on = msk > 0
            nnz = prs[gi].src_nnz[sel.long()]
            if shared:
                raw, base, d_sel, err2 = _exchange_shared(
                    spec, lay, g.semiring, ds[gi], sel, msk, b0, bl, bn,
                    errs[gi], compress[gi], spec.bits)
                pair_cnt = (nnz * on).sum() * once
                occ = on.sum()
            else:
                raw, base, d_sel = _exchange_indep(
                    spec, lay, g.semiring, ds[gi], sel, msk, b0, bl, bn)
                err2 = errs[gi]
                pair_cnt = (nnz * on).sum() * int(w_rows[gi])
                occ = on.sum() * int(w_rows[gi])
            d_wide = _widen(g.semiring, d_sel, sel, bn, shared)
            v2, d2 = _apply_pairs_local(
                g.semiring, vs[gi], base, raw, d_wide, d_sel, sel, prs[gi],
                scales[gi], msk, ovs[gi], b0, bl, shared,
                use_kernel and shared, gate=upd,
                src_live=block_mask(sel, msk, bn) if shared else None)
            new_vs.append(torch.where(upd, v2, vs[gi]))
            new_ds.append(torch.where(upd, d2, ds[gi]))
            new_errs.append(torch.where(upd, err2, errs[gi])
                            if compress[gi] else errs[gi])
            new_iters.append(iters[gi] + (live & act_loc[gi]).to(torch.int32))
            pair_step = pair_step + keep.to(torch.int64) * pair_cnt
            if spec.exchanges(lay):
                if shared:
                    itemb = 1 if compress[gi] else 4
                    payload = occ * (vbs[gi] * itemb) * n_lives[gi] * once
                else:
                    payload = occ * (vbs[gi] * 4)
                halo_step = halo_step + keep.to(torch.int64) * payload
        if mode == "two" and any_x:
            halo_step = halo_step + 8 * bn * once
        if tel_cap:
            occ_t = ((msks[0] > 0).sum() * once if shared else tile_loads)
            tel = device_write(
                tel, torch.clamp(it, max=tel_cap - 1).reshape(1), live,
                active_jobs=sum(n_lives) * once, tile_loads=tile_loads,
                job_block_pushes=sel_pushes, gq_occupancy=occ_t,
                dirty_blocks=(boost > 0).sum() * once,
                unconverged=torch.stack([c.sum() * once for c in counts_g]),
                max_residual=torch.stack(resids).to(torch.float64),  # noqa: RPT006 - telemetry row
                tile_pair_loads=pair_step,
                halo_bytes=halo_step.to(torch.float64))  # noqa: RPT006 - telemetry rows are float64
        li = live.to(torch.int64)
        return (it + li, tuple(new_vs), tuple(new_ds),
                loads + li * tile_loads, pushes + li * sel_pushes,
                pair_loads + li * pair_step, tuple(new_iters),
                torch.where(live, torch.zeros_like(boost), boost), tel,
                halo + li * halo_step, tuple(new_errs))

    def step_fn(state, scales, ovs, prs, max_steps, seed, stream_pos):
        for _ in range(chunk):
            state = superstep(state, scales, ovs, prs, max_steps, seed,
                              stream_pos)
        return state, unconverged_total(state[1], state[2])

    step_fn.chunk = chunk
    return step_fn


def device_inputs_2d(policy, sess):
    """(state, scales, overlays, pair_shards): the mesh device driver's
    initial carry over this rank's slices (fresh telemetry rows when the
    session has telemetry, zero residuals where the exchange is
    compressed) and the per-group arguments of its step function."""
    spec = sess._mesh2d
    groups = sess.view_groups()
    lays = [spec.layout(g) for g in groups]
    dev = sess.device
    boost = sess._consume_dirty_boost()
    bn = sess.scheduler.num_blocks
    tel_cap = sess.series_capacity
    compress = _compress_flags(spec, groups, lays, _policy_mode(policy))
    errs = tuple(torch.zeros_like(g.deltas) if comp
                 else torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
                 for g, comp in zip(groups, compress))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    state = (zero.clone(),
             tuple(g.values for g in groups),
             tuple(g.deltas for g in groups),
             zero.clone(), zero.clone(), zero.clone(),
             tuple(torch.zeros(g.values.shape[0], dtype=torch.int32,
                               device=dev) for g in groups),
             torch.zeros(bn, dtype=torch.float32, device=dev)
             if boost is None
             else torch.as_tensor(boost, dtype=torch.float32, device=dev),
             device_buffers(tel_cap, len(groups), dev) if tel_cap else None,
             zero.clone(), errs)
    return (state, tuple(g.push_scale for g in groups),
            tuple(g.overlay for g in groups),
            tuple(sess._pair_shards(g) for g in groups))


def finish_device_2d(sess, state, it_h: int, m) -> None:
    """The end of a device run on a mesh (the chunk loop is
    `core.policy._run_device`'s): the carry's partial totals, with its
    halo-bytes slot, summed over the world into `m`, and the run's
    collectives counted (`RunMetrics.collectives`, `.collective_s`)."""
    spec = sess._mesh2d
    groups = sess.view_groups()
    lays = [spec.layout(g) for g in groups]
    dev = sess.device
    tel_cap = sess.series_capacity
    # the partial totals, every job's iterations and the telemetry rows'
    # summed columns in ONE world sum (float64 holds the counts exactly
    # up to 2^53); the rows' max_residual columns in one max
    caps = [g.capacity for g in groups]
    offs = np.cumsum([0] + caps).tolist()
    iters = torch.zeros(offs[-1], dtype=torch.float64, device=dev)  # noqa: RPT006 - exact world sum
    for gi, (g, lay) in enumerate(zip(groups, lays)):
        j0, jl = spec.job_range(g.capacity, lay)
        iters[offs[gi] + j0:offs[gi] + j0 + jl] = (
            state[6][gi].to(torch.float64) * float(spec.counted_rows(lay)))  # noqa: RPT006 - exact
    parts = [torch.stack([state[3], state[4], state[5], state[9]]).to(
        torch.float64), iters]  # noqa: RPT006 - exact world sum
    n_sum = len(SERIES_FIELDS) + len(groups)
    rows = device_rows(state[8], it_h) if tel_cap else None
    if tel_cap:
        parts.append(rows[:, :n_sum].reshape(-1))
    # this rank's B1/B2 counts ride the same read, after the world sum
    flat = torch.cat([spec.all_reduce(torch.cat(parts), SUM),
                      fk.b1b2_counts(dev).to(torch.float64)]).cpu().numpy()  # noqa: RPT006 - exact
    m.b1b2_stagings, m.b1b2_jobs_skipped = (int(x) for x in flat[-2:])
    flat = flat[:-2]
    m.tile_loads, m.job_block_pushes, m.tile_pair_loads = (
        int(x) for x in flat[:3])
    m.halo_bytes = float(flat[3])
    m.iterations_per_job = flat[4:4 + offs[-1]].astype(np.int64)
    if tel_cap:
        k = rows.shape[0]
        resid = spec.all_reduce(rows[:, n_sum:].contiguous(), MAX)
        full = np.concatenate(
            [flat[4 + offs[-1]:].reshape(k, n_sum),
             resid.cpu().numpy()], axis=1)
        m.telemetry = series_from_rows(full, it_h, tel_cap,
                                       [g.key for g in groups])
    m.collectives = COLLECTIVES["count"]
    m.collective_s = COLLECTIVES["seconds"]


# ---------------------------------------------------------------------------
# host-backend push functions (scheduling on the host, push on the mesh)
# ---------------------------------------------------------------------------


def shared_push_fn_2d(spec: Mesh2DSpec, grp, use_pallas: bool):
    """Mesh replacement for `core.push.shared_push_fn`: the same
    signature with `pairs` this rank's `PairShards`.  It consumes the
    host scheduler's global [q] selection, exchanges the frontier and
    runs the shard's pair slice.  The host scheduler sees GLOBAL pairs
    (`host_pairs`), so the schedule, and for min-plus the fixpoint bit
    for bit, match one device."""
    lay = spec.layout(grp, warn=True)
    semiring = grp.semiring
    bn = int(grp.graph.num_blocks)
    b0, bl = spec.block_range(bn, lay)

    def fn(values, deltas, tiles, nbr_ids, sel, msk, scales, overlay,
           pairs, gate=None):
        del tiles, nbr_ids
        raw, base, d_sel, _ = _exchange_shared(
            spec, lay, semiring, deltas, sel, msk, b0, bl, bn, None, False,
            spec.bits)
        d_wide = _widen(semiring, d_sel, sel, bn, True)
        return _apply_pairs_local(
            semiring, values, base, raw, d_wide, d_sel, sel, pairs, scales,
            msk, overlay, b0, bl, True, use_pallas, gate=gate,
            src_live=block_mask(sel, msk, bn))

    return fn


def indep_push_fn_2d(spec: Mesh2DSpec, grp, pairs: PairShards):
    """Mesh replacement for `core.push.indep_push_fn` over this rank's
    `pairs`, with its signature: per-job [J, q] GLOBAL selections (this
    rank takes its jobs' rows).  The plain pair sweep, as the
    reference's."""
    lay = spec.layout(grp, warn=True)
    semiring = grp.semiring
    bn = int(grp.graph.num_blocks)
    b0, bl = spec.block_range(bn, lay)
    j0, jl = spec.job_range(grp.capacity, lay)

    def fn(values, deltas, tiles, nbr_ids, sel, msk, scales, overlay):
        del tiles, nbr_ids
        sel, msk = sel[j0:j0 + jl], msk[j0:j0 + jl]
        raw, base, d_sel = _exchange_indep(spec, lay, semiring, deltas,
                                           sel, msk, b0, bl, bn)
        d_wide = _widen(semiring, d_sel, sel, bn, False)
        return _apply_pairs_local(
            semiring, values, base, raw, d_wide, d_sel, sel, pairs, scales,
            msk, overlay, b0, bl, False, False)

    return fn


def host_halo_bytes(spec: Optional[Mesh2DSpec], groups, selection,
                    actives) -> float:
    """Frontier payload of one HOST-driver superstep: occupied selection
    slots x Vb x 4 bytes x live jobs, summed over the pushed groups whose
    frontier crosses block shards."""
    if spec is None or spec.block_shards <= 1:
        return 0.0
    total = 0.0
    for gi, (grp, act) in enumerate(zip(groups, actives)):
        if not act.any() or not spec.exchanges(spec.layout(grp)):
            continue
        vb = int(grp.graph.block_size)
        if selection.shared:
            occ = float(np.sum(np.asarray(selection.msk) > 0))
            total += occ * vb * 4.0 * float(act.sum())
        else:
            total += float(np.sum(np.asarray(selection.msk[gi]) > 0)) \
                * vb * 4.0
    return total


# ---------------------------------------------------------------------------
# session placement
# ---------------------------------------------------------------------------


def place_group(session, grp, spec: Mesh2DSpec) -> None:
    """Place one view group held whole on this rank: keep job rows
    [j0, j0 + J_loc) of values/deltas/push_scale, block rows
    [b0, b0 + B_loc) of values/deltas, neighbour ids and mask, and the
    shard's `PairShards` cut from the view's current pair view (its tile
    edits and overlay as they are).  Where the blocks axis slices the
    ELL rows, the rank keeps its rows of the ELL tiles: cut from them
    where built, else built now from the whole pair view, which is not
    kept (a view that keeps its rows whole builds its ELL tiles from its
    pair view on demand, as on one device).  The dense operator is
    dropped, as the reference drops it under a mesh.  Purely local: no
    collective."""
    lay = spec.layout(grp, warn=True)
    g = grp.graph
    bp = session._pair_data(grp)
    ps = place_pair_shards(spec, bp, float(grp.alg.graph_fill),
                           lay.blocks_sharded)
    slice_job_state(spec, grp)
    b0, bl = spec.block_range(g.num_blocks, lay)
    if bl != g.num_blocks:
        if g.ell is None:
            g.build_ell = functools.partial(
                _ell_from_pairs, bp, b0, bl, g.max_nbr_blocks, g.fill)
            session._watch_ell(grp)
            g.tiles                   # the shard keeps other rows' pairs
        else:
            g.tiles = g.tiles[b0:b0 + bl].clone()
        g.build_ell = None
        g.nbr_ids = g.nbr_ids[b0:b0 + bl].clone()
        g.nbr_mask = g.nbr_mask[b0:b0 + bl].clone()
    grp.pairs = None
    grp.pair_shards = (spec.signature(), ps)
    del bp
    if session.device.type == "cuda":
        # hand the freed whole view back to the driver now: the next
        # view's slices would otherwise be carved out of its cached
        # segments and pin them (other ranks on the card need them)
        torch.cuda.empty_cache()


def build_group_slices(session, spec: Mesh2DSpec, key,
                       cap: int) -> Tuple[BlockedGraph, PairShards]:
    """This rank's slices of view `key` (with `cap` job slots) built
    straight from the session's CSR (`graph.structure.build_view_shard`):
    its ELL rows and its `PairShards`, bit-equal to placing a whole build,
    which is never made.  A new view and a compaction place this way;
    purely local, no collective."""
    _, fill, normalize, symmetrize = key
    csr = session._csr.symmetrized() if symmetrize else session._csr
    bn = -(-csr.n // session.block_size)
    n_shards, shard = spec.pair_shard(spec.layout_of(key, cap, bn))
    g, local, counts = build_view_shard(
        csr, session.block_size, n_shards, shard, fill=fill,
        normalize=normalize, device=session.device)
    return g, PairShards(n_shards, max(1, max(counts)), g.block_size, bn,
                         bn // n_shards, float(fill), shard, counts, local,
                         local.src_nnz)


def place_session(session, spec: Mesh2DSpec):
    """Place every view group of `session` on `spec` (`place_group`; a
    session with no view yet builds each view's slices alone when it is
    first submitted, `build_group_slices`).  Purely local: no collective,
    so ranks may place one after another (the full view of a rank lives
    only until its own placement).  A session already placed on the same
    mesh and axes keeps its slices (only the exchange options change); on
    another placement it is gathered back first (a collective)."""
    prev = getattr(session, "_mesh2d", None)
    if prev is not None:
        if prev.mesh is spec.mesh and prev.signature()[:5] == \
                spec.signature()[:5]:
            for grp in session.view_groups():
                grp.pair_shards = (spec.signature(), grp.pair_shards[1])
            session._mesh2d = spec
            return session
        unshard_session(session)
    for grp in session.view_groups():
        place_group(session, grp, spec)
    session._mesh2d = spec
    return session


def shard_session_2d(mesh: DeviceMesh, session,
                     axes=(JOBS_AXIS, BLOCKS_AXIS),
                     compress_halo: bool = False, bits: int = 8):
    """Place a GraphSession on a (jobs x blocks) mesh (`place_session`)
    and record the placement as `session._mesh2d`, which routes the
    device superstep and the host push functions through this module
    until `unshard_session`."""
    check_mesh(mesh)
    ja, ba = axes
    names = mesh.mesh_dim_names or ()
    if ja not in names or ba not in names:
        raise ValueError(f"mesh axes {names} do not include {axes}")
    return place_session(session, Mesh2DSpec(
        mesh, ja, ba, compress_halo=compress_halo, bits=bits))


def unshard_session(session):
    """Gather every view group back to one-device placement and clear the
    mesh routing (the inverse of `place_session`; a collective: every
    rank calls it).  Job state is gathered exactly.  A view whose ELL
    rows are sliced over the blocks axis is rebuilt whole from the
    session's CSR as `compact()` rebuilds it (its overlay folded into the
    tiles), never gathered; only a session adopted without a CSR gathers
    its ELL rows.  A view kept whole takes its pair shard back as its
    pair view (its ELL tiles, where built, stay)."""
    spec = getattr(session, "_mesh2d", None)
    if spec is None:
        return session
    rebuild = []
    for grp in session.view_groups():
        lay = spec.layout(grp)
        g = grp.graph
        bn = g.num_blocks
        b0, bl = spec.block_range(bn, lay)
        grp.values, grp.deltas, grp.push_scale = gather_group_state(spec,
                                                                    grp)
        if bl != bn and session._csr is not None:
            rebuild.append(grp)
        elif bl != bn:
            k = g.tiles.shape[1]
            rows = (slice(b0, b0 + bl),)
            g.tiles = _gather_max(spec, g.tiles, (bn,) + tuple(
                g.tiles.shape[1:]), rows)
            g.nbr_ids = _gather_max(spec, g.nbr_ids, (bn, k),
                                    rows).to(torch.int32)
            g.nbr_mask = _gather_max(spec, g.nbr_mask, (bn, k), rows) > 0
            grp.pairs = None
        else:
            local = grp.pair_shards[1].local
            grp.pairs = dataclasses.replace(local, dense_op=_dense_op(
                local, g.fill, DENSE_OP_MIN_DENSITY, DENSE_OP_MAX_BYTES))
        grp.pair_shards = None
    session._mesh2d = None
    if rebuild:
        from repro_torch.stream.apply import compact_group
        for grp in rebuild:
            compact_group(session, grp)
    return session
