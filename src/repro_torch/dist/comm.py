"""The training path's collectives over torch.distributed, each one
counted: the gathers and reductions of placed state (`dist.sharding`),
the batch sums of the loss (`dist.act`), the pipeline's exchange
(`dist.pipeline`), the barriers of checkpoints, and the sequence's
gathers and scatters of training under the "tp" rules (`dist.tp`), whose
autograd counterparts (`AllGather`, `ReduceScatter`, `Psum`) carry a
backward.

Ranks sit on a mesh (`launch.mesh.Mesh`): a rank's coordinates are its
global rank unravelled row-major in the mesh's axis order, and the ranks
that differ only along some axes form that axes' group.  The reference
names an axis inside `shard_map`; here a collective takes the group.

Backend.  NCCL (one card a rank) takes device tensors.  gloo (the CPU,
and ranks sharing a card) runs its collectives on host tensors: a CUDA
tensor is copied to a page-locked host buffer, the collective runs
there and the result is copied back, always and in plain code, so that
what gloo takes on CUDA tensors never decides whether a step runs (its
point-to-point ops read a CUDA tensor's address on the host and fail).
`STATS` counts every call, the bytes it handles and its host seconds,
the copies' share apart.

`record()` lists the calls themselves while it is active (a planning
tool reads them: `launch.dryrun`): one `Call` a collective, its op under
the reference's HLO name, its bytes as the reference's collective
inventory counts them (`repro/launch/hlo_analysis.py`: the op's output
on one device: the whole gathered tensor, the reduced buffer, one
scattered shard, the sent buffer) and its group's global ranks.  It
changes neither `STATS` nor any result.  The graph engine's collectives
(`dist.mesh2d.Mesh2DSpec.all_reduce`, counted in its own `COLLECTIVES`)
list theirs through `add_call`, with their dtype and shape.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: this process's collectives since the last `reset_stats`: calls, the
#: bytes of the whole tensor each one assembles, reduces or sends, its
#: host seconds (copies included) and the seconds of the host copies
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "copy_seconds": 0.0}

_GROUPS: Dict[tuple, Tuple[object, Tuple[int, ...]]] = {}


class Call(NamedTuple):
    """One collective as `record()` lists it."""
    op: str                  # all-gather, all-reduce, reduce-scatter,
    #                          broadcast or collective-permute
    nbytes: int              # the op's output on one device
    ranks: Tuple[int, ...]   # the group's global ranks
    dtype: str = ""          # the tensor's dtype and shape, where the
    shape: Tuple[int, ...] = ()  # caller lists them (`add_call`)


#: the lists of the active `record()` contexts (every thread's calls: the
#: autograd engine's thread runs a backward's collectives)
_RECORDS: List[List[Call]] = []


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0, copy_seconds=0.0)


def clear_groups() -> None:
    """Forget every process group `group` built (a world destroyed and
    another initialized may reuse the old world's id)."""
    _GROUPS.clear()


@contextlib.contextmanager
def record():
    """Within: every collective appends its `Call` to the yielded list."""
    calls: List[Call] = []
    _RECORDS.append(calls)
    try:
        yield calls
    finally:
        _RECORDS.remove(calls)


def recording() -> bool:
    """Whether a `record()` is active."""
    return bool(_RECORDS)


def add_call(call: Call) -> None:
    """List `call` in every active `record()` (a collective made outside
    this module: `dist.mesh2d.Mesh2DSpec.all_reduce`)."""
    for calls in _RECORDS:
        calls.append(call)


def _ranks(g) -> Tuple[int, ...]:
    if g is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(g))


def in_world() -> bool:
    return dist.is_available() and dist.is_initialized()


def _require(mesh, what: str) -> None:
    n = int(np.prod(mesh.sizes))
    if not in_world():
        raise RuntimeError(
            f"{what} over mesh {dict(mesh.shape)} needs an initialized "
            f"process group of {n} ranks (start the ranks with "
            f"dist.world.run_world or torchrun); none is initialized")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"{what} over mesh {dict(mesh.shape)} needs a process group of "
            f"{n} ranks; this one has {dist.get_world_size()}")


def coords(mesh, what: str = "a split") -> Dict[str, int]:
    """This rank's coordinate on every axis of `mesh` (row-major in the
    mesh's axis order); raises without a process group of the mesh's
    size."""
    _require(mesh, what)
    idx = np.unravel_index(dist.get_rank(), tuple(mesh.sizes))
    return {a: int(i) for a, i in zip(mesh.axis_names, idx)}


def shard_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's shard, the shard count) of a dim split over `axes`,
    read major to minor as a PartitionSpec entry reads them."""
    c = coords(mesh)
    sizes = [mesh.shape[a] for a in axes]
    idx = int(np.ravel_multi_index([c[a] for a in axes], sizes)) \
        if axes else 0
    return idx, int(np.prod(sizes)) if axes else 1


def group(mesh, axes: Sequence[str]):
    """The process group of the ranks that differ from this one only
    along `axes` (None: the whole world), its members in shard order.
    Every rank builds every group of `axes` the first time (a
    collective call)."""
    axes = tuple(axes)
    key = (id(dist.group.WORLD), mesh.axis_names, mesh.sizes, axes)
    if key not in _GROUPS:
        _require(mesh, f"a group over {axes}")
        names, sizes = mesh.axis_names, tuple(mesh.sizes)
        others = [a for a in names if a not in axes]
        mine = None
        for rest in np.ndindex(*[mesh.shape[a] for a in others]):
            members = []
            for sub in np.ndindex(*[mesh.shape[a] for a in axes]):
                c = dict(zip(others, rest))
                c.update(zip(axes, sub))
                members.append(int(np.ravel_multi_index(
                    [c[a] for a in names], sizes)))
            if members != sorted(members):
                raise NotImplementedError(
                    f"axes {axes} are not in mesh order {names}: their "
                    f"shard order is not the group's rank order")
            if len(members) == dist.get_world_size():
                g = None
            else:
                g = dist.new_group(members)
            if dist.get_rank() in members:
                mine = (g, tuple(members))
        _GROUPS[key] = mine
    return _GROUPS[key]


def _staged(t: torch.Tensor, g) -> bool:
    return t.is_cuda and dist.get_backend(g) == "gloo"


def _pinned(shape, dtype) -> torch.Tensor:
    """A page-locked host buffer (torch's caching host allocator keeps
    freed ones for the next call): the staging copies run at the link's
    rate, not at pageable memory's."""
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)


class _Timed:
    """Counts one collective of `nbytes` and times it (and lists it as
    `op` of `out_bytes` over `ranks`, a callable, where `record()` is
    active); `host(t)` and `back(t, out)` are the gloo staging copies,
    timed apart."""

    def __init__(self, nbytes: int, op: str, out_bytes: int, ranks):
        self.nbytes = nbytes
        self.call = (op, out_bytes, ranks)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def host(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        out = _pinned(t.shape, t.dtype)
        out.copy_(t)
        STATS["copy_seconds"] += time.perf_counter() - t0
        return out

    def back(self, t: torch.Tensor, out: torch.Tensor,
             dim: int = 0) -> torch.Tensor:
        """`t` (the host buffer, laid out with `dim` first) into `out`:
        copied as it lies, then moved into place on the device (a host
        copy with strides runs at a fraction of the link's rate)."""
        t0 = time.perf_counter()
        if dim == 0:
            out.copy_(t)
        else:
            out.copy_(t.to(out.device).movedim(0, dim))
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        STATS["copy_seconds"] += time.perf_counter() - t0
        return out

    def __exit__(self, *exc):
        STATS["calls"] += 1
        STATS["bytes"] += self.nbytes
        STATS["seconds"] += time.perf_counter() - self.t0
        if _RECORDS:
            op, out_bytes, ranks = self.call
            add_call(Call(op, int(out_bytes), ranks()))
        return False


def all_gather(x: torch.Tensor, dim: int, g, n: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The `n` shards of the group concatenated along `dim`, in shard
    order (into `out` when given)."""
    front = x.detach().movedim(dim, 0).contiguous()
    shape = (n * front.shape[0],) + tuple(front.shape[1:])
    nbytes = x.numel() * x.element_size() * n
    with _Timed(nbytes, "all-gather", nbytes, lambda: _ranks(g)) as tm:
        if _staged(x, g):
            src = tm.host(front)
            buf = _pinned(shape, x.dtype)
            dist.all_gather_into_tensor(buf, src, group=g)
            if out is None:
                out = torch.empty(buf.movedim(0, dim).shape, dtype=x.dtype,
                                  device=x.device)
            return tm.back(buf, out, dim)
        buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(buf, front, group=g)
        whole = buf.movedim(0, dim)
        if out is None:
            return whole.contiguous()
        return out.copy_(whole)


def reduce_scatter(x: torch.Tensor, dim: int, g, n: int) -> torch.Tensor:
    """This rank's shard (along `dim`) of the group's sum of `x`."""
    front = x.detach().movedim(dim, 0).contiguous()
    shape = (front.shape[0] // n,) + tuple(front.shape[1:])
    nbytes = x.numel() * x.element_size()
    with _Timed(nbytes, "reduce-scatter", nbytes // n,
                lambda: _ranks(g)) as tm:
        if _staged(x, g):
            src = tm.host(front)
            buf = _pinned(shape, x.dtype)
            dist.reduce_scatter_tensor(buf, src, group=g)
            out = torch.empty(buf.movedim(0, dim).shape, dtype=x.dtype,
                              device=x.device)
            return tm.back(buf, out, dim)
        buf = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(buf, front, group=g)
        return buf.movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, g=None) -> torch.Tensor:
    """The group's sum of `x`, in place."""
    nbytes = x.numel() * x.element_size()
    with _Timed(nbytes, "all-reduce", nbytes, lambda: _ranks(g)) as tm:
        if _staged(x, g):
            buf = tm.host(x)
            dist.all_reduce(buf, group=g)
            return tm.back(buf, x)
        dist.all_reduce(x, group=g)
        return x


def broadcast(x: torch.Tensor, src: int, g=None) -> torch.Tensor:
    """`x` of global rank `src`, in place on every rank."""
    nbytes = x.numel() * x.element_size()
    with _Timed(nbytes, "broadcast", nbytes, lambda: _ranks(g)) as tm:
        if _staged(x, g):
            buf = tm.host(x)
            dist.broadcast(buf, src, group=g)
            return tm.back(buf, x)
        dist.broadcast(x, src, group=g)
        return x


def send_recv(x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    """Send `x` to global rank `to` and return what `frm` sent (shaped
    and typed as `x`)."""
    nbytes = x.numel() * x.element_size()
    with _Timed(nbytes, "collective-permute", nbytes,
                lambda: tuple(sorted({dist.get_rank(), to}))) as tm:
        staged = _staged(x, None)
        src = tm.host(x) if staged else x.contiguous()
        buf = (_pinned(src.shape, src.dtype) if staged
               else torch.empty_like(src))
        ops = [dist.P2POp(dist.isend, src, to),
               dist.P2POp(dist.irecv, buf, frm)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if staged:
            return tm.back(buf, torch.empty_like(x))
        return buf


def barrier() -> None:
    """Wait for every rank (nothing outside a process group)."""
    if in_world():
        dist.barrier()


class Psum(torch.autograd.Function):
    """The group's sum of `x` whose every rank goes on with the same
    (replicated) value.  Its backward hands each rank's cotangent to its
    own term, unsummed: every rank computes the same replicated function
    of the sum, so each rank's cotangent already is the whole one, and
    summing them (as `torch.distributed.nn`'s all_reduce does) would
    count it once a rank.  With `src` (a global rank) every other rank's
    `x` is zero, and the sum is the broadcast of `src`'s, which moves a
    rank's bytes once instead of an all-reduce's twice."""

    @staticmethod
    def forward(ctx, x, g, src):
        if src is None:
            return all_reduce(x.detach().clone(), g)
        return broadcast(x.detach().clone(), src, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def psum(x: torch.Tensor, g=None, src: Optional[int] = None) -> torch.Tensor:
    return Psum.apply(x, g, src)


class AllGather(torch.autograd.Function):
    """`all_gather` whose backward is the reduce-scatter of the cotangent:
    each rank's gathered copy feeds its own share of the work, so the
    gradient of a rank's piece is the sum of every rank's cotangent of
    it."""

    @staticmethod
    def forward(ctx, x, dim, g, n):
        ctx.args = (dim, g, n)
        return all_gather(x, dim, g, n)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_scatter(grad.contiguous(), *ctx.args), None, None,
                None)


class ReduceScatter(torch.autograd.Function):
    """`reduce_scatter` whose backward is the all-gather of the
    cotangent: every rank's term reaches every piece of the sum."""

    @staticmethod
    def forward(ctx, x, dim, g, n):
        ctx.args = (dim, g, n)
        return reduce_scatter(x, dim, g, n)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), *ctx.args), None, None, None


def all_gather_ad(x: torch.Tensor, dim: int, g, n: int) -> torch.Tensor:
    return AllGather.apply(x, dim, g, n)


def reduce_scatter_ad(x: torch.Tensor, dim: int, g, n: int) -> torch.Tensor:
    return ReduceScatter.apply(x, dim, g, n)
