"""Activation sharding via *logical* axis names (the model code's hooks).

Model code annotates intermediate tensors with logical axes ("dp", "sp",
"tp", "fsdp") through `constrain`, as the reference's does.  Outside an
`activation_sharding(rules)` context every annotation is the identity,
`axis_size` is 1 and `is_serve` is False: the unsharded path on one
device.  Inside one, `axis_size` and `is_serve` answer from the rules
(`dist/sharding.py`).  Every rank is a process holding its own slice,
and the model code computes each activation in the layout its weights'
placements give (`dist/tp.py`), so `constrain` is a mark: it returns `x`
itself, after checking for a process group of the mesh's size where the
rules split it.  In a step each activation is already the rank's rows
of the batch ("dp", "fsdp").  In a serve context a split over "tp",
"sp" or "ep" (the "tp" policy's tensor, sequence and expert
parallelism) is the rank's heads, channels or features where the
compute produced them; over "sp" the stream stays whole on every rank
of "model" (the reference splits it for training memory and for
GSPMD's prefill reshards).  In a train context the loss runs within
`seq_split` (below): the residual stream is the rank's positions of the
sequence, and the blocks split heads, features and experts over "model"
from whole weights (`dist/tp.py`).

Reductions over the sequence.  Within `seq_split(mesh, axes)` the
positions of the sequence are split over those mesh axes, rank i of n
holding the i-th of n equal contiguous pieces (`seq_shard`), and
`psum_seq` sums a rank's term over them: the loss's NLL and count, the
MoE statistics.  `seq_axes` says which axes a train context splits the
sequence over (the "sp" axis of more than one device): the loss enters
`seq_split` over them, and the train step sums each gradient over them.

Reductions over the batch.  Within `batch_split(mesh, axes)` the rows of
the batch are split over those mesh axes (the train step enters it):
`batch_shards` is their count and `psum_batch` sums a rank's term over
them, so that a mean over every row of the batch (the loss's, the MoE
load-balance statistics') is the reference's.  Outside it both are the
identity of one shard.

The contexts are thread-local and re-entrant, as in the reference.  A
recomputation in the backward pass may run on another thread (the
autograd engine's, for CUDA tensors): `checkpoint_contexts` re-enters
there the contexts its forward ran in.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional, Tuple

import torch.distributed as dist

_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def _current() -> Optional[Tuple[object, bool]]:
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def activation_sharding(rules, serve: bool = False):
    """Activate `rules` for constrain / axis_size / is_serve within the
    dynamic extent."""
    _stack().append((rules, serve))
    try:
        yield rules
    finally:
        _stack().pop()


def constrain(x, *logical_axes):
    """`x` itself: a mark.  The layout is the one the compute produced:
    this rank's rows ("dp"/"fsdp"), its positions ("sp" in a train
    context), its heads, channels, features or experts ("tp", "ep").
    A split over a mesh axis of more than one device raises without a
    process group of the mesh's size."""
    cur = _current()
    if cur is None:
        return x
    from repro_torch.dist import comm
    from repro_torch.dist.sharding import split_axes
    rules = cur[0]
    if split_axes(rules.mesh, rules.spec(x.shape, logical_axes)):
        comm.coords(rules.mesh, f"constrain {tuple(logical_axes)}")
    return x


def current_rules():
    """The active context's ShardingRules, or None outside any."""
    cur = _current()
    return None if cur is None else cur[0]


def axis_size(logical_axis: str) -> int:
    """Device count behind a logical axis: 1 outside any context."""
    cur = _current()
    return 1 if cur is None else cur[0].axis_size(logical_axis)


def is_serve() -> bool:
    """False outside any context, else the context's flag."""
    cur = _current()
    return False if cur is None else cur[1]


def _batch_stack() -> list:
    if not hasattr(_local, "batch"):
        _local.batch = []
    return _local.batch


@contextlib.contextmanager
def batch_split(mesh, axes):
    """Within: the batch's rows are split over `axes` of `mesh` (this
    rank holds its share); empty `axes` means every rank holds them all."""
    from repro_torch.dist import comm
    axes = tuple(axes)
    grp = comm.group(mesh, axes) if axes else None
    _batch_stack().append(grp)
    try:
        yield
    finally:
        _batch_stack().pop()


def batch_shards() -> int:
    """How many ranks the batch's rows are split over (1 outside
    `batch_split`)."""
    st = _batch_stack()
    return len(st[-1][1]) if st and st[-1] is not None else 1


def psum_batch(x):
    """`x` summed over the ranks that split the batch (`x` itself where
    none do).  Every rank goes on with the same sum, and its backward
    gives each rank's cotangent to its own term once (`comm.Psum`)."""
    st = _batch_stack()
    if not st or st[-1] is None:
        return x
    from repro_torch.dist import comm
    return comm.psum(x, st[-1][0])


def seq_axes() -> Tuple[str, ...]:
    """The mesh axes of more than one device that the active train
    context's rules split the sequence over ("sp"); () outside a context,
    in a serve context, or where "sp" spans one device."""
    cur = _current()
    if cur is None or cur[1]:
        return ()
    rules = cur[0]
    return tuple(a for a in rules.mesh_axes("sp") if rules.mesh.shape[a] > 1)


class SeqShard(NamedTuple):
    """The positions this rank holds: piece `i` of `n` of a sequence, over
    the process group `group` of the ranks that hold the others."""
    i: int
    n: int
    group: object

    def span(self, s_local: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's `s_local` positions in the sequence."""
        return self.i * s_local, (self.i + 1) * s_local


def _seq_stack() -> list:
    if not hasattr(_local, "seq"):
        _local.seq = []
    return _local.seq


@contextlib.contextmanager
def seq_split(mesh, axes):
    """Within: the sequence's positions are split over `axes` of `mesh`
    (this rank holds its piece, `seq_shard`); empty `axes` means every
    rank holds them all."""
    from repro_torch.dist import comm
    axes = tuple(axes)
    shard = None
    if axes:
        grp, members = comm.group(mesh, axes)
        shard = SeqShard(members.index(dist.get_rank()), len(members), grp)
    _seq_stack().append(shard)
    try:
        yield shard
    finally:
        _seq_stack().pop()


def seq_shard() -> Optional[SeqShard]:
    """This rank's piece of the sequence within `seq_split` (None outside
    it, or where it splits nothing)."""
    st = _seq_stack()
    return st[-1] if st else None


def psum_seq(x):
    """`x` summed over the ranks that split the sequence (`x` itself where
    none do), with `psum_batch`'s backward: each rank's term once."""
    sh = seq_shard()
    if sh is None:
        return x
    from repro_torch.dist import comm
    return comm.psum(x, sh.group)


def _stacks() -> tuple:
    return _stack(), _batch_stack(), _seq_stack()


@contextlib.contextmanager
def _entered(state: tuple):
    """Within: the contexts of `state` (`_stacks()` copied) on this
    thread, whatever it held before."""
    saved = tuple(list(st) for st in _stacks())
    for st, entries in zip(_stacks(), state):
        st[:] = entries
    try:
        yield
    finally:
        for st, entries in zip(_stacks(), saved):
            st[:] = entries


def checkpoint_contexts():
    """`torch.utils.checkpoint`'s `context_fn`: nothing around the
    forward, and around its recomputation the contexts active now (the
    rules, the batch's and the sequence's splits), on whatever thread
    the backward pass recomputes it."""
    state = tuple(list(st) for st in _stacks())
    return contextlib.nullcontext(), _entered(state)
