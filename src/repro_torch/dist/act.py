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
GSPMD's prefill reshards).  Outside a serve context such a split is
training under "tp", which is not ported (ROADMAP A12.2d), and raises.

Reductions over the batch.  Within `batch_split(mesh, axes)` the rows of
the batch are split over those mesh axes (the train step enters it):
`batch_shards` is their count and `psum_batch` sums a rank's term over
them, so that a mean over every row of the batch (the loss's, the MoE
load-balance statistics') is the reference's.  Outside it both are the
identity of one shard.

The contexts are thread-local and re-entrant, as in the reference.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

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


_BATCH_LOGICAL = ("dp", "fsdp")


def constrain(x, *logical_axes):
    """`x` itself: outside any context, where the rules split it over no
    mesh axis of more than one device, over "dp"/"fsdp" only (this rank's
    rows), or in a serve context (the layout the compute produced).  A
    split over "tp", "sp" or "ep" outside a serve context raises, and so
    does any split without a process group of the mesh's size."""
    cur = _current()
    if cur is None:
        return x
    from repro_torch.dist import comm
    from repro_torch.dist.sharding import split_axes
    rules, serve = cur
    spec = rules.spec(x.shape, logical_axes)
    for part, logical in zip(spec, logical_axes):
        split = split_axes(rules.mesh, (part,))
        if split and logical not in _BATCH_LOGICAL and not serve:
            raise NotImplementedError(
                f"constrain {tuple(logical_axes)} splits {tuple(x.shape)} "
                f"over mesh axes {split} as {logical!r} outside a serve "
                f"context: training under tensor, sequence and expert "
                f"parallelism is not ported yet (ROADMAP A12.2d)")
    if split_axes(rules.mesh, spec):
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
