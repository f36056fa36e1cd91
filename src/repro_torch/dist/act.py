"""Activation sharding via *logical* axis names (the model code's hooks).

Model code annotates intermediate tensors with logical axes ("dp", "sp",
"tp", "fsdp") through `constrain`, as the reference's does.  Outside an
`activation_sharding(rules)` context every annotation is the identity,
`axis_size` is 1 and `is_serve` is False: the unsharded path on one
device.  Inside one, `axis_size` and `is_serve` answer from the rules
(`dist/sharding.py`), and `constrain` returns `x` where its spec splits
over no mesh axis of more than one device; a split over a larger axis
needs the multi-rank placement (ROADMAP A12.2b) and raises.

The context is thread-local and re-entrant, as in the reference.
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


def constrain(x, *logical_axes):
    """`x` itself: outside any context, or where the rules split it over
    no mesh axis of more than one device (raises otherwise)."""
    cur = _current()
    if cur is None:
        return x
    from repro_torch.dist.sharding import split_axes
    rules = cur[0]
    spec = rules.spec(x.shape, logical_axes)
    split = split_axes(rules.mesh, spec)
    if split:
        raise NotImplementedError(
            f"constrain {tuple(logical_axes)} splits {tuple(x.shape)} over "
            f"mesh axes {split}: sharded activations are not ported yet "
            f"(ROADMAP A12.2b)")
    return x


def axis_size(logical_axis: str) -> int:
    """Device count behind a logical axis: 1 outside any context."""
    cur = _current()
    return 1 if cur is None else cur[0].axis_size(logical_axis)


def is_serve() -> bool:
    """False outside any context, else the context's flag."""
    cur = _current()
    return False if cur is None else cur[1]
