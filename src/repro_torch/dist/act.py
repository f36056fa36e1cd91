"""Activation sharding via *logical* axis names (the model code's hooks).

Model code annotates intermediate tensors with logical axes ("dp", "sp",
"tp", "fsdp") through `constrain`, as the reference's does.  Outside an
`activation_sharding(rules)` context every annotation is the identity,
`axis_size` is 1 and `is_serve` is False: the unsharded path on one
device.  The rules that would resolve the names to a mesh
(`repro.dist.sharding`) are not ported yet, so inside a context each of
the three raises instead of running unsharded on a mesh without saying so.

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


def _unported(what: str):
    raise NotImplementedError(
        f"{what} inside activation_sharding: the sharding rules "
        f"(dist/sharding.py) are not ported yet")


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
    """`x` itself outside any activation_sharding context."""
    if _current() is None:
        return x
    _unported("constrain")


def axis_size(logical_axis: str) -> int:
    """Device count behind a logical axis: 1 outside any context."""
    if _current() is None:
        return 1
    _unported("axis_size")


def is_serve() -> bool:
    """False outside any context (True would mark a serve cell)."""
    if _current() is None:
        return False
    _unported("is_serve")
