"""Runtime sentinels: the dynamic half of the analysis layer (the
reference's `repro.analysis.sentinels`, retargeted to torch).

Two guards, both context managers, so tests and the contracts can wrap
existing scenarios without restructuring them:

- :func:`no_implicit_syncs` — no host read inside a block.  On the card
  it is `torch.cuda.set_sync_debug_mode("error")` (any operation that
  synchronizes with the device raises).  On the CPU, where nothing
  synchronizes, it lists every host read of a tensor in the block and
  raises `HostSyncError` at its end if there was one.  The list comes
  from a `TorchFunctionMode`: `.item()`, `.tolist()`, `.cpu()`,
  `.numpy()`, `bool/int/float(t)` and the data-shaped ops all reach it on
  the CPU, where a `TorchDispatchMode` sees only the scalar reads
  (`aten._local_scalar_dense`: `.tolist()`, `.cpu()` and `.numpy()` of a
  CPU tensor dispatch nothing).  The device drivers read once per chunk,
  outside
  the chunk function, so a read inside a chunk is exactly the hazard
  RPT001 checks statically.

- :func:`retrace_sentinel` — pins a `GraphSession`'s step cache
  (`_jit_cache`): on exit it fails if a key appeared that the block was
  not expected to add (an ephemeral component reached the key, RPT005,
  and every such key builds the step again).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, List

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.kernels.common import resolve_device

#: tensor functions that read the device from the host (or size their
#: output by the data, which reads it)
HOST_READS = frozenset({
    "item", "tolist", "cpu", "numpy", "__array__", "__bool__", "__int__",
    "__float__", "__index__", "__complex__", "__contains__", "nonzero",
    "masked_select", "unique", "unique_consecutive", "argwhere",
})


class HostSyncError(AssertionError):
    """A tensor was read on the host inside a `no_implicit_syncs` block."""


class RetraceError(AssertionError):
    """A pinned step cache grew: some call built a step again."""


@dataclasses.dataclass
class SyncLog:
    """The host reads a `no_implicit_syncs` block saw (CPU only)."""
    reads: List[str] = dataclasses.field(default_factory=list)


class _HostReads(TorchFunctionMode):
    def __init__(self, log: SyncLog):
        super().__init__()
        self.log = log

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_READS:
            self.log.reads.append(name)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_implicit_syncs(device=None):
    """Within: no host read of a tensor on `device` (None: CUDA, raising
    without a card).  On a CUDA device any synchronizing operation
    raises at once (RuntimeError from torch); on the CPU the block's reads
    are listed in the yielded `SyncLog` and `HostSyncError` is raised at
    its end if it made one."""
    dev = resolve_device(device)
    log = SyncLog()
    if dev.type == "cuda":
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield log
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        return
    with _HostReads(log):
        yield log
    if log.reads:
        raise HostSyncError(
            f"{len(log.reads)} host read(s) inside the block "
            f"(first: {log.reads[:4]}): each is a device sync on a card")


@contextlib.contextmanager
def retrace_sentinel(sess, allow_new: Iterable[str] = ()):
    """Fail on exit if `sess`'s step cache gained a key.

    ``allow_new`` whitelists key *kinds* (the key tuple's first element,
    e.g. ``"superstep"``) that the block is expected to build for the
    first time."""
    before = frozenset(sess._jit_cache)
    allowed = frozenset(allow_new)
    yield
    bad = [k for k in sess._jit_cache if k not in before
           and not (isinstance(k, tuple) and k and k[0] in allowed)]
    if bad:
        raise RetraceError(
            f"step cache gained {len(bad)} unexpected key(s): {bad[:3]!r} "
            f"— an ephemeral component reached the cache key (every such "
            f"key builds the step again)")
