"""Start a world of ranks on this host: `run_world`.

    result = run_world(fn, world_size, device="cpu", store_dir=tmp)

starts `world_size` processes with `torch.multiprocessing`'s spawn start
method, joins them into one default process group through a
``file://`` store under `store_dir` (no TCP port, so concurrent test
workers never race for one), calls ``fn(rank, *args)`` in each and
returns rank 0's result, which must pickle.  A rank that raises or exits
non-zero stops the others and raises here: nothing falls back to fewer
ranks.  This is the port's counterpart of the reference tests'
``XLA_FLAGS=--xla_force_host_platform_device_count=N``.

Backend: gloo on the CPU and where ranks share a card (it takes CUDA
tensors and stages them through the host); NCCL when every rank has a
card of its own.  Asking for NCCL with more ranks than cards raises.
The choice is logged to the ``repro_torch.dist`` logger.
"""

from __future__ import annotations

import datetime
import glob
import logging
import os
import pickle
import tempfile
import traceback
from typing import Any, Callable, Optional

import torch

LOG = logging.getLogger("repro_torch.dist")

#: seconds a collective may wait for a peer before the rank fails (a
#: world whose ranks build full-size views in turn waits minutes)
TIMEOUT_S = 900.0


def choose_backend(device_type: str, world_size: int,
                   backend: Optional[str] = None) -> str:
    """The process-group backend for `world_size` ranks on `device_type`
    ("cpu" or "cuda"): gloo on the CPU or when ranks must share a card,
    NCCL when each rank has its own.  An explicit `backend` is checked,
    never replaced."""
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if backend is None:
        backend = ("nccl" if device_type == "cuda" and cards >= world_size
                   else "gloo")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl': {backend!r}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("NCCL needs device='cuda'")
        if world_size > cards:
            raise ValueError(
                f"NCCL needs one card per rank: {world_size} ranks, "
                f"{cards} card(s); use backend='gloo' to share cards")
    return backend


def _entry(rank: int, fn: Callable, world_size: int, device_type: str,
           backend: str, store: str, work: str, threads: int,
           args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    if device_type == "cuda":     # ranks share the cards round-robin
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.distributed.init_process_group(
        backend, init_method=f"file://{store}", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        # every rank is connected before any runs `fn`: a rank that fails
        # at once must not close its sockets under a peer still joining
        torch.distributed.barrier()
        out = fn(rank, *args)
        if rank == 0:
            with open(os.path.join(work, "rank0.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        # every failing rank leaves its traceback: the first one to exit
        # may only report the connection its peer closed
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        torch.distributed.destroy_process_group()


def run_world(fn: Callable[..., Any], world_size: int, *,
              device: Optional[str] = None, store_dir: str,
              backend: Optional[str] = None, args: tuple = (),
              threads: int = 1) -> Any:
    """Run ``fn(rank, *args)`` on `world_size` spawned ranks and return
    rank 0's result.

    `device` None means CUDA and raises without a card (pass "cpu").
    `fn` must be importable by the spawned processes (a module-level
    function).  `threads` sets each rank's intra-op threads (0 leaves
    torch's default).  Raises if any rank raises or exits non-zero."""
    device_type = "cuda" if device is None else torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "ranks on the CPU")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1: {world_size}")
    backend = choose_backend(device_type, world_size, backend)
    LOG.info("run_world: %d rank(s) on %s over %s", world_size,
             device_type, backend)
    os.makedirs(store_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="world-", dir=store_dir)
    store = os.path.join(work, "store")
    try:
        torch.multiprocessing.start_processes(
            _entry, args=(fn, world_size, device_type, backend, store, work,
                          threads, tuple(args)),
            nprocs=world_size, join=True, start_method="spawn")
    except Exception as e:
        errs = "".join(
            f"\n--- {os.path.basename(p)[:-4]} ---\n" + open(p).read()
            for p in sorted(glob.glob(os.path.join(work, "rank*.err"))))
        raise RuntimeError(f"a rank of the world failed: {e}{errs}") from e
    with open(os.path.join(work, "rank0.pkl"), "rb") as f:
        return pickle.load(f)
