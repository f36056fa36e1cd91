"""Checkpointing with re-placement on restore (the reference's
`repro.train.checkpoint`, the same files).

Format: <dir>/step_<N>/
  manifest.json   - tree structure, paths, shapes, dtypes, step, extra
  data.msgpack    - msgpack: the leaf count, then each leaf's raw
                    little-endian bytes (bfloat16 as its uint16 bits)

Leaves are taken in JAX's flatten order with JAX's path names
(`repro_torch.tree`), a `Stacked` leaf written as its stacked array, so a
train state built over `LM.param_tree()` writes the reference's leaves:
a checkpoint of either package restores in the other (through
`convert.train_state_from_repro` into the port's tensors).  The few
msgpack forms the file uses (a positive int, bin 8/16/32) are written and
read here by hand.  Writes are atomic (tmp dir + rename); the last three
checkpoints are kept; `AsyncCheckpointer` writes on a background thread.

On a world of ranks a save gathers every placed slice (`dist.sharding`)
to its whole array on every rank, synchronously (a collective), and
rank 0 alone writes the same files; a restore reads them on every rank
and `reshard`s them onto the target placements, so a checkpoint of one
world restores on another, or on one device.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
from typing import Any, BinaryIO, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.dist import comm
from repro_torch.dist.sharding import gather_leaf
from repro_torch.tree import (Stacked, flatten_with_paths, leaves,
                              treedef_str, tree_map, unflatten)

_NP = {torch.float32: np.float32, torch.float64: np.float64,  # noqa: RPT006 - dtype table
       torch.float16: np.float16, torch.int32: np.int32,
       torch.int64: np.int64, torch.int16: np.int16, torch.int8: np.int8,
       torch.uint8: np.uint8, torch.bool: np.bool_}
_TORCH = {np.dtype(v).name: k for k, v in _NP.items()}


class LeafSpec(NamedTuple):
    """Shape, dtype and device of a leaf to restore (a tensor serves as
    its own spec)."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def spec_of(tree):
    """The tree with every tensor replaced by its LeafSpec (ints stay)."""
    def one(x):
        if isinstance(x, Stacked):
            return Stacked(one(t) for t in x)
        if isinstance(x, torch.Tensor):
            return LeafSpec(tuple(x.shape), x.dtype, x.device)
        return x
    return tree_map(one, tree)


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as uint16 bits, a host int
    (the step) as int32, as the reference stores its step.  A placed
    slice is gathered whole first (a collective)."""
    x = gather_leaf(x)
    if isinstance(x, Stacked):
        return np.stack([_host(t) for t in x])
    if isinstance(x, torch.Tensor):
        # a copy even on the CPU: the caller goes on updating in place
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    if isinstance(x, (int, np.integer)):
        return np.asarray(x, np.int32)
    return np.asarray(x)


def _dtype_name(x) -> str:
    """The manifest's dtype of a leaf (a tensor, a LeafSpec, a Stacked of
    them, or a host int)."""
    if isinstance(x, Stacked):
        return _dtype_name(x[0])
    if isinstance(getattr(x, "dtype", None), torch.dtype):
        if x.dtype == torch.bfloat16:
            return "bfloat16"
        return np.dtype(_NP[x.dtype]).name
    return _host(x).dtype.name


# -- msgpack: the forms the file uses -------------------------------------------

def _pack_uint(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    if n < 0x100:
        return b"\xcc" + struct.pack(">B", n)
    if n < 0x10000:
        return b"\xcd" + struct.pack(">H", n)
    if n < 0x100000000:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _bin_header(n: int) -> bytes:
    if n < 0x100:
        return b"\xc4" + struct.pack(">B", n)
    if n < 0x10000:
        return b"\xc5" + struct.pack(">H", n)
    if n < 0x100000000:
        return b"\xc6" + struct.pack(">I", n)
    raise ValueError(f"a leaf of {n} bytes is past msgpack's bin 32")


def _read_uint(f: BinaryIO) -> int:
    tag = f.read(1)[0]
    if tag < 0x80:
        return tag
    size = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}.get(tag)
    if size is None:
        raise ValueError(f"msgpack tag {tag:#x} is not a positive int")
    return struct.unpack(size, f.read(struct.calcsize(size)))[0]


def _read_bin(f: BinaryIO) -> bytes:
    tag = f.read(1)[0]
    size = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}.get(tag)
    if size is None:
        raise ValueError(f"msgpack tag {tag:#x} is not bin 8/16/32")
    n = struct.unpack(size, f.read(struct.calcsize(size)))[0]
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError("truncated checkpoint data")
    return buf


# -- save / restore ----------------------------------------------------------------

def _write(directory: str, step: int, tree: Any, host: List[np.ndarray],
           extra: Optional[dict]) -> str:
    manifest = {
        "step": int(step),
        "treedef": treedef_str(tree),
        "paths": [p for p, _ in flatten_with_paths(tree)],
        "shapes": [list(a.shape) for a in host],
        "dtypes": [_dtype_name(x) for x in leaves(tree)],
        "extra": extra or {},
    }
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "data.msgpack"), "wb") as f:
        f.write(_pack_uint(len(host)))
        for a in host:
            raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
            f.write(_bin_header(raw.size))
            f.write(memoryview(raw))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # prune older checkpoints, keep last 3
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for old in steps[:-3]:
        shutil.rmtree(os.path.join(directory, old))
    return final


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a world, or the
    one process outside any."""
    return not comm.in_world() or torch.distributed.get_rank() == 0


def _leaves_on_host(tree) -> Optional[List[np.ndarray]]:
    """The tree's leaves as host arrays in the writer; elsewhere None
    (every rank still takes part in the gathers)."""
    if _writer():
        return [_host(x) for x in leaves(tree)]
    for x in leaves(tree):
        gather_leaf(x)
    return None


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the checkpoint path.  On a world
    every rank calls it and returns once the files are written."""
    host = _leaves_on_host(tree)
    final = os.path.join(directory, f"step_{step:010d}")
    if host is not None:
        final = _write(directory, step, tree, host, extra)
    comm.barrier()
    return final


class AsyncCheckpointer:
    """Overlap checkpoint IO with compute: save on a background thread,
    never more than one outstanding write."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        # copy to the host now (the step after this one updates the
        # tensors in place; a gather is a collective), write on the thread
        host = _leaves_on_host(tree)
        if host is None:
            return
        shape = spec_of(tree)

        def work():
            _write(self.directory, step, shape, host, extra)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str, like) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(like.device) if like is not None else t


def restore_checkpoint(directory: str, tree_like: Any,
                       shardings: Any = None,
                       step: Optional[int] = None) -> tuple:
    """Restore onto a possibly different placement.

    tree_like: a tree of the same structure whose leaves are tensors or
    `LeafSpec`s (their device is where a leaf lands), Stacked groups of
    them, or ints (a host int comes back).  shardings: an optional
    matching tree of `dist.sharding.Placement`s, applied with
    `dist.sharding.reshard`.  Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "data.msgpack"), "rb") as f:
        n = _read_uint(f)
        raw = [_read_bin(f) for _ in range(n)]

    like_leaves = leaves(tree_like)
    assert len(like_leaves) == n, \
        f"leaf count mismatch {len(like_leaves)} != {n}"
    out = []
    for buf, shape, dtype_name, like in zip(raw, manifest["shapes"],
                                            manifest["dtypes"], like_leaves):
        np_dtype = np.uint16 if dtype_name == "bfloat16" else np.dtype(
            dtype_name)
        arr = np.frombuffer(buf, dtype=np.uint8).view(np_dtype).reshape(
            shape)
        if isinstance(like, Stacked):
            # every member comes back: a placed `like` may hold a share
            out.append(Stacked(_tensor(a, dtype_name, like[0])
                               for a in arr))
        elif isinstance(like, (int, np.integer)) and not isinstance(
                like, bool):
            out.append(int(arr))
        else:
            out.append(_tensor(arr, dtype_name, like))
    tree = unflatten(tree_like, out)
    if shardings is not None:
        from repro_torch.dist.sharding import reshard
        tree = reshard(tree, shardings)
    return tree, manifest["step"]
