"""Sharding rules: logical axes -> mesh axes, plus state-tree placements
(the reference's `repro.dist.sharding`).

Two policies over the production ("data", "model") mesh (launch/mesh.py):

  "dp"  - pure FSDP-DP: the batch (and fsdp parameter shards) tile EVERY
          device; no tensor parallelism.
  "tp"  - TP/EP/SP: batch over "data", tensor/expert/sequence parallelism
          over "model".

Rules degrade gracefully: logical axes whose mesh axes are absent from the
mesh or whose sizes do not divide the tensor dim drop to replicated.
`spec` is the reference's logic: its result is a tuple read like a
`PartitionSpec`'s entries (None, an axis name, or a tuple of names).

Placing a tensor split over an axis of more than one device needs the
multi-rank machinery that is not ported yet (ROADMAP A12.2b): `reshard`
raises there rather than replicate.  On a mesh whose split axes all have
size 1 (one device) every placement is the device itself.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import Stacked, tree_map

# logical axis -> ordered mesh-axis candidates, per policy
_POLICIES: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "dp": {
        "dp": ("pod", "data", "model"),
        "fsdp": ("pod", "data", "model"),
        "tp": (),
        "sp": (),
        "ep": (),
    },
    "tp": {
        "dp": ("pod", "data"),
        "fsdp": ("pod", "data"),
        "tp": ("model",),
        "sp": ("model",),
        "ep": ("model",),
    },
}


class Placement(NamedTuple):
    """`NamedSharding`'s counterpart: a mesh and a spec."""
    mesh: Mesh
    spec: Tuple[Any, ...]


def split_axes(mesh: Mesh, spec: Sequence[Any]) -> List[str]:
    """The mesh axes of more than one device that `spec` splits over."""
    out = []
    for part in spec:
        names = () if part is None else (
            (part,) if isinstance(part, str) else tuple(part))
        out.extend(a for a in names if mesh.shape[a] > 1)
    return out


class ShardingRules:
    """Maps logical axis names to mesh axes for one (mesh, policy) pair."""

    def __init__(self, mesh: Mesh, policy: str = "dp"):
        if policy not in _POLICIES:
            raise ValueError(f"unknown sharding policy {policy!r}")
        self.mesh = mesh
        self.policy = policy
        table = _POLICIES[policy]
        self.table: Dict[str, Tuple[str, ...]] = {
            k: tuple(a for a in v if a in mesh.axis_names)
            for k, v in table.items()}

    def mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        return self.table.get(logical, ())

    def axis_size(self, logical: str) -> int:
        n = 1
        for a in self.mesh_axes(logical):
            n *= self.mesh.shape[a]
        return n

    def spec(self, shape: Sequence[int],
             logical_axes: Sequence[Optional[str]]) -> Tuple[Any, ...]:
        """PartitionSpec entries for `shape`, dropping any mesh axis
        already used on an earlier dim or whose size does not divide the
        dim."""
        used: set = set()
        parts: List[Any] = []
        for dim, lax_name in zip(shape, logical_axes):
            chosen: List[str] = []
            n = 1
            for a in self.mesh_axes(lax_name):
                if a in used:
                    continue
                sz = self.mesh.shape[a]
                if dim % (n * sz) == 0:
                    chosen.append(a)
                    n *= sz
            used.update(chosen)
            if not chosen:
                parts.append(None)
            elif len(chosen) == 1:
                parts.append(chosen[0])
            else:
                parts.append(tuple(chosen))
        return tuple(parts)

    def named(self, shape: Sequence[int],
              logical_axes: Sequence[Optional[str]]) -> Placement:
        return Placement(self.mesh, self.spec(shape, logical_axes))


def _shape(x) -> tuple:
    """A leaf's shape as the reference sees it (a Stacked is its stacked
    array; a host int a scalar)."""
    if isinstance(x, Stacked):
        return (len(x),) + tuple(x[0].shape)
    return tuple(getattr(x, "shape", ()))


def _leaf_sharding(rules: ShardingRules, shape: Sequence[int],
                   logical: str, prefer_last: bool) -> Placement:
    """Shard the largest divisible dim of `shape` over `logical`; ties go to
    the last dim for serve/TP (output features resident per device) and to
    the first for train/FSDP."""
    if not shape or rules.axis_size(logical) <= 1:
        return rules.named(shape, [None] * len(shape))
    group = rules.axis_size(logical)
    order = range(len(shape) - 1, -1, -1) if prefer_last else range(len(shape))
    best = None
    for i in order:
        if shape[i] % group == 0 and (best is None or shape[i] > shape[best]):
            best = i
    axes: List[Optional[str]] = [None] * len(shape)
    if best is not None:
        axes[best] = logical
    return rules.named(shape, axes)


def param_shardings(rules: ShardingRules, params: Any, *,
                    serve: bool = False) -> Any:
    """Tree of Placements for a parameter tree.

    Train: FSDP, each tensor sharded on its largest fsdp-divisible dim.
    Serve: weights stay resident, sharded over the tp axis (prefer the
    output feature dim) so matmul shards line up with activation TP."""
    logical = "tp" if serve else "fsdp"
    return tree_map(
        lambda p: _leaf_sharding(rules, _shape(p), logical, prefer_last=serve),
        params)


def batch_shardings(rules: ShardingRules, batch: Any) -> Any:
    """Batch trees shard dim 0 over dp, everything else replicated."""
    def one(b):
        shape = _shape(b)
        return rules.named(shape, (["dp"] + [None] * (len(shape) - 1))
                           if shape else [])
    return tree_map(one, batch)


def cache_shardings(rules: ShardingRules, cache: Any) -> Any:
    """KV/recurrent caches shard their batch dim: the first dp-divisible
    of the leading two dims (the reference's stacked caches carry a
    layer-cycle axis first)."""
    def one(c):
        shape = _shape(c)
        if not shape:
            return rules.named((), [])
        axes: List[Optional[str]] = [None] * len(shape)
        group = rules.axis_size("dp")
        for i in range(min(2, len(shape))):
            if group > 1 and shape[i] % group == 0:
                axes[i] = "dp"
                break
        return rules.named(shape, axes)
    return tree_map(one, cache)


def reshard(tree: Any, shardings: Any) -> Any:
    """Move a state tree onto `shardings` (a matching tree of
    Placements): each tensor to its mesh's device here.  A placement that
    splits a dimension over a mesh axis of more than one device raises:
    the multi-rank placement is ROADMAP A12.2b, and replicating instead
    would hide it."""
    def one(x, pl: Placement):
        split = split_axes(pl.mesh, pl.spec)
        if split:
            raise NotImplementedError(
                f"placement {pl.spec} splits over mesh axes {split} of "
                f"{dict(pl.mesh.shape)}: sharded placement is not ported "
                f"yet (ROADMAP A12.2b)")
        dev = pl.mesh.local_device
        if isinstance(x, Stacked):
            return Stacked(t.to(dev) for t in x)
        return x.to(dev) if isinstance(x, torch.Tensor) else x
    return tree_map(one, tree, shardings)


def replicated(mesh: Mesh, tree: Any) -> Any:
    """Tree of fully-replicated Placements on `mesh`."""
    return tree_map(lambda x: Placement(mesh, (None,) * len(_shape(x))),
                    tree)
