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

Placement on a world of ranks.  Every rank is a process holding its own
slice (`dist/__init__.py`).  A placement that splits a dim over mesh
axes of more than one device gives this rank the slice at its
coordinates (`dist.comm.coords`: row-major in the mesh's axis order).
The slice is a tensor of its own that carries its `Placement`
(`placement_of`), as a JAX array carries its sharding; `gather` puts the
whole tensor back together on every rank (a collective).  A `Stacked`
leaf split on its stacking dim gives the rank its members; split on
another dim, every member is sliced.  A split needs an initialized
process group of the mesh's size and raises without one: it never
replicates.  On a mesh whose split axes all have size 1 (one device)
every placement is the device itself and nothing is tagged.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.dist import comm
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


def entry_axes(part) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    return () if part is None else (
        (part,) if isinstance(part, str) else tuple(part))


def split_axes(mesh: Mesh, spec: Sequence[Any]) -> List[str]:
    """The mesh axes of more than one device that `spec` splits over."""
    return [a for part in spec for a in entry_axes(part)
            if mesh.shape[a] > 1]


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


_TAG = "_placement"


def placement_of(x) -> Optional[Placement]:
    """The Placement a rank's slice was cut by; None for a whole tensor
    (or a host int)."""
    return getattr(x, _TAG, None)


def with_placement(x, pl: Optional[Placement]):
    """`x` tagged as the slice `pl` cut (None: untagged); returns `x`."""
    if pl is not None:
        setattr(x, _TAG, pl)
    return x


def split_dims(pl: Placement) -> List[Tuple[int, Tuple[str, ...]]]:
    """(dim, its mesh axes of more than one device) of every split dim."""
    out = []
    for d, part in enumerate(pl.spec):
        axes = tuple(a for a in entry_axes(part) if pl.mesh.shape[a] > 1)
        if axes:
            out.append((d, axes))
    return out


def _own(t: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous copy on `dev` that shares no storage with `t` (so the
    whole tensor a slice came from can be freed)."""
    return t.detach().to(dev).clone(memory_format=torch.contiguous_format)


def _slice(x, pl: Placement):
    """This rank's slice of the whole leaf `x` (a copy), tagged."""
    dev = pl.mesh.local_device
    splits = split_dims(pl)
    if isinstance(x, Stacked):
        members = list(x)
        rest = []
        for d, axes in splits:
            if d == 0:
                i, n = comm.shard_index(pl.mesh, axes)
                k = len(members) // n
                members = members[i * k:(i + 1) * k]
            else:
                rest.append((d - 1, axes))
        out = Stacked(_slice_tensor(m, rest, pl.mesh, dev) for m in members)
    else:
        out = _slice_tensor(x, splits, pl.mesh, dev)
    return with_placement(out, pl)


def _slice_tensor(t, splits, mesh, dev) -> torch.Tensor:
    for d, axes in splits:
        i, n = comm.shard_index(mesh, axes)
        k = t.shape[d] // n
        t = t.narrow(d, i * k, k)
    return _own(t, dev)


def _gather_tensor(t, splits, mesh, out=None) -> torch.Tensor:
    for k, (d, axes) in enumerate(reversed(splits)):
        g, members = comm.group(mesh, axes)
        last = k == len(splits) - 1
        t = comm.all_gather(t, d, g, len(members), out=out if last else None)
    return t


def gather_leaf(x, out=None):
    """The whole leaf of a rank's slice `x` (a collective: every rank of
    the placement's mesh calls it); `x` itself when it is whole.  `out`
    (a tensor, or a Stacked of the whole members) receives it in place.
    A Stacked leaf goes as one stacked array: one collective a leaf."""
    pl = placement_of(x)
    if pl is None:
        return x
    splits = split_dims(pl)
    if not isinstance(x, Stacked):
        return _gather_tensor(x, splits, pl.mesh, out)
    whole = _gather_tensor(torch.stack(list(x)), splits, pl.mesh)
    if out is None:
        return Stacked(whole.unbind(0))
    for o, m in zip(out, whole.unbind(0)):
        o.copy_(m)
    return out


def gather(tree: Any) -> Any:
    """`tree` with every placed slice gathered back to its whole tensor
    (no autograd: checkpoints, tests, binding weights for a step)."""
    return tree_map(gather_leaf, tree)


#: gradient sums over the sequence's ranks ("model", training under the
#: "tp" rules) since the last `reset_model_sums`: calls and bytes
MODEL_SUMS = {"calls": 0, "bytes": 0}


def reset_model_sums() -> None:
    MODEL_SUMS.update(calls=0, bytes=0)


def reduce_grad(g, pl: Optional[Placement], batch_axes: Tuple[str, ...],
                mesh: Optional[Mesh] = None,
                model_axes: Tuple[str, ...] = ()):
    """The gradient `pl`'s slice holds, from this rank's whole gradient
    `g` of its rows' loss terms: the sum over the ranks that split the
    batch along `batch_axes` of `mesh` (none: `g` is the whole batch's),
    cut to this rank's slice.  Where the slice and the batch split over
    the same axes this is one reduce-scatter; otherwise the sum is an
    all-reduce over the batch's axes and the slice is cut here.  A Stacked
    `g` goes as one stacked array.

    `model_axes` (training under the "tp" rules, `act.seq_axes`): `g` is
    the gradient of this rank's share of the work (its positions, heads,
    features, experts), and the slice is then summed over those axes too
    (an all-reduce, counted in `MODEL_SUMS`).  That sum is exact where
    the shares are disjoint parts of the weight (the q/k/v and w1/w3
    columns, the wo/w2 rows, an expert's weights: one rank's entry meets
    zeros) and rounds where every rank adds a partial sum over its own
    positions (the norms, the router, the embedding, the head, and every
    weight of a block that runs whole)."""
    if isinstance(g, Stacked):
        part = reduce_grad(torch.stack(list(g)), pl, batch_axes, mesh,
                           model_axes)
        return with_placement(Stacked(part.unbind(0)), pl)
    splits = split_dims(pl) if pl is not None else []
    if pl is not None:
        mesh = pl.mesh
    if len(splits) == 1 and splits[0][1] == tuple(batch_axes):
        d, axes = splits[0]
        grp, ranks = comm.group(mesh, axes)
        out = with_placement(comm.reduce_scatter(g, d, grp, len(ranks)), pl)
    else:
        if batch_axes:
            comm.all_reduce(g, comm.group(mesh, batch_axes)[0])
        out = _slice(g, pl) if splits else g
    if model_axes:
        comm.all_reduce(out, comm.group(mesh, model_axes)[0])
        MODEL_SUMS["calls"] += 1
        MODEL_SUMS["bytes"] += out.numel() * out.element_size()
    return out


def reshard(tree: Any, shardings: Any) -> Any:
    """Move a state tree onto `shardings` (a matching tree of
    Placements): a whole tensor to this rank's slice of it on the mesh's
    device here (a copy, tagged with its Placement), a slice placed
    otherwise gathered first (a collective) and cut again, a slice
    already so placed left as it is.  A placement that splits nothing
    moves the tensor to the mesh's device, untagged."""
    def one(x, pl: Placement):
        if not isinstance(x, (torch.Tensor, Stacked)):
            return x
        src = placement_of(x)
        if src is not None:
            if src == pl:
                return x
            x = gather_leaf(x)
        if split_dims(pl):
            return _slice(x, pl)
        dev = pl.mesh.local_device
        if isinstance(x, Stacked):
            return Stacked(t.to(dev) for t in x)
        return x.to(dev)
    return tree_map(one, tree, shardings)


def replicated(mesh: Mesh, tree: Any) -> Any:
    """Tree of fully-replicated Placements on `mesh`."""
    return tree_map(lambda x: Placement(mesh, (None,) * len(_shape(x))),
                    tree)
