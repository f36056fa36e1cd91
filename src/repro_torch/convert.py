"""Carry a reference run's graph, job state, weights and caches into the port.

What a graph run carries is its graph and the mid-run job state, and on
an evolving graph the view's live-update overlay and its host mirrors.
These functions take the reference's fields as numpy arrays (from
`repro.graph.CSRGraph`, `BlockedGraph`, `BlockPairs`, `TileOverlay` and a
`repro.core.GraphSession` view group) and build the port's objects on a
device, so a run begun in the reference can continue in the port,
mid-stream included.  The language models' parameters and caches come
over the same way (`lm_params_from_repro`, `lm_cache_from_repro`), and a
training run's state and gradients (`train_state_from_repro`, onto a
world's placements too, `grads_from_repro`), and a placed state gathered
back to numpy (`train_state_to_numpy`).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.session import GraphSession, ViewGroup
from repro_torch.graph.structure import (BlockedGraph, BlockPairs, CSRGraph,
                                         TileOverlay, chunk_table, run_starts)
from repro_torch.kernels.common import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.stream.apply import _ensure_mirrors


def _tensor(a, dtype, device) -> torch.Tensor:
    """A device tensor holding a copy of `a` (the reference's arrays are
    read-only, and the port updates some of them in place)."""
    return torch.from_numpy(np.array(a, dtype)).to(device)


def csr_from_arrays(n: int, indptr, indices, weights) -> CSRGraph:
    """A CSRGraph from the reference's (n, indptr, indices, weights)."""
    return CSRGraph(n=int(n), indptr=np.array(indptr, dtype=np.int64),
                    indices=np.array(indices, dtype=np.int32),
                    weights=np.array(weights, dtype=np.float32))


def blocked_from_arrays(n_real: int, block_size: int, num_blocks: int,
                        max_nbr_blocks: int, fill: float, nbr_ids, nbr_mask,
                        tiles, vertex_mask, *, device=None) -> BlockedGraph:
    """A BlockedGraph from the reference's fields (numpy arrays)."""
    dev = resolve_device(device)
    return BlockedGraph(
        n_real=int(n_real), block_size=int(block_size),
        num_blocks=int(num_blocks), max_nbr_blocks=int(max_nbr_blocks),
        fill=float(fill), nbr_ids=_tensor(nbr_ids, np.int32, dev),
        nbr_mask=_tensor(nbr_mask, bool, dev),
        ell=_tensor(tiles, np.float32, dev),
        vertex_mask=_tensor(vertex_mask, bool, dev))


def pairs_from_arrays(num_pairs: int, block_size: int, num_blocks: int,
                      src, dst, slot, first, last, src_nnz, dst_touched,
                      tiles, dense_op=None, *, device=None) -> BlockPairs:
    """A BlockPairs from the reference's fields (numpy arrays); the port's
    extra `run_start` is derived from `first`, and its chunk table from
    `run_start`."""
    dev = resolve_device(device)

    def t(a, dtype=np.int32):
        return _tensor(a, dtype, dev)

    rs = run_starts(first)
    chunk_start, chunk_run = chunk_table(rs)
    return BlockPairs(
        num_pairs=int(num_pairs), block_size=int(block_size),
        num_blocks=int(num_blocks), src=t(src), dst=t(dst), slot=t(slot),
        first=t(first), last=t(last), src_nnz=t(src_nnz),
        dst_touched=t(dst_touched, bool), tiles=t(tiles, np.float32),
        run_start=t(rs),
        dense_op=None if dense_op is None else t(dense_op, np.float32),
        chunk_start=t(chunk_start), chunk_run=t(chunk_run))


def load_group_state(sess: GraphSession, view_key: tuple, values, deltas,
                     push_scale, active,
                     rng_state: Optional[dict] = None) -> ViewGroup:
    """Install a reference session's mid-run job state into `sess`.

    values/deltas [J, B_N, Vb] and push_scale [J] are the reference view
    group's arrays, `active` its [J] slot mask.  The port's group for
    `view_key` must already exist (submit the same jobs first) and is
    grown to J slots; every slot marked active must hold a submitted job.
    `rng_state` (a `np.random.Generator.bit_generator.state`) continues
    the reference scheduler's stream."""
    grp = sess.groups.get(tuple(view_key))
    if grp is None:
        raise KeyError(f"no view group {view_key!r}: submit its jobs first")
    j = np.shape(values)[0]
    while grp.capacity < j:
        sess._grow(grp)
    if grp.capacity != j:
        raise ValueError(f"state holds {j} slots, the group {grp.capacity}")
    active = np.asarray(active, bool)
    missing = [s for s in np.flatnonzero(active) if grp.algs[s] is None]
    if missing:
        raise ValueError(f"active slots {missing} hold no submitted job")
    dev = sess.device
    grp.values = _tensor(values, np.float32, dev)
    grp.deltas = _tensor(deltas, np.float32, dev)
    grp.push_scale = _tensor(push_scale, np.float32, dev)
    grp.active = active.copy()
    if rng_state is not None:
        sess.scheduler.rng.bit_generator.state = rng_state
    return grp


def load_overlay(sess: GraphSession, view_key: tuple, capacity: int, src_u,
                 dst, w, mask, ov_used=None,
                 ov_entry: Optional[Dict[Tuple[int, int],
                                         Tuple[int, int]]] = None, *,
                 graph: Optional[BlockedGraph] = None) -> ViewGroup:
    """Install a reference view group's live-update state into `sess`.

    src_u/dst/w/mask [B_N, capacity] are the reference's `TileOverlay`
    arrays; `ov_used` [B_N, capacity] bool and `ov_entry` {(u, v):
    (block, col)} its group's host mirrors (None where the reference has
    not built them yet).  `graph` (from `blocked_from_arrays`) replaces
    the group's BlockedGraph when the reference's tiles were edited by
    earlier batches.  The group's (src block, dst block) -> slot mirror
    is rebuilt from its graph; with `graph` its pair view is dropped, so
    the next run rebuilds it from the new tiles.  The group for
    `view_key` must already exist."""
    grp = sess.groups.get(tuple(view_key))
    if grp is None:
        raise KeyError(f"no view group {view_key!r}: submit its jobs first")
    if graph is not None:
        # the pair view is rebuilt from the new graph's tiles
        grp.graph = graph
        grp.pairs = None
    bn = grp.graph.num_blocks
    capacity = int(capacity)
    dev = sess.device
    arrays = [np.asarray(a) for a in (src_u, dst, w, mask)]
    for a in arrays:
        if a.shape != (bn, capacity):
            raise ValueError(f"overlay array {a.shape} != {(bn, capacity)}")
    grp.overlay = TileOverlay(
        capacity=capacity,
        src_u=_tensor(arrays[0], np.int32, dev),
        dst=_tensor(arrays[1], np.int32, dev),
        w=_tensor(arrays[2], np.float32, dev),
        mask=_tensor(arrays[3], np.float32, dev))
    grp.pair_slot = grp.ov_used = grp.ov_entry = None
    if ov_used is not None:
        _ensure_mirrors(grp)
        used = np.array(ov_used, dtype=bool)
        if used.shape != (bn, capacity):
            raise ValueError(f"ov_used {used.shape} != {(bn, capacity)}")
        grp.ov_used = used
        grp.ov_entry = {(int(u), int(v)): (int(b), int(c))
                        for (u, v), (b, c) in (ov_entry or {}).items()}
    return grp


def snapshot_from_repro(snapshot: dict) -> dict:
    """The port's `dist.fault.checkpoint_session` snapshot from the
    reference's (`repro.dist.fault.checkpoint_session`, its arrays read
    to numpy): view keys as tuples, values/deltas as float32 numpy, the
    stream position as an int.  The reference keeps no host generator
    state in its snapshot, so a restore continues the stream position
    only.  `dist.fault.restore_session` then loads it into a port
    session, on a mesh or on one device."""
    return {"keys": [tuple(k) for k in snapshot["keys"]],
            "values": [np.array(v, dtype=np.float32)
                       for v in snapshot["values"]],
            "deltas": [np.array(d, dtype=np.float32)
                       for d in snapshot["deltas"]],
            "step": int(snapshot["step"]), "rng": None}


# -- language models -----------------------------------------------------------

def _lm_tensor(a, device) -> torch.Tensor:
    """A tensor on `device` holding a copy of the numpy array `a`; a
    bfloat16 array (numpy's extension type) keeps its bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _stack_layers(cfg: ModelConfig, tree: Dict[str, Any]
                  ) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """(layer, its entry) over the reference's stacked `blocks` (pattern
    position i of cycle c is layer c * len(pattern) + i) and its `rem`."""
    period = len(cfg.block_pattern)
    for i, stacked in enumerate(tree["blocks"]):
        for c in range(cfg.pattern_cycles):
            yield c * period + i, _index(stacked, c)
    for i, entry in enumerate(tree["rem"]):
        yield cfg.pattern_cycles * period + i, entry


def _index(tree, c):
    if isinstance(tree, dict):
        return {k: _index(v, c) for k, v in tree.items()}
    return np.asarray(tree)[c]


def _flat(prefix: str, tree: Dict[str, Any]) -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(f"{prefix}{k}.", v)
        else:
            yield prefix + k, v


def lm_params_from_repro(cfg: ModelConfig, params: Dict[str, Any], *,
                         device=None, shardings=None
                         ) -> Dict[str, torch.Tensor]:
    """The port's `LM` state dict from the reference's `LM(cfg).init`
    pytree (leaves as numpy arrays): the [n_cycles, ...] stacks of
    `params["blocks"]` unstacked into one entry a layer.  Load it with
    `LM(cfg, device="meta").load_state_dict(state, assign=True)`.

    `shardings` (`param_shardings(rules, LM(cfg, device="meta")
    .param_tree(), serve=True)`) gives this rank its slices of the
    weights instead, each placed as `LM(cfg, shardings=...)` places it;
    load them with `LM(cfg, device="meta").assign_params(state)`."""
    dev = resolve_device(device)
    state = {name: _lm_tensor(params[name], dev)
             for name in ("embed", "final_norm", "head") if name in params}
    for layer, entry in _stack_layers(cfg, params):
        for name, a in _flat(f"blocks.{layer}.", entry):
            state[name] = _lm_tensor(a, dev)
    if shardings is not None:
        from repro_torch.dist.sharding import reshard
        from repro_torch.models.model import member_placements
        for name, pl in member_placements(cfg, shardings).items():
            state[name] = reshard(state[name], pl)
    return state


def lm_cache_from_repro(cfg: ModelConfig, cache: Dict[str, Any], *,
                        device=None) -> Dict[str, Any]:
    """The port's cache (`LM.init_cache`'s layout) from the reference's
    (leaves as numpy arrays), so a decode begun in the reference can go
    on in the port."""
    dev = resolve_device(device)
    layers = [None] * cfg.n_layers
    for layer, entry in _stack_layers(cfg, cache):
        layers[layer] = {k: _lm_tensor(v, dev) for k, v in entry.items()}
    return {"pos": int(np.asarray(cache["pos"])), "layers": layers}


def grads_from_repro(cfg: ModelConfig, grads: Dict[str, Any], *,
                     device=None) -> Dict[str, torch.Tensor]:
    """The reference's gradient tree (`jax.grad` of `LM.loss`, leaves as
    numpy arrays) under the port's parameter names, as the model's
    `.grad`s hold them (the mapping of `lm_params_from_repro`)."""
    return lm_params_from_repro(cfg, grads, device=device)


def _param_tree_from_repro(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A reference parameter-shaped tree (numpy leaves) in the layout of
    `LM.param_tree()`: each leaf of `blocks` unstacked over the cycles
    into a `Stacked`, every other leaf a tensor."""
    from repro_torch.tree import Stacked, tree_map

    def one(a):
        return _lm_tensor(a, device)

    out = {k: tree_map(one, v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = tree_map(
        lambda a: Stacked(_lm_tensor(s, device) for s in np.asarray(a)),
        tree["blocks"])
    return out


def train_state_from_repro(cfg: ModelConfig, state: Dict[str, Any], *,
                           device=None, shardings=None) -> Dict[str, Any]:
    """The port's train state from the reference's `{"params", "opt":
    {"mu", "nu", "step"}}` (leaves as numpy arrays): parameters and
    moments in `LM.param_tree()`'s layout, the step a host int.
    `train_step.bind_params` (the step does it itself) makes the
    parameters a model's.  `shardings` (a matching tree of Placements)
    places it: on a world of ranks each rank keeps its slices."""
    dev = resolve_device(device)
    opt = state["opt"]
    out = {"params": _param_tree_from_repro(state["params"], dev),
           "opt": {"mu": _param_tree_from_repro(opt["mu"], dev),
                   "nu": _param_tree_from_repro(opt["nu"], dev),
                   "step": int(np.asarray(opt["step"]))}}
    if shardings is not None:
        from repro_torch.dist.sharding import reshard
        out = reshard(out, shardings)
    return out


def train_state_to_numpy(tree: Any) -> Any:
    """A port tree (a train state, grads) as numpy arrays in the
    reference's layout: placed slices gathered whole first (a collective:
    every rank calls it), a `Stacked` leaf stacked, bfloat16 as its
    uint16 bits; host ints stay."""
    from repro_torch.train.checkpoint import _host
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x if isinstance(x, int) else _host(x), tree)
