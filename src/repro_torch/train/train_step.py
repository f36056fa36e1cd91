"""Train step: loss -> grads -> AdamW, with optional microbatch
accumulation (the reference's `repro.train.train_step`).

The train state is {"params": the model's `param_tree()`, "opt":
`adamw_init`'s {"mu", "nu", "step"}}.  Its parameters are the model's own
tensors and the step updates them in place.  A state restored from a
checkpoint holds new tensors: the step first copies them into the model.

FSDP.  A state placed on a world of ranks (`dist.sharding.reshard` under
`param_shardings`) holds each rank's slices.  The step gathers them into
the model's own whole parameters (the weights of the forward), runs the
loss and its backward on the rank's rows of the batch, and reduces each
whole gradient to the rank's slice as the sum of the ranks' terms
(`dist.sharding.reduce_grad`: a reduce-scatter); AdamW then updates the
slices.  A batch placed by `batch_shardings` says which ranks split its
rows: the loss's mean and the MoE statistics run over all of them
(`act.batch_split`).  A batch the dp axes do not divide is whole on every
rank, and its gradient is not summed.  With accumulation, microbatch i
is the rows [i B/a, (i+1) B/a) of the whole batch, split again over the
ranks as the reference's `constrain` places it.

Training under the "tp" rules.  Where the active train context splits
the sequence over "model" (`act.seq_axes`), each rank's loss runs its
positions and its share of the heads, features and experts
(`LM.loss`), so its gradient of a whole weight is that share's: each
gradient is summed over "model" as well, after the batch's reduction
(`dist.sharding.reduce_grad`).  The global norm, AdamW and the
microbatches run as under FSDP.
"""

from __future__ import annotations

from typing import Any, Dict

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.dist import act, comm
from repro_torch.dist.sharding import (entry_axes, gather_leaf,
                                       placement_of, reduce_grad)
from repro_torch.models.model import LM
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import leaves, members, tree_map, Stacked

TrainState = Dict[str, Any]  # {"params": ..., "opt": ...}


def make_init_state(model: LM, opt_cfg: AdamWConfig):
    """Returns init_state() -> TrainState: the model's parameters (drawn
    from its seed when it was built) and fresh optimizer state."""
    def init_state() -> TrainState:
        params = model.param_tree()
        return {"params": params, "opt": adamw_init(params)}
    return init_state


@torch.no_grad()
def bind_params(model: LM, params) -> None:
    """Make `params` (a tree of the model's layout) the model's values:
    every tensor that is not already the model's own is copied in, and a
    placed slice is gathered into it (a collective)."""
    for own, new in zip(leaves(model.param_tree()), leaves(params)):
        if placement_of(new) is not None:
            gather_leaf(new, out=own)
            continue
        for o, n in zip(members(own), members(new)):
            if o is not n:
                o.copy_(n)


def _batch_axes(batch) -> Tuple[Optional[object], Tuple[str, ...]]:
    """(mesh, the mesh axes that split the batch's rows) of a batch placed
    by `batch_shardings`; (None, ()) for a whole batch."""
    pl = placement_of(batch["tokens"])
    if pl is None:
        return None, ()
    axes = tuple(a for a in entry_axes(pl.spec[0]) if pl.mesh.shape[a] > 1)
    return pl.mesh, axes


def _value_and_grad(model: LM, params, batch, mesh=None, axes=()):
    """(loss, grads in the parameters' dtype) of one batch; a parameter
    the loss does not reach gets zeros, as `jax.value_and_grad` gives.
    `params` placed: each gradient is its slice's, summed over the ranks
    that split the batch along `axes` of `mesh`, and over those that
    split the sequence ("model", `act.seq_axes`)."""
    for p in model.parameters():
        p.grad = None
    with act.batch_split(mesh, axes) if axes else contextlib.nullcontext():
        loss = model.loss(batch)
        loss.backward()

    def grad(p):
        if isinstance(p, Stacked):
            return Stacked(grad(t) for t in p)
        return p.grad if p.grad is not None else torch.zeros_like(p)

    model_axes = act.seq_axes()
    if model_axes:
        mesh = mesh or act.current_rules().mesh

    def placed(own, p):
        g = grad(own)
        pl = placement_of(p)
        if pl is None and not axes and not model_axes:
            return g
        return reduce_grad(g, pl, axes, mesh, model_axes)
    grads = tree_map(placed, model.param_tree(), params)
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads


def _microbatches(batch, accum_steps: int, mesh, axes):
    """[(microbatch, the axes that split its rows)]: microbatch i holds the
    rows [i B/a, (i+1) B/a) of the whole batch; on a split batch each rank
    takes its share of them (its own where the ranks divide them, else
    all of them), gathering the batch's rows first (a collective)."""
    if not axes:
        def split(x):
            return x.reshape(accum_steps, x.shape[0] // accum_steps,
                             *x.shape[1:])
        micro = {k: split(v) for k, v in batch.items()}
        return [({k: v[i] for k, v in micro.items()}, ())
                for i in range(accum_steps)]
    grp, ranks = comm.group(mesh, axes)
    n = len(ranks)
    whole = {k: comm.all_gather(v, 0, grp, n) for k, v in batch.items()}
    rows = next(iter(whole.values())).shape[0] // accum_steps
    idx, _ = comm.shard_index(mesh, axes)
    out = []
    for i in range(accum_steps):
        if rows % n:
            out.append(({k: v[i * rows:(i + 1) * rows]
                         for k, v in whole.items()}, ()))
        else:
            k_rows = rows // n
            start = i * rows + idx * k_rows
            out.append(({k: v[start:start + k_rows].clone()
                         for k, v in whole.items()}, axes))
    return out


def make_train_step(model: LM, opt_cfg: AdamWConfig, *,
                    accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch) -> tuple:
        bind_params(model, state["params"])
        placed = any(placement_of(p) is not None
                     for p in leaves(state["params"]))
        params = state["params"] if placed else model.param_tree()
        mesh, axes = _batch_axes(batch)
        if accum_steps == 1:
            loss, grads = _value_and_grad(model, params, batch, mesh, axes)
        else:
            # microbatches summed in float32 accumulators, then divided
            def zeros32(p):
                if isinstance(p, Stacked):
                    return Stacked(zeros32(t) for t in p)
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            acc = tree_map(zeros32, params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            for mb, mb_axes in _microbatches(batch, accum_steps, mesh, axes):
                l, g = _value_and_grad(model, params, mb, mesh, mb_axes)
                for la, lg in zip(leaves(acc), leaves(g)):
                    for a, x in zip(members(la), members(lg)):
                        a.add_(x.float())
                loss_sum = loss_sum + l
                del g
            loss = loss_sum / accum_steps
            for la in leaves(acc):
                for a in members(la):
                    a.div_(accum_steps)
            grads = acc
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, grads, state["opt"], params)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
