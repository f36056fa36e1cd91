"""Train step: loss -> grads -> AdamW, with optional microbatch
accumulation (the reference's `repro.train.train_step`).

The train state is {"params": the model's `param_tree()`, "opt":
`adamw_init`'s {"mu", "nu", "step"}}.  Its parameters are the model's own
tensors and the step updates them in place.  A state restored from a
checkpoint holds new tensors: the step first copies them into the model.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

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
    every tensor that is not already the model's own is copied in."""
    for own, new in zip(leaves(model.param_tree()), leaves(params)):
        for o, n in zip(members(own), members(new)):
            if o is not n:
                o.copy_(n)


def _value_and_grad(model: LM, params, batch):
    """(loss, grads in the parameters' dtype) of one batch; a parameter
    the loss does not reach gets zeros, as `jax.value_and_grad` gives."""
    for p in model.parameters():
        p.grad = None
    loss = model.loss(batch)
    loss.backward()

    def grad(p):
        if isinstance(p, Stacked):
            return Stacked(grad(t) for t in p)
        return p.grad if p.grad is not None else torch.zeros_like(p)
    grads = tree_map(grad, params)
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads


def make_train_step(model: LM, opt_cfg: AdamWConfig, *,
                    accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch) -> tuple:
        bind_params(model, state["params"])
        params = model.param_tree()
        if accum_steps == 1:
            loss, grads = _value_and_grad(model, params, batch)
        else:
            # microbatches summed in float32 accumulators, then divided
            def split(x):
                return x.reshape(accum_steps, x.shape[0] // accum_steps,
                                 *x.shape[1:])
            micro = {k: split(v) for k, v in batch.items()}

            def zeros32(p):
                if isinstance(p, Stacked):
                    return Stacked(zeros32(t) for t in p)
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            acc = tree_map(zeros32, params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in micro.items()}
                l, g = _value_and_grad(model, params, mb)
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
