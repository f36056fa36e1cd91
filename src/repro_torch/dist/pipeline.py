"""Microbatched pipeline parallelism (GPipe schedule) over a mesh axis
(the reference's `repro.dist.pipeline`).

Each rank on the pipeline axis owns one stage's parameters (a leading
stage axis of the params tree, placed P(axis_name)).  The batch is split
into n_micro microbatches; each tick every rank runs its stage on its
current activation and sends the result to the next stage (the rotating
systolic schedule of the reference's ppermute ring).  After n_micro + S
- 1 ticks the last stage has produced every microbatch's output; the
outputs go to every rank and the loss runs on the reassembled batch
there, so the pipelined loss (and, through autograd, its gradients)
matches the sequential stages.

Every rank is a process (`dist/__init__.py`): the exchange is an
autograd function whose forward sends to the next stage and receives
from the previous one, and whose backward sends the gradient back the
other way.  Every rank runs every tick's exchange in both directions in
the same order: stage 0 keeps what it receives in its graph with a zero
gradient (the reference's `where`), so no rank skips a backward
exchange its neighbours wait on.  The outputs reach every rank as the
reference's psum of masked outputs (`comm.psum`, a broadcast from the
last stage) whose backward keeps each rank's own cotangent: every rank
computes the same loss, so summing the ranks' cotangents would count it
S times.

Stages must be shape-homogeneous (activation in == activation out), which
is exactly the transformer-block case.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.dist import comm
from repro_torch.dist.sharding import placement_of
from repro_torch.tree import tree_map


class _Exchange(torch.autograd.Function):
    """Send to rank `to`, receive from rank `frm`; backward the reverse."""

    @staticmethod
    def forward(ctx, out, to, frm):
        ctx.to, ctx.frm = to, frm
        return comm.send_recv(out.detach(), to, frm)

    @staticmethod
    def backward(ctx, grad):
        return comm.send_recv(grad.contiguous(), ctx.frm, ctx.to), None, None


def _stage(a, idx: int):
    """This rank's stage of a leaf: the one stage of a placed slice, row
    `idx` of a whole leaf."""
    if placement_of(a) is not None:
        return a[0]
    return a[idx]


def make_pipelined_loss(mesh, stage_fn: Callable, loss_fn: Callable,
                        axis_name: str = "pod", n_micro: int = 1):
    """Build pipelined(params, x, y) -> scalar loss.

    params: tree whose leaves carry a leading stage axis of size S =
    mesh.shape[axis_name] (whole on every rank, or placed P(axis_name) so
    that a rank holds its own stage).  stage_fn(stage_params, h) -> h'
    applies ONE stage (no stage axis).  loss_fn(out, y) -> scalar on the
    full batch; x and y are whole on every rank.  Every rank of the
    mesh's process group calls it (S > 1 needs one)."""
    n_stages = mesh.shape[axis_name]

    def neighbours():
        c = comm.coords(mesh, f"a pipeline over {axis_name!r}")
        idx = c[axis_name]

        def rank_at(i):
            c2 = dict(c, **{axis_name: i % n_stages})
            return int(np.ravel_multi_index(
                [c2[a] for a in mesh.axis_names], tuple(mesh.sizes)))
        return idx, rank_at(idx + 1), rank_at(idx - 1), rank_at(-1)

    def pipelined(params, x, y):
        batch = x.shape[0]
        if batch % n_micro:
            raise ValueError(f"batch {batch} not divisible by "
                             f"n_micro={n_micro}")
        mb = batch // n_micro
        xs = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
        if n_stages == 1:
            idx, nxt, prv, last = 0, None, None, None
        else:
            idx, nxt, prv, last = neighbours()
        p = tree_map(lambda a: _stage(a, idx), params)
        first = torch.tensor(idx == 0, device=x.device)
        n_ticks = n_micro + n_stages - 1
        state = torch.zeros_like(xs[0])
        outs = [None] * n_micro
        for t in range(n_ticks):
            # stage 0 injects microbatch t (clipped duplicates past the end
            # never reach a valid output slot before the loop ends)
            inp = torch.where(first, xs[min(t, n_micro - 1)], state)
            out = stage_fn(p, inp)
            if tuple(out.shape) != tuple(xs.shape[1:]):
                raise ValueError("pipeline stages must be shape-homogeneous: "
                                 f"{tuple(xs.shape[1:])} -> "
                                 f"{tuple(out.shape)}")
            w = t - (n_stages - 1)       # microbatch leaving the last stage
            if w >= 0:
                outs[w] = out
            if n_stages == 1:
                state = out
            elif t < n_ticks - 1:        # the last tick's would go unread
                state = _Exchange.apply(out, nxt, prv)
        full = torch.stack(outs)
        if n_stages > 1:
            # only the last stage holds real outputs; every rank gets them
            # so the (replicated) loss is computed identically everywhere.
            # The masked copy keeps each rank's last tick in its graph with
            # a zero gradient, so every rank's backward reaches every one of
            # its exchanges
            held = torch.where(torch.tensor(idx == n_stages - 1,
                                            device=x.device),
                               full, torch.zeros_like(full))
            full = comm.psum(held, src=last)
        full = full.reshape((batch,) + tuple(full.shape[2:]))
        return loss_fn(full, y)

    return pipelined


__all__ = ["make_pipelined_loss"]
