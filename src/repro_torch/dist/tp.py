"""Tensor-parallel products: the "tp" policy's serving and training
paths on ranks.

Within `activation_sharding(rules, serve=True)` whose "tp" logical axis
spans n > 1 devices (the "model" mesh axis), each rank holds the slices
of the weights that `param_shardings(rules, params, serve=True)` places
(`models.model.LM(..., shardings=...)`) and multiplies only its share.
An activation's last dim is either whole or this rank's chunk: the i-th
of n equal contiguous pieces, i the rank's index along "model".  The
collective of each product follows from where its weight is split
(`matmul`):

  output dim   the local product is this rank's chunk of the output
               features (its input must be whole: a chunk is gathered);
  input dim    this rank's chunk of the input times its rows is a partial
               product; the partials are summed over "model" in float32
               (the reference's `acc_t`, float32 in every config) and
               rounded once to the activation dtype, as the one-device
               product rounds its float32 sum;
  vocabulary   (the embedding, `lookup`) the rank looks up its id range,
               zeroes the other rows, and the rows are summed (exactly);
  elsewhere    (a stacking dim) the weight is gathered at use.

A whole weight multiplies a whole input; where the caller wants the
output's chunk it is cut here, without a collective.  Vectors (norms,
biases, the RG-LRU's gates) stay whole on every rank from placement on
(`models.model.member_placements`) and are cut with `chunk` where the
compute is split.  `gathered` gathers a block's split weights at use
(the xLSTM blocks, which the reference marks nothing in).  Every weight
gathered at use is counted in `GATHERED`; every collective in
`comm.STATS`.

Training under the "tp" rules.  Within a train context's
`act.seq_split` (the loss enters it) the "model" axis answers too, and
the layout differs: every weight is whole on the rank (the train
placements split only over the batch axes, and the step binds them
whole), and the residual stream is the rank's positions of the
sequence.  A block gathers the normed stream over "model"
(`seq_gather`, an all-gather whose backward is the reduce-scatter of
the cotangent), multiplies the whole sequence by the rank's chunk of
the weight's columns (`matmul(..., local=True)`: cut from the whole
weight, no collective), and brings a product by the chunk's rows back
to the rank's positions as the float32 sum of every rank's partial
product, rounded once (`matmul(..., x_local=True)`: a reduce-scatter of
the sequence, whose backward is the all-gather).  So each rank computes
its share of the heads, features or channels, and its gradient of a
whole weight is that share's; the train step sums them over "model"
(`dist.sharding.reduce_grad`).  A block that splits nothing over
"model" runs whole on the gathered sequence and keeps the rank's
positions (`seq_whole`).  Outside both contexts (one device) every
function is the plain one-device operation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.dist import act, comm
from repro_torch.dist.sharding import (Placement, gather_leaf, placement_of,
                                       split_dims, with_placement)

#: weights gathered whole at use since the last `reset_gathered`: calls
#: and the bytes of the whole weights
GATHERED = {"calls": 0, "bytes": 0}


def reset_gathered() -> None:
    GATHERED.update(calls=0, bytes=0)


class Axis(NamedTuple):
    """The active context's "tp" axis: its device count, this rank's
    index along it and the process group of its ranks."""
    n: int
    i: int
    group: object


def axis() -> Optional[Axis]:
    """The "tp" axis of the active serve context, or of a train context
    within its `act.seq_split`; None where it has one device (or outside
    both).  Raises without a process group of the mesh's size."""
    rules = act.current_rules()
    if rules is None or rules.axis_size("tp") <= 1:
        return None
    if not act.is_serve() and act.seq_shard() is None:
        return None
    g, members = comm.group(rules.mesh, rules.mesh_axes("tp"))
    return Axis(len(members), members.index(dist.get_rank()), g)


def training() -> bool:
    """Whether the "tp" axis is a train context's: whole weights, the
    stream on the rank's positions."""
    return not act.is_serve() and axis() is not None


def seq_gather(x: torch.Tensor, on: bool = True) -> torch.Tensor:
    """The whole sequence (dim 1) of the stream from every rank's
    positions, in training (`x` itself when `on` is False or elsewhere);
    its backward sums every rank's cotangent of the rank's positions."""
    sh = act.seq_shard()
    if sh is None or not on:
        return x
    return comm.all_gather_ad(x, 1, sh.group, sh.n)


def seq_take(y: torch.Tensor) -> torch.Tensor:
    """The rank's positions (dim 1) of a whole sequence, in training."""
    sh = act.seq_shard()
    if sh is None or y is None:
        return y
    lo, hi = sh.span(y.shape[1] // sh.n)
    return y[:, lo:hi]


def seq_whole(fn, x: torch.Tensor, x32: Optional[torch.Tensor] = None):
    """`fn(x, x32)` -> (y, cache, y32) of a block run on the whole
    sequence: in training the stream (and its unrounded value) is
    gathered, the block runs whole on every rank of "model", and each
    keeps its positions of y and y32 (the gradient of each rank's
    positions only, so the sum over "model" counts every position
    once)."""
    if act.seq_shard() is None:
        return fn(x, x32)
    xw, xw32 = seq_gather(x), None if x32 is None else seq_gather(x32)
    with act.seq_split(None, ()):           # the block itself splits nothing
        y, cache, y32 = fn(xw, xw32)
    return seq_take(y), cache, seq_take(y32)


def _rows(w: torch.Tensor, ax: Axis) -> torch.Tensor:
    """This rank's chunk of `w`'s input dim (its second last)."""
    k = w.shape[-2] // ax.n
    if k * ax.n != w.shape[-2]:
        raise ValueError(f"{w.shape[-2]} input features do not split into "
                         f"{ax.n} chunks")
    return w.narrow(-2, ax.i * k, k)


def size() -> int:
    """The "tp" axis's device count (1 without one)."""
    ax = axis()
    return 1 if ax is None else ax.n


def divides(dim: int) -> bool:
    """Whether a dim of `dim` features is split into chunks over "tp" (a
    serve axis of more than one device that divides it)."""
    n = size()
    return n > 1 and dim % n == 0


def _split(w) -> Optional[int]:
    """The dim along which `w` is this rank's slice (None: whole)."""
    pl = placement_of(w)
    if pl is None:
        return None
    dims = split_dims(pl)
    if not dims:
        return None
    if len(dims) > 1:
        raise NotImplementedError(f"a weight split on dims {dims}: a serve "
                                  f"placement splits one")
    return dims[0][0]


def _retag(t: torch.Tensor, src, spec) -> torch.Tensor:
    pl = placement_of(src)
    return with_placement(t, None if pl is None
                          else Placement(pl.mesh, tuple(spec(pl.spec))))


def index(w: torch.Tensor, i: int) -> torch.Tensor:
    """`w[i]`, keeping the placement of its other dims."""
    return _retag(w[i], w, lambda spec: spec[1:])


def transpose(w: torch.Tensor) -> torch.Tensor:
    """`w.T` of a 2-D weight, its placement transposed with it."""
    return _retag(w.T, w, lambda spec: spec[::-1])


def chunk(x: torch.Tensor, on: bool = True) -> torch.Tensor:
    """This rank's chunk of `x`'s last dim (`x` itself when `on` is False
    or there is no axis)."""
    ax = axis()
    if ax is None or not on:
        return x
    k = x.shape[-1] // ax.n
    if k * ax.n != x.shape[-1]:
        raise ValueError(f"{x.shape[-1]} features do not split into "
                         f"{ax.n} chunks")
    return x[..., ax.i * k:(ax.i + 1) * k]


def local(w: torch.Tensor, on: bool = True) -> torch.Tensor:
    """This rank's chunk of `w`'s last dim: `w` itself where its placement
    cut it so, else cut from the whole weight."""
    if _split(w) == w.dim() - 1:
        return w
    return chunk(whole(w), on)


def gather(x: torch.Tensor, ax: Optional[Axis] = None) -> torch.Tensor:
    """The whole last dim from every rank's chunk (an all-gather; its
    backward sums the ranks' cotangents of the rank's chunk)."""
    ax = ax or axis()
    return comm.all_gather_ad(x, x.dim() - 1, ax.group, ax.n)


def psum32(partial: torch.Tensor, dtype: torch.dtype,
           ax: Optional[Axis] = None) -> torch.Tensor:
    """The sum over "model" of float32 partial products, rounded once to
    `dtype`."""
    ax = ax or axis()
    return comm.all_reduce(partial.float(), ax.group).to(dtype)


def seq_scatter32(partial: torch.Tensor, dtype: torch.dtype
                  ) -> torch.Tensor:
    """In training, the rank's positions (dim 1) of the sum over "model"
    of float32 partial products of the whole sequence, rounded once to
    `dtype` (a reduce-scatter whose backward is the all-gather); in a
    serve context the whole sum (`psum32`)."""
    ax = axis()
    if act.is_serve():
        return psum32(partial, dtype, ax)
    return comm.reduce_scatter_ad(partial.float(), 1, ax.group,
                                  ax.n).to(dtype)


def whole(w: torch.Tensor) -> torch.Tensor:
    """`w` gathered whole (a collective, counted in `GATHERED`), or `w`
    itself when it is whole."""
    if _split(w) is None:
        return w
    out = gather_leaf(w)
    GATHERED["calls"] += 1
    GATHERED["bytes"] += out.numel() * out.element_size()
    return out


def gathered(p):
    """A block's parameters with every split one gathered whole at use
    (`p` itself when none is split)."""
    from repro_torch.models.model import ParamView
    tensors = p._parameters if hasattr(p, "_parameters") else p._tree
    if all(_split(t) is None for t in tensors.values()):
        return p
    return ParamView({k: whole(t) for k, t in tensors.items()})


def _cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`w` in `dtype` (itself when it already is: no op dispatched)."""
    return w if w.dtype == dtype else w.to(dtype)


def matmul(x: torch.Tensor, w: torch.Tensor, *, x_local: bool = False,
           local: bool = False, fn=torch.matmul) -> torch.Tensor:
    """`fn(x, w)` over the "model" group, `w` cast to x's dtype: x's last
    dim whole, or (`x_local`) this rank's chunk of it; returns the
    product's last dim whole, or (`local`) this rank's chunk.  `w`'s last
    two dims are its input and output dims (a leading dim is a batch of
    weights: experts, codebooks).  Without an axis: `fn(x, w)`.

    In training (`training()`, whole weights) the rank's chunk of the
    output is the product by the chunk of w's columns, of an input whole
    in its last dim and (the caller's `seq_gather`) in its sequence; a
    product from the rank's chunk of the input (`x_local` alone) is the
    float32 sum over "model" of the partial products by w's rows,
    reduce-scattered onto the rank's positions of the sequence (dim 1)
    and rounded once."""
    ax = axis()
    d = _split(w)
    if ax is None:
        if d is not None:
            raise RuntimeError(
                "a placed weight multiplies outside a serve context of its "
                "rules: run the model inside activation_sharding(rules, "
                "serve=True)")
        return fn(x, _cast(w, x.dtype))
    if d is None and not act.is_serve():
        if x_local and local:
            x = gather(x, ax)
        if local:
            return fn(x, _cast(chunk(w), x.dtype))
        if x_local:
            return seq_scatter32(fn(x.float(), _rows(w, ax).float()),
                                 x.dtype)
        return fn(x, _cast(w, x.dtype))
    if d is not None and d < w.dim() - 2:
        w, d = whole(w), None
    if d == w.dim() - 1:                        # output features split
        if x_local:
            x = gather(x, ax)
        y = fn(x, _cast(w, x.dtype))
        return y if local else gather(y, ax)
    if d == w.dim() - 2:                        # input features split
        if not x_local:
            x = chunk(x)
        y = psum32(fn(x.float(), w.float()), x.dtype, ax)
        return chunk(y) if local else y
    if x_local:                                 # whole weight
        x = gather(x, ax)
    y = fn(x, _cast(w, x.dtype))
    return chunk(y) if local else y


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` of a [V, D] table: split on V, each rank looks up its
    id range and the rows, zero elsewhere, are summed over "model"
    (exactly: one rank contributes each row); split on D, the columns
    are gathered."""
    d = _split(table)
    if d is None:
        return table[ids]
    ax = axis()
    if ax is None:
        raise RuntimeError("a placed embedding looks up outside a serve "
                           "context of its rules")
    if d == table.dim() - 1:
        return gather(table[ids], ax)
    v = table.shape[0]
    rel = ids.long() - ax.i * v
    mine = (rel >= 0) & (rel < v)
    rows = table[rel.clamp(0, v - 1)]
    rows = torch.where(mine[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return comm.all_reduce(rows.contiguous(), ax.group)
